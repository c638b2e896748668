// Hand-written Hopper (sm_90a) kernels for the implicit solvers.
//
// Two kernels, each a port of one Pallas TPU kernel of
// tpuwave/ops/pallas_kernels.py, templated on float and double:
//
//   B4  cheby_block     <- cheby_block_pallas (_cheby_block_kernel)
//   B5  recurrence_r0   <- recurrence_r0_pallas (_recurrence_r0_kernel)
//
// Same conventions as stencil_kernels.cu: a row-major (H, W) vertex grid
// at its true shape, the 3x3 stencil and every coefficient as run-time
// arguments, the Dirichlet mask in global coordinates (grid_common.cuh).
// Each kernel also returns squared norms, reduced deterministically in the
// tensor's dtype: one partial per block, then sum_partials_kernel.
//
// Plain C interface, bound from Python with ctypes (ops/kernels.py). Every
// entry point launches on the stream it is given, allocates nothing (the
// caller passes the partials buffer), does not synchronise, and returns
// cudaGetLastError() (0 = success).

#include "grid_common.cuh"

namespace {

// most coefficient pairs a block takes (degree <= kMaxCoeffs + 1)
constexpr int kMaxCoeffs = 31;

struct ChebyCoeffs {
  double c1[kMaxCoeffs];
  double c2[kMaxCoeffs];
};

// ---------------------------------------------------------------------------
// B4: one restarted Chebyshev block of degree 1 + n_coeffs on the
// constrained system (temporal blocking, the solver analogue of B2):
//
//   r <- masked(r);  d = r / theta;  x += d;  r = masked(r - S d)
//   for j: d = c1_j d + c2_j r;  x += d;  r = masked(r - S d)
//
// and ||r||^2 of the result. Each block owns a tile x tile square of output
// nodes. It loads r with a halo of `degree` nodes on every side into
// dynamic shared memory (zero outside the array and on pinned nodes) and
// runs the recurrence there: after step j, r is exact at distance >= j
// from the slab edge and d at distance >= j - 1, so after `degree` steps
// the centre tile is exact. Two __syncthreads() per step: r is updated in
// place from d's neighbours, then d in place from its own node. x is
// elementwise: only its centre tile is read, accumulated in shared memory
// and written. The slab holds r and d, (tile + 2 degree)^2 each, plus the
// tile of x; the wrapper picks the largest tile (64, 32, 16) that fits.
//
// Bound on this card: memory in the limit, 2 arrays read and 2 written
// (at 2049^2 f64: 134 MB, 40 us at 3.35 TB/s); the operations, ~24 per
// node per degree (9 multiply-adds of the stencil, the d and x updates),
// are 0.8 GFLOP at degree 8 there, 24 us at the 34 TFLOP/s f64 peak. The
// simple design reads every stencil operand from shared memory (9 loads
// per node and step) over a slab larger than the tile, so shared-memory
// traffic and the two barriers per step bound it, not device memory.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void cheby_block_kernel(const T* __restrict__ x,
                                   const T* __restrict__ r,
                                   T* __restrict__ out_x,
                                   T* __restrict__ out_r,
                                   T* __restrict__ partials, int H, int W,
                                   Stencil9 st, double inv_theta,
                                   ChebyCoeffs cf, int n_coeffs, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int deg = 1 + n_coeffs;
  const int S = tile + 2 * deg;  // slab side
  T* rs = reinterpret_cast<T*>(smem_raw);
  T* ds = rs + (size_t)S * S;
  T* xs = ds + (size_t)S * S;    // tile x tile
  const int r0 = blockIdx.y * tile - deg;  // array row of slab row 0
  const int c0 = blockIdx.x * tile - deg;  // array col of slab col 0
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bx = blockDim.x, by = blockDim.y;
  const T it = T(inv_theta);

  // r (masked) and d_1 = r / theta over the whole slab
  for (int sr = ty; sr < S; sr += by) {
    const int gr = r0 + sr;
    for (int sc = tx; sc < S; sc += bx) {
      const int gc = c0 + sc;
      const T v = is_pinned(gr, gc, H, W)
                      ? T(0) : __ldg(r + (size_t)gr * W + gc);
      rs[sr * S + sc] = v;
      ds[sr * S + sc] = it * v;
    }
  }
  __syncthreads();
  // x + d_1 on the centre tile (inside the array); the barrier at the end
  // of step 1's r update orders these writes before the first x += d
  for (int tr = ty; tr < tile; tr += by) {
    const int gr = blockIdx.y * tile + tr;
    for (int tc = tx; tc < tile; tc += bx) {
      const int gc = blockIdx.x * tile + tc;
      xs[tr * tile + tc] =
          (gr < H && gc < W)
              ? __ldg(x + (size_t)gr * W + gc) + ds[(tr + deg) * S + tc + deg]
              : T(0);
    }
  }

  T s[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) s[k] = T(st.c[k]);

  for (int j = 1; j <= deg; ++j) {
    const int hi = S - j;
    // r = masked(r - S d) at distance >= j
    for (int sr = j + ty; sr < hi; sr += by) {
      const int gr = r0 + sr;
      const T* dm = ds + (sr - 1) * S;
      const T* dc = ds + sr * S;
      const T* dp = ds + (sr + 1) * S;
      for (int sc = j + tx; sc < hi; sc += bx) {
        T v = T(0);
        if (!is_pinned(gr, c0 + sc, H, W)) {
          T sd = s[4] * dc[sc];
          sd += s[0] * dm[sc - 1];
          sd += s[1] * dm[sc];
          sd += s[2] * dm[sc + 1];
          sd += s[3] * dc[sc - 1];
          sd += s[5] * dc[sc + 1];
          sd += s[6] * dp[sc - 1];
          sd += s[7] * dp[sc];
          sd += s[8] * dp[sc + 1];
          v = rs[sr * S + sc] - sd;
        }
        rs[sr * S + sc] = v;
      }
    }
    __syncthreads();
    if (j == deg) break;
    // d = c1 d + c2 r at distance >= j; x += d on the centre tile
    const T c1 = T(cf.c1[j - 1]), c2 = T(cf.c2[j - 1]);
    for (int sr = j + ty; sr < hi; sr += by) {
      const int tr = sr - deg;
      for (int sc = j + tx; sc < hi; sc += bx) {
        const int i = sr * S + sc;
        const T d = c1 * ds[i] + c2 * rs[i];
        ds[i] = d;
        const int tc = sc - deg;
        if (tr >= 0 && tr < tile && tc >= 0 && tc < tile) {
          xs[tr * tile + tc] += d;
        }
      }
    }
    __syncthreads();
  }

  T part = T(0);
  for (int tr = ty; tr < tile; tr += by) {
    const int gr = blockIdx.y * tile + tr;
    if (gr >= H) continue;
    for (int tc = tx; tc < tile; tc += bx) {
      const int gc = blockIdx.x * tile + tc;
      if (gc >= W) continue;
      const size_t g = (size_t)gr * W + gc;
      const T rv = rs[(tr + deg) * S + tc + deg];
      out_x[g] = xs[tr * tile + tc];
      out_r[g] = rv;
      part += rv * rv;
    }
  }
  part = block_sum(part);
  if (tx == 0 && ty == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = part;
}

// ---------------------------------------------------------------------------
// B5: the fused setup of one displacement-recurrence (2-term) step,
//
//   x0 = 2 u - u_prev                          on interior nodes, 0 pinned
//   combo = c_u u + c_up u_prev                (pinned values zeroed only
//                                               when mask_combo)
//   r0 = sum_{d != 0} k_d (combo_{n+d} - combo_n)  on interior nodes,
//                                               0 pinned
//
// and ||r0||^2, ||x0||^2. The stencil is the zero-row-sum difference form
// of the -dt^2-scaled stiffness (tpuwave's _rolled_stencil_diff), summed in
// the plain version's order (dj, di = -1, 0, 1).
//
// Bound on this card: memory. It reads 2 arrays and writes 2 (16 B per node
// in f32, 32 B in f64: 134 MB at 2049^2 f64, 40 us at 3.35 TB/s) for ~30
// operations per node. One thread per node, 32x8 blocks, as B1 and B3: the
// 3x3 neighbourhood reads are coalesced along rows and served by L1/L2
// after the first touch; the combo is recomputed per neighbour rather than
// staged, which costs operations the card has to spare.
// ---------------------------------------------------------------------------
constexpr int kR0BlockX = 32, kR0BlockY = 8;

template <typename T>
__global__ void recurrence_r0_kernel(const T* __restrict__ u,
                                     const T* __restrict__ up,
                                     T* __restrict__ out_r0,
                                     T* __restrict__ out_x0,
                                     T* __restrict__ partials, int n_blocks,
                                     int H, int W, Stencil9 st, T c_u,
                                     T c_up, int mask_combo) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  T rv = T(0), xv = T(0);
  if (r < H && c < W) {
    const size_t i = (size_t)r * W + c;
    if (!is_pinned(r, c, H, W)) {
      // every neighbour of an interior node lies inside the grid
      T cb[9];
#pragma unroll
      for (int dj = -1; dj <= 1; ++dj) {
#pragma unroll
        for (int di = -1; di <= 1; ++di) {
          const size_t m = (size_t)(r + dj) * W + (c + di);
          T v = c_u * __ldg(u + m) + c_up * __ldg(up + m);
          if (mask_combo && is_pinned(r + dj, c + di, H, W)) v = T(0);
          cb[(dj + 1) * 3 + (di + 1)] = v;
        }
      }
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        if (k == 4) continue;
        acc += T(st.c[k]) * (cb[k] - cb[4]);
      }
      rv = acc;
      xv = T(2) * __ldg(u + i) - __ldg(up + i);
    }
    out_r0[i] = rv;
    out_x0[i] = xv;
  }
  const T pr = block_sum(rv * rv);
  const T px = block_sum(xv * xv);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    partials[b] = pr;
    partials[n_blocks + b] = px;
  }
}

template <typename T>
int launch_cheby(const void* x, const void* r, void* out_x, void* out_r,
                 void* partials, int n_partials, void* rr, int H, int W,
                 const double* s, double inv_theta, const double* c1,
                 const double* c2, int n_coeffs, int tile,
                 cudaStream_t stream) {
  if (n_coeffs < 0 || n_coeffs > kMaxCoeffs || tile <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(32, 16);
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile);
  const int n_blocks = (int)(grid.x * grid.y);
  if (n_partials < n_blocks) return (int)cudaErrorInvalidValue;
  ChebyCoeffs cf;
  for (int k = 0; k < kMaxCoeffs; ++k) {
    cf.c1[k] = k < n_coeffs ? c1[k] : 0.0;
    cf.c2[k] = k < n_coeffs ? c2[k] : 0.0;
  }
  const size_t side = (size_t)tile + 2 * (size_t)(1 + n_coeffs);
  const size_t smem = (2 * side * side + (size_t)tile * tile) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cheby_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cheby_block_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<T*>(out_x), static_cast<T*>(out_r),
      static_cast<T*>(partials), H, W, load_stencil(s), inv_theta, cf,
      n_coeffs, tile);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials_kernel<T><<<1, kSumThreads, 0, stream>>>(
      static_cast<const T*>(partials), n_blocks, static_cast<T*>(rr));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_recurrence_r0(const void* u, const void* up, void* out_r0,
                         void* out_x0, void* partials, int n_partials,
                         void* norms, int H, int W, const double* s,
                         double c_u, double c_up, int mask_combo,
                         cudaStream_t stream) {
  const dim3 block(kR0BlockX, kR0BlockY);
  const dim3 grid = point_grid(H, W, block);
  const int n_blocks = (int)(grid.x * grid.y);
  if (n_partials < 2 * n_blocks) return (int)cudaErrorInvalidValue;
  recurrence_r0_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(up),
      static_cast<T*>(out_r0), static_cast<T*>(out_x0),
      static_cast<T*>(partials), n_blocks, H, W, load_stencil(s), (T)c_u,
      (T)c_up, mask_combo);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials_kernel<T><<<2, kSumThreads, 0, stream>>>(
      static_cast<const T*>(partials), n_blocks, static_cast<T*>(norms));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. Pointers are device pointers except s
// (9 host doubles, the row-major 3x3 stencil) and c1 / c2 (n_coeffs host
// doubles each). `partials` holds n_partials values of the dtype; `rr`
// receives ||r_new||^2 (one value), `norms` ||r0||^2 then ||x0||^2.

int tw_cheby_block(int dtype, const void* x, const void* r, void* out_x,
                   void* out_r, void* partials, int n_partials, void* rr,
                   int H, int W, const double* s, double inv_theta,
                   const double* c1, const double* c2, int n_coeffs,
                   int tile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_cheby<float>(x, r, out_x, out_r, partials, n_partials, rr,
                               H, W, s, inv_theta, c1, c2, n_coeffs, tile,
                               st);
  }
  return launch_cheby<double>(x, r, out_x, out_r, partials, n_partials, rr,
                              H, W, s, inv_theta, c1, c2, n_coeffs, tile, st);
}

int tw_recurrence_r0(int dtype, const void* u, const void* up, void* out_r0,
                     void* out_x0, void* partials, int n_partials,
                     void* norms, int H, int W, const double* s, double c_u,
                     double c_up, int mask_combo, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_recurrence_r0<float>(u, up, out_r0, out_x0, partials,
                                       n_partials, norms, H, W, s, c_u, c_up,
                                       mask_combo, st);
  }
  return launch_recurrence_r0<double>(u, up, out_r0, out_x0, partials,
                                      n_partials, norms, H, W, s, c_u, c_up,
                                      mask_combo, st);
}

// Thread-block shape of B5 (the wrapper sizes its partials buffer from it).
int tw_recurrence_r0_block(int axis) {
  return axis == 0 ? kR0BlockX : kR0BlockY;
}

}  // extern "C"
