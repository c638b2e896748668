// Hand-written Hopper (sm_90a) kernels for the P2 (R = 2) canvas engine.
//
// Three kernels, each a port of one Pallas TPU kernel of
// tpuwave/ops/pallas_p2.py, templated on float and double:
//
//   B11  p2_constrained_apply  <- p2_constrained_apply_pallas (_p2_kernel)
//   B12  p2_presmooth          <- p2_presmooth_pallas
//   B13  p2_postsmooth         <- p2_postsmooth_pallas
//
// The P2 state is a stack of four canvases (4, Hc, Wc), plane order V, H, W,
// D (vertices, horizontal-, vertical- and diagonal-edge midpoints), each
// plane embedded at row 1, column 1 of its canvas: per-plane shapes
// (ny+1, nx+1), (ny+1, nx), (ny, nx+1), (ny, nx). The kernels take the
// canvases at their true shape (any Hc >= ny + 3, Wc >= nx + 3): no row
// block or lane multiple. The operator is a constant block-stencil, a list
// of terms (target plane, source plane, dx, dy, c) passed by value in the
// order of ops/stencil_p2.py::coeffs_to_static (sorted by target plane):
//
//   out_p(r, c) = sum_{terms of p} c * x_src(r + dy, c + dx)
//
// A canvas site of plane p is INTERIOR (a free DoF) when
//   row_lo(p) + 1 <= r <= ny  and  col_lo(p) + 1 <= c <= nx,
// row_lo = 1 for V and H (their top and bottom rows are Dirichlet), else 0;
// col_lo = 1 for V and W. This is tpuwave's _plane_interior_1d in global
// canvas coordinates. Every neighbour of an interior site lies inside the
// canvas.
//
// No kernel reduces, so reruns are bitwise equal.
//
// Plain C interface, bound from Python with ctypes (ops/kernels_p2.py).
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 = success).

#include <cuda_runtime.h>

namespace {

// most block-stencil terms a kernel takes (the P2 mass, stiffness and
// system stencils have 46 each); most smoothing coefficient pairs
constexpr int kMaxTerms = 64;
constexpr int kMaxPairs = 31;

struct P2Terms {
  double c[kMaxTerms];
  int src[kMaxTerms];  // source plane
  int dx[kMaxTerms];   // column offset
  int dy[kMaxTerms];   // row offset
  int start[5];        // terms of target plane p: start[p] .. start[p+1]-1
};

struct Plane4 {
  double v[4];
};

struct SmoothCoeffs {
  double c1[kMaxPairs + 1];
  double c2[kMaxPairs + 1];
};

__device__ __forceinline__ bool p2_interior(int p, long long r, long long c,
                                            int nx, int ny) {
  const int row_lo = (p == 0 || p == 1) ? 2 : 1;
  const int col_lo = (p == 0 || p == 2) ? 2 : 1;
  return r >= row_lo && r <= ny && c >= col_lo && c <= nx;
}

// ---------------------------------------------------------------------------
// B11: the constrained block-stencil apply, one pass over the four planes.
//
//   out_p = interior_p ? sum c * x_src(shifted, masked to the source's
//                        interior when mask_input) : diag_p * x_p
//
// With mask_input = 0 and zero diagonals it is where(interior, A x, 0), the
// rhs and boundary-lift form that must read the true driven boundary
// values. One thread per canvas site computes all four output planes and
// reads the 46 operands from global memory (L1 serves the neighbours after
// the first touch).
//
// Bound on this card: memory, one stack read and one written (8 canvases:
// 67.5 MB at Nel 1024 f64, 20 us at 3.35 TB/s); ~46 multiply-adds per site
// are 2-3x below that. The simple design reads each operand through L1
// (19 distinct (plane, offset) operands, 46 terms) rather than staging a
// tile in shared memory.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void p2_apply_kernel(const T* __restrict__ x, T* __restrict__ out,
                                int Hc, int Wc, int nx, int ny, P2Terms tm,
                                Plane4 diag, int mask_input) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= Hc || c >= Wc) return;
  const size_t plane = (size_t)Hc * Wc;
  const size_t i = (size_t)r * Wc + c;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    T v;
    if (p2_interior(p, r, c, nx, ny)) {
      T acc = T(0);
      for (int k = tm.start[p]; k < tm.start[p + 1]; ++k) {
        const int q = tm.src[k];
        const int rr = r + tm.dy[k], cc = c + tm.dx[k];
        T xv = __ldg(x + q * plane + (size_t)rr * Wc + cc);
        if (mask_input && !p2_interior(q, rr, cc, nx, ny)) xv = T(0);
        acc += T(tm.c[k]) * xv;
      }
      v = acc;
    } else {
      v = T(diag.v[p]) * x[p * plane + i];
    }
    out[p * plane + i] = v;
  }
}

// ---------------------------------------------------------------------------
// B12 / B13: the Jacobi-Chebyshev smoothing blocks of the (p+h)-multigrid
// V-cycle (tpuwave's _smooth_block_jacobi on the constrained canvas
// operator A_I = where(interior, A ., 0), inputs supported on the interior):
//
//   B12 (post = 0): r = b, x = 0;
//   B13 (post = 1): r = r_pre - A_I(corr_m), x = x_in + corr_m,
//                   corr_m = corr masked to the interior;
//   then for j = 0 .. n_upd - 1:
//       d = j == 0 ? c2_0 (inv_p r) : c1_j d + c2_j (inv_p r)
//       x += d;  r -= A_I(d)
//   (c2_0 = 1 / theta; the pairs of j >= 1 come from the Chebyshev
//   schedule). B12 writes (x, r); B13 writes x and skips the last r update,
//   which nothing reads.
//
// Each block owns a tile x tile square of canvas sites of all four planes.
// It loads its inputs with a halo of n_upd sites on every side into dynamic
// shared memory (zero outside the canvas) and runs the chain there: after
// the k-th apply, r is exact at distance >= k from the slab edge, and d
// after its update at distance >= the number of applies before it, so the
// centre tile is exact at the end. Both kernels chain n_upd applies
// (degree 4: 4 applies, halo 4). The slab holds r and d of the four planes,
// (tile + 2 n_upd)^2 each, and the centre tile of x; the wrapper picks the
// largest tile (64, 32, 16) that fits the card's opt-in limit. A barrier
// after the loads (the x tile is written by other threads than those that
// add d into it), then two per step: d (and x) in place, then r from d's
// neighbours.
//
// Bound on this card: memory in the limit (B12 reads 1 stack and writes 2,
// B13 reads 3 and writes 1: 101 MB and 135 MB at Nel 1024 f64), against
// ~46 multiply-adds per site and apply. The simple design reads every
// stencil operand from shared memory over a slab larger than the tile, so
// shared-memory traffic and the barriers bound it, not device memory.
// ---------------------------------------------------------------------------
// r -= A_I(d) over slab sites at distance >= lo from the slab edge; the
// terms are staged in shared memory (coefficient and slab offset each).
template <typename T>
__device__ __forceinline__ void p2_apply_slab(T* rs, const T* ds, int S,
                                              int lo, int r0, int c0, int nx,
                                              int ny, const T* tc,
                                              const int* toff,
                                              const int* tstart) {
  const int SS = S * S;
  const int hi = S - lo;
  for (int sr = lo + threadIdx.y; sr < hi; sr += blockDim.y) {
    for (int sc = lo + threadIdx.x; sc < hi; sc += blockDim.x) {
      const int s = sr * S + sc;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (!p2_interior(p, r0 + sr, c0 + sc, nx, ny)) continue;
        T acc = T(0);
        for (int k = tstart[p]; k < tstart[p + 1]; ++k) {
          acc += tc[k] * ds[s + toff[k]];
        }
        rs[p * SS + s] -= acc;
      }
    }
  }
}

template <typename T>
__global__ void p2_smooth_kernel(const T* __restrict__ rin,
                                 const T* __restrict__ xin,
                                 const T* __restrict__ corr,
                                 T* __restrict__ out_x, T* __restrict__ out_r,
                                 int Hc, int Wc, int nx, int ny, P2Terms tm,
                                 Plane4 inv, SmoothCoeffs cf, int n_upd,
                                 int post, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int halo = n_upd;
  const int S = tile + 2 * halo;
  const int SS = S * S;
  T* rs = reinterpret_cast<T*>(smem_raw);  // 4 planes x S x S
  T* ds = rs + 4 * (size_t)SS;             // 4 planes x S x S
  T* xs = ds + 4 * (size_t)SS;             // 4 planes x tile x tile
  T* tc = xs + 4 * (size_t)tile * tile;    // kMaxTerms coefficients
  int* toff = reinterpret_cast<int*>(tc + kMaxTerms);  // slab offsets
  int* tstart = toff + kMaxTerms;                      // 5 plane starts
  const int r0 = blockIdx.y * tile - halo;  // canvas row of slab row 0
  const int c0 = blockIdx.x * tile - halo;  // canvas col of slab col 0
  const size_t plane = (size_t)Hc * Wc;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;

  if (tid < kMaxTerms) {
    tc[tid] = T(tm.c[tid]);
    toff[tid] = tm.src[tid] * SS + tm.dy[tid] * S + tm.dx[tid];
  }
  if (tid < 5) tstart[tid] = tm.start[tid];
  for (int sr = threadIdx.y; sr < S; sr += blockDim.y) {
    const int gr = r0 + sr;
    for (int sc = threadIdx.x; sc < S; sc += blockDim.x) {
      const int gc = c0 + sc;
      const bool in = gr >= 0 && gr < Hc && gc >= 0 && gc < Wc;
      const size_t g = (size_t)gr * Wc + gc;
      const int s = sr * S + sc;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        rs[p * SS + s] = in ? __ldg(rin + p * plane + g) : T(0);
        ds[p * SS + s] = (post && in && p2_interior(p, gr, gc, nx, ny))
                             ? __ldg(corr + p * plane + g) : T(0);
      }
    }
  }
  __syncthreads();
  for (int tr = threadIdx.y; tr < tile; tr += blockDim.y) {
    const int gr = blockIdx.y * tile + tr;
    for (int tcol = threadIdx.x; tcol < tile; tcol += blockDim.x) {
      const int gc = blockIdx.x * tile + tcol;
      const bool in = gr < Hc && gc < Wc;
      const int s = (tr + halo) * S + tcol + halo;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        T v = T(0);
        if (post && in) {
          v = __ldg(xin + p * plane + (size_t)gr * Wc + gc) + ds[p * SS + s];
        }
        xs[p * tile * tile + tr * tile + tcol] = v;
      }
    }
  }
  // the d loop below adds into x tile sites that other threads wrote here
  __syncthreads();

  int lvl = 0;
  if (post) {
    p2_apply_slab(rs, ds, S, 1, r0, c0, nx, ny, tc, toff, tstart);
    lvl = 1;
    __syncthreads();
  }
  for (int j = 0; j < n_upd; ++j) {
    const T c1 = T(cf.c1[j]), c2 = T(cf.c2[j]);
    const int hi = S - lvl;
    for (int sr = lvl + threadIdx.y; sr < hi; sr += blockDim.y) {
      const int tr = sr - halo;
      for (int sc = lvl + threadIdx.x; sc < hi; sc += blockDim.x) {
        const int tcol = sc - halo;
        const bool centre =
            tr >= 0 && tr < tile && tcol >= 0 && tcol < tile;
        const int s = sr * S + sc;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const T z = T(inv.v[p]) * rs[p * SS + s];
          const T d = j == 0 ? c2 * z : c1 * ds[p * SS + s] + c2 * z;
          ds[p * SS + s] = d;
          if (centre) xs[p * tile * tile + tr * tile + tcol] += d;
        }
      }
    }
    __syncthreads();
    if (post && j == n_upd - 1) break;
    p2_apply_slab(rs, ds, S, lvl + 1, r0, c0, nx, ny, tc, toff, tstart);
    __syncthreads();
    ++lvl;
  }

  for (int tr = threadIdx.y; tr < tile; tr += blockDim.y) {
    const int gr = blockIdx.y * tile + tr;
    if (gr >= Hc) continue;
    for (int tcol = threadIdx.x; tcol < tile; tcol += blockDim.x) {
      const int gc = blockIdx.x * tile + tcol;
      if (gc >= Wc) continue;
      const size_t g = (size_t)gr * Wc + gc;
      const int s = (tr + halo) * S + tcol + halo;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        out_x[p * plane + g] = xs[p * tile * tile + tr * tile + tcol];
        if (!post) out_r[p * plane + g] = rs[p * SS + s];
      }
    }
  }
}

// Terms from host arrays; 0 when they are valid (at most kMaxTerms, sorted
// by target plane, planes in 0..3, offsets in -1..1).
int load_terms(const int* tgt, const int* src, const int* dx, const int* dy,
               const double* c, int n_terms, P2Terms* tm) {
  if (n_terms < 0 || n_terms > kMaxTerms) return 1;
  for (int p = 0; p <= 4; ++p) tm->start[p] = n_terms;
  for (int k = n_terms - 1; k >= 0; --k) {
    if (tgt[k] < 0 || tgt[k] > 3 || src[k] < 0 || src[k] > 3) return 1;
    if (dx[k] < -1 || dx[k] > 1 || dy[k] < -1 || dy[k] > 1) return 1;
    if (k + 1 < n_terms && tgt[k] > tgt[k + 1]) return 1;
    tm->start[tgt[k]] = k;
  }
  for (int p = 3; p >= 0; --p) {
    if (tm->start[p] > tm->start[p + 1]) tm->start[p] = tm->start[p + 1];
  }
  for (int k = 0; k < kMaxTerms; ++k) {
    const bool on = k < n_terms;
    tm->c[k] = on ? c[k] : 0.0;
    tm->src[k] = on ? src[k] : 0;
    tm->dx[k] = on ? dx[k] : 0;
    tm->dy[k] = on ? dy[k] : 0;
  }
  return 0;
}

// dynamic shared memory of p2_smooth_kernel: r and d slabs and the x tile
// of the four planes, then the staged terms
size_t smooth_smem_bytes(int tile, int n_upd, size_t itemsize) {
  const size_t side = (size_t)tile + 2 * (size_t)n_upd;
  return 4 * (2 * side * side + (size_t)tile * tile) * itemsize +
         kMaxTerms * (itemsize + sizeof(int)) + 8 * sizeof(int);
}

Plane4 load4(const double* v) {
  Plane4 out;
  for (int p = 0; p < 4; ++p) out.v[p] = v[p];
  return out;
}

template <typename T>
int launch_apply(const void* x, void* out, int Hc, int Wc, int nx, int ny,
                 const P2Terms& tm, const double* diag, int mask_input,
                 cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((Wc + block.x - 1) / block.x, (Hc + block.y - 1) / block.y);
  p2_apply_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), Hc, Wc, nx, ny, tm,
      load4(diag), mask_input);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_smooth(const void* rin, const void* xin, const void* corr,
                  void* out_x, void* out_r, int Hc, int Wc, int nx, int ny,
                  const P2Terms& tm, const double* inv_diag,
                  double inv_theta, const double* c1, const double* c2,
                  int n_pairs, int post, int tile, cudaStream_t stream) {
  if (n_pairs < 0 || n_pairs > kMaxPairs || tile <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  SmoothCoeffs cf;
  for (int k = 0; k <= kMaxPairs; ++k) {
    cf.c1[k] = (k >= 1 && k <= n_pairs) ? c1[k - 1] : 0.0;
    cf.c2[k] = k == 0 ? inv_theta : (k <= n_pairs ? c2[k - 1] : 0.0);
  }
  const int n_upd = 1 + n_pairs;
  const size_t smem = smooth_smem_bytes(tile, n_upd, sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        p2_smooth_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(32, 16);
  const dim3 grid((Wc + tile - 1) / tile, (Hc + tile - 1) / tile);
  p2_smooth_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(rin), static_cast<const T*>(xin),
      static_cast<const T*>(corr), static_cast<T*>(out_x),
      static_cast<T*>(out_r), Hc, Wc, nx, ny, tm, load4(inv_diag), cf, n_upd,
      post, tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. Pointers are device pointers except the
// term arrays (n_terms host values each: target plane, source plane, dx,
// dy, coefficient), the four host doubles of diag / inv_diag, and c1 / c2
// (n_pairs host doubles each). Canvases are (4, Hc, Wc), contiguous.

int tw_p2_apply(int dtype, const void* x, void* out, int Hc, int Wc, int nx,
                int ny, const int* tgt, const int* src, const int* dx,
                const int* dy, const double* c, int n_terms,
                const double* diag, int mask_input, void* stream) {
  P2Terms tm;
  if (load_terms(tgt, src, dx, dy, c, n_terms, &tm)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_apply<float>(x, out, Hc, Wc, nx, ny, tm, diag, mask_input,
                               st);
  }
  return launch_apply<double>(x, out, Hc, Wc, nx, ny, tm, diag, mask_input,
                              st);
}

// post = 0: B12, rin = b, out (x, r); xin and corr unused (may be null).
// post = 1: B13, rin = r_pre, xin = x, corr; out x; out_r unused.
int tw_p2_smooth(int dtype, int post, const void* rin, const void* xin,
                 const void* corr, void* out_x, void* out_r, int Hc, int Wc,
                 int nx, int ny, const int* tgt, const int* src,
                 const int* dx, const int* dy, const double* c, int n_terms,
                 const double* inv_diag, double inv_theta, const double* c1,
                 const double* c2, int n_pairs, int tile, void* stream) {
  P2Terms tm;
  if (load_terms(tgt, src, dx, dy, c, n_terms, &tm)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_smooth<float>(rin, xin, corr, out_x, out_r, Hc, Wc, nx, ny,
                                tm, inv_diag, inv_theta, c1, c2, n_pairs,
                                post, tile, st);
  }
  return launch_smooth<double>(rin, xin, corr, out_x, out_r, Hc, Wc, nx, ny,
                               tm, inv_diag, inv_theta, c1, c2, n_pairs,
                               post, tile, st);
}

}  // extern "C"
