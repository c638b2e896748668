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
// tensor's dtype: one partial per block and norm, then the last block to
// finish sums the partials in the same launch (finish_norms).
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
// and ||r||^2 of the result, in the same launch. x may be null: a zero
// initial guess, not read. After step j, r is exact at distance >= j from
// the edge of a block's slab and d at distance >= j - 1, so a slab of the
// tile plus a `degree` halo makes the tile exact.
//
// Bound on this card: memory, 2 arrays read and 2 written (1 and 2 with a
// zero guess; at 2049^2 f64: 134 MB, 40 us at 3.35 TB/s); the operations,
// ~22 per node per degree, are 0.8 GFLOP at degree 8 there, 24 us at the
// 34 TFLOP/s f64 peak.
//
// Only d is read at neighbours. A thread owns R consecutive slab rows of
// one column of a 64-column slab and keeps r, its own d and x in registers
// for all the steps; shared memory holds d alone, double buffered (one
// barrier per step), read through a sliding 3-row register window (three
// shared loads per node and step). Slabs of 64 x 64 nodes, or 64 x 32 in
// f64 up to degree 2 (ChebyGeometry). Pinned nodes lie on the walls only: a block whose slab
// touches no wall and no array edge runs the recurrence with no mask test,
// the others mask r with a per-node pin bit set at staging (a pinned node
// stages r = d = 0, so d stays 0 there). Degrees above kChebyRegMaxDegree
// take cheby_block_smem_kernel below, whose slabs in shared memory hold any
// degree. (The first version ran every degree on that kernel: r and d over
// the slab in shared memory, nine shared loads per node and step, two
// barriers per step, and a second launch to sum the norm's partials.)
//
// The norm: each block reduces its tile's r^2 in a fixed order into one
// partial; the last block to finish (an integer ticket taken after a
// __threadfence) sums the partials in block order and resets the ticket to
// 0 for the next call. No float atomics: reruns are bitwise equal.
// ---------------------------------------------------------------------------
constexpr int kChebyX = 64;
constexpr int kChebySmallDegree = 2, kChebyRegMaxDegree = 16;

// Threads in y (TY) and rows per thread (R) of the register kernel, up to
// degree kChebySmallDegree and above it: slabs of 64 x TY R nodes. Each is
// the fastest of the shapes timed at the main paths' sizes (degree 1 at
// 4097^2 f32, degree 2 at 2049^2 and 641^2 f64, degree 8 at 2049^2 f64 and
// 4097^2 f32).
template <typename T>
struct ChebyGeometry;
template <>
struct ChebyGeometry<float> {
  static constexpr int kSmallTY = 8, kSmallR = 8, kLargeTY = 8, kLargeR = 8;
};
template <>
struct ChebyGeometry<double> {
  static constexpr int kSmallTY = 8, kSmallR = 4, kLargeTY = 4, kLargeR = 16;
};

template <int TY, int R>
constexpr size_t cheby_reg_smem_elems() {
  return 2 * ((size_t)kChebyX * TY * R + 2 * (kChebyX + 1));
}

template <typename T, int TY, int R, bool WALLS>
__device__ __forceinline__ void cheby_reg_walk(
    const T* __restrict__ x, const T* __restrict__ r, T* __restrict__ out_x,
    T* __restrict__ out_r, T* __restrict__ ds, int H, int W, int r0, int c0,
    int deg, int tile_y, int tile_x, const Stencil9& st9, double inv_theta,
    const ChebyCoeffs& cf, T* __restrict__ partials,
    unsigned* __restrict__ ticket, T* __restrict__ rr) {
  constexpr int SX = kChebyX;
  constexpr int kPad = SX + 1;
  constexpr int SB = SX * TY * R + 2 * kPad;
  const int sc = threadIdx.x, sr0 = threadIdx.y * R;
  const int gc = c0 + sc;
  const int base = kPad + sr0 * SX + sc;
  const bool col_tile = sc >= deg && sc < deg + tile_x && gc < W;
  const T it = T(inv_theta);
  T rv[R], dv[R], xv[R];
  unsigned pin_bits = 0, tile_bits = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int sr = sr0 + i, gr = r0 + sr;
    const bool pin = WALLS && is_pinned(gr, gc, H, W);
    const bool t = col_tile && sr >= deg && sr < deg + tile_y &&
                   (!WALLS || gr < H);
    const bool in = !WALLS || (gr >= 0 && gr < H && gc >= 0 && gc < W);
    const size_t g = in ? (size_t)gr * W + gc : 0;
    rv[i] = pin ? T(0) : __ldg(r + g);
    xv[i] = (x != nullptr && t) ? __ldg(x + g) : T(0);
    pin_bits |= (unsigned)pin << i;
    tile_bits |= (unsigned)t << i;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    dv[i] = it * rv[i];
    xv[i] += dv[i];
    ds[base + i * SX] = dv[i];
  }
  __syncthreads();
  const StencilT<T> st(st9);
  for (int j = 1; j <= deg; ++j) {
    const T* __restrict__ cur = ds + ((j - 1) & 1) * SB;
    T* nxt = ds + (j & 1) * SB;
    const bool more = j < deg;
    const T c1 = more ? T(cf.c1[j - 1]) : T(0);
    const T c2 = more ? T(cf.c2[j - 1]) : T(0);
    Window<T, SX> w;
    w.start(cur, base);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int q = base + i * SX;
      w.next_row(cur, q);
      T v = rv[i] - w.apply(st);
      if (WALLS) v = ((pin_bits >> i) & 1u) ? T(0) : v;
      rv[i] = v;
      if (more) {
        dv[i] = c1 * dv[i] + c2 * v;
        xv[i] += dv[i];
        nxt[q] = dv[i];
      }
      w.advance();
    }
    if (more) __syncthreads();
  }
  T part = T(0);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if ((tile_bits >> i) & 1u) {
      const size_t g = (size_t)(r0 + sr0 + i) * W + gc;
      out_x[g] = xv[i];
      out_r[g] = rv[i];
      part += rv[i] * rv[i];
    }
  }
  finish_norms<T, 1>({part}, partials, ticket, rr);
}

template <typename T, int TY, int R>
__global__ void __launch_bounds__(kChebyX * TY)
cheby_block_reg_kernel(const T* __restrict__ x, const T* __restrict__ r,
                       T* __restrict__ out_x, T* __restrict__ out_r,
                       T* __restrict__ partials, unsigned* __restrict__ ticket,
                       T* __restrict__ rr, int H, int W, Stencil9 st,
                       double inv_theta, ChebyCoeffs cf, int n_coeffs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ds = reinterpret_cast<T*>(smem_raw);
  constexpr int SX = kChebyX, SY = TY * R;
  constexpr int kPad = SX + 1;
  constexpr int SB = SX * SY + 2 * kPad;
  const int deg = 1 + n_coeffs;
  const int tile_y = SY - 2 * deg, tile_x = SX - 2 * deg;
  const int r0 = blockIdx.y * tile_y - deg;  // array row of slab row 0
  const int c0 = blockIdx.x * tile_x - deg;  // array col of slab col 0
  const int tid = threadIdx.y * SX + threadIdx.x;
  for (int q = tid; q < 2 * kPad; q += SX * TY) {
    // the spare values (read only by nodes whose result is never used)
    T* b = ds + (q / kPad) * SB;
    const int j = q % kPad;
    b[j] = T(0);
    b[SB - 1 - j] = T(0);
  }
  // the slab touches a wall, or reaches past the array
  const bool walls = r0 <= 0 || c0 <= 0 || r0 + SY - 1 >= H - 1 ||
                     c0 + SX - 1 >= W - 1;
  if (walls) {
    cheby_reg_walk<T, TY, R, true>(x, r, out_x, out_r, ds, H, W, r0, c0, deg,
                               tile_y, tile_x, st, inv_theta, cf, partials,
                               ticket, rr);
  } else {
    cheby_reg_walk<T, TY, R, false>(x, r, out_x, out_r, ds, H, W, r0, c0, deg,
                                tile_y, tile_x, st, inv_theta, cf, partials,
                                ticket, rr);
  }
}

// Degrees above kChebyRegMaxDegree: each block loads r with a halo of
// `degree` nodes into dynamic shared memory (zero outside the array and on
// pinned nodes) and runs the recurrence there, two barriers per step: r is
// updated in place from d's neighbours, then d in place from its own node.
// x is elementwise: only its centre tile is read, accumulated in shared
// memory and written. The slab holds r and d, (tile + 2 degree)^2 each,
// plus the tile of x; the wrapper picks the largest tile (64, 32, 16) that
// fits.
template <typename T>
__global__ void cheby_block_smem_kernel(const T* __restrict__ x,
                                        const T* __restrict__ r,
                                        T* __restrict__ out_x,
                                        T* __restrict__ out_r,
                                        T* __restrict__ partials,
                                        unsigned* __restrict__ ticket,
                                        T* __restrict__ rr, int H, int W,
                                        Stencil9 st, double inv_theta,
                                        ChebyCoeffs cf, int n_coeffs,
                                        int tile) {
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
      const T d = ds[(tr + deg) * S + tc + deg];
      xs[tr * tile + tc] =
          (gr < H && gc < W)
              ? (x != nullptr ? __ldg(x + (size_t)gr * W + gc) + d : d)
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
  finish_norms<T, 1>({part}, partials, ticket, rr);
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
// the plain version's order (dj, di = -1, 0, 1; Window::apply_diff).
//
// Bound on this card: memory. It reads 2 arrays and writes 2 (16 B per node
// in f32, 32 B in f64: 134 MB at 2049^2 f64, 40 us at 3.35 TB/s) for ~33
// operations per node.
//
// B3's tiles: each block owns a 64 x (4 R) tile of outputs and stages the
// combo and 2 u - u_prev over the tile plus a one-node halo in shared
// memory, each computed once per node from one load of u and u_prev (a
// thread starts all its staging loads before it stores the first). With
// mask_combo a pinned node stages 0; without it the raw combo (every
// neighbour of an interior node lies inside the grid, so a halo node
// outside the array, staged 0, is never read by an output). Each thread
// then walks down one column of the tile with the 3-row register window;
// only a block whose tile touches a wall tests for pinned outputs. R = 8:
// at each of the main paths' sizes (641^2 and 2049^2 f64, 4097^2 f32) it
// beat B3's R = 2 for small grids (PERF.md). The norms come in the same
// launch: each block reduces its tile's r0^2 and x0^2 in a
// fixed order into two partials, and the last block to finish (an integer
// ticket taken after a __threadfence, finish_norms) sums them in block
// order; no float atomics, so reruns are bitwise equal. (The first version
// ran one thread per node with 18 __ldg loads and nine four-compare mask
// tests, and a second launch to sum the partials: 27-40% of the bound.)
// ---------------------------------------------------------------------------
constexpr int kR0TileX = 64, kR0ThreadsY = 4;
constexpr int kR0SlabX = kR0TileX + 2;
constexpr int kR0Threads = kR0TileX * kR0ThreadsY;
constexpr int kR0Rows = 8;  // the rows a thread walks
constexpr int kR0TileY = kR0ThreadsY * kR0Rows;

dim3 recurrence_r0_grid(int H, int W) {
  return dim3((W + kR0TileX - 1) / kR0TileX, (H + kR0TileY - 1) / kR0TileY);
}

template <typename T, bool WALLS>
__device__ __forceinline__ void recurrence_r0_walk(
    const T* __restrict__ cs, const T* __restrict__ xs,
    T* __restrict__ out_r0, T* __restrict__ out_x0, int H, int W, int r0,
    int c0, const StencilT<T>& st, T& rr, T& xx) {
  const int gc = c0 + 1 + threadIdx.x;
  const bool col_wall = gc == 0 || gc == W - 1;
  int gr = r0 + 1 + threadIdx.y * kR0Rows;
  int i = (threadIdx.y * kR0Rows + 1) * kR0SlabX + threadIdx.x + 1;
  Window<T, kR0SlabX> w;
  w.start(cs, i);
#pragma unroll
  for (int j = 0; j < kR0Rows; ++j, ++gr, i += kR0SlabX) {
    if (gr >= H) break;
    w.next_row(cs, i);
    const size_t g = (size_t)gr * W + gc;
    T rv = T(0), xv = T(0);
    if (!WALLS || !(col_wall || gr == 0 || gr == H - 1)) {
      rv = w.apply_diff(st);
      xv = xs[i];
    }
    out_r0[g] = rv;
    out_x0[g] = xv;
    rr += rv * rv;
    xx += xv * xv;
    w.advance();
  }
}

template <typename T, bool MASK>
__global__ void __launch_bounds__(kR0Threads)
recurrence_r0_kernel(const T* __restrict__ u, const T* __restrict__ up,
                     T* __restrict__ out_r0, T* __restrict__ out_x0,
                     T* __restrict__ partials, unsigned* __restrict__ ticket,
                     T* __restrict__ norms, int H, int W, Stencil9 st9,
                     T c_u, T c_up) {
  constexpr int kSlab = kR0SlabX * (kR0TileY + 2);
  constexpr int kStage = (kSlab + kR0Threads - 1) / kR0Threads;
  __shared__ T cs[kSlab];  // the combo
  __shared__ T xs[kSlab];  // 2 u - u_prev
  const int r0 = blockIdx.y * kR0TileY - 1;  // array row of slab row 0
  const int c0 = blockIdx.x * kR0TileX - 1;
  const int tid = threadIdx.y * kR0TileX + threadIdx.x;
  T vu[kStage], vp[kStage];
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const size_t g = slab_node<kR0SlabX, kSlab>(tid + k * kR0Threads, r0,
                                                c0, H, W, MASK);
    vu[k] = g != kNoNode ? __ldg(u + g) : T(0);
    vp[k] = g != kNoNode ? __ldg(up + g) : T(0);
  }
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int i = tid + k * kR0Threads;
    if (i < kSlab) {
      cs[i] = c_u * vu[k] + c_up * vp[k];
      xs[i] = T(2) * vu[k] - vp[k];
    }
  }
  __syncthreads();
  T rr = T(0), xx = T(0);
  if (c0 + 1 + (int)threadIdx.x < W) {
    const StencilT<T> st(st9);
    // the tile's rows r0 + 1 .. r0 + kR0TileY and columns c0 + 1 ..
    // c0 + kR0TileX touch a wall
    const bool walls = r0 < 0 || c0 < 0 || r0 + kR0TileY >= H - 1 ||
                       c0 + kR0TileX >= W - 1;
    if (walls) {
      recurrence_r0_walk<T, true>(cs, xs, out_r0, out_x0, H, W, r0, c0, st,
                                  rr, xx);
    } else {
      recurrence_r0_walk<T, false>(cs, xs, out_r0, out_x0, H, W, r0, c0, st,
                                   rr, xx);
    }
  }
  finish_norms<T, 2>({rr, xx}, partials, ticket, norms);
}

template <typename K>
int opt_in_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int TY, int R>
int launch_cheby_reg(const T* x, const T* r, T* out_x, T* out_r, T* partials,
                     int n_partials, unsigned* ticket, T* rr, int H, int W,
                     const Stencil9& st, double inv_theta,
                     const ChebyCoeffs& cf, int n_coeffs, int tile_rows,
                     int tile_cols, cudaStream_t stream) {
  const int deg = 1 + n_coeffs;
  if (tile_rows != TY * R - 2 * deg || tile_cols != kChebyX - 2 * deg) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((W + tile_cols - 1) / tile_cols,
                  (H + tile_rows - 1) / tile_rows);
  if (n_partials < (int)(grid.x * grid.y)) return (int)cudaErrorInvalidValue;
  const size_t smem = cheby_reg_smem_elems<TY, R>() * sizeof(T);
  const int e = opt_in_smem(cheby_block_reg_kernel<T, TY, R>, smem);
  if (e != 0) return e;
  cheby_block_reg_kernel<T, TY, R><<<grid, dim3(kChebyX, TY), smem, stream>>>(
      x, r, out_x, out_r, partials, ticket, rr, H, W, st, inv_theta, cf,
      n_coeffs);
  return (int)cudaGetLastError();
}

// tile_rows x tile_cols: the tile the wrapper chose (ops/kernels.py
// cheby_tile); refused unless it is the one the degree's kernel takes
template <typename T>
int launch_cheby(const void* x, const void* r, void* out_x, void* out_r,
                 void* partials, int n_partials, void* ticket, void* rr,
                 int H, int W, const double* s, double inv_theta,
                 const double* c1, const double* c2, int n_coeffs,
                 int tile_rows, int tile_cols, cudaStream_t stream) {
  if (n_coeffs < 0 || n_coeffs > kMaxCoeffs || tile_rows <= 0 ||
      tile_cols <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  ChebyCoeffs cf;
  for (int k = 0; k < kMaxCoeffs; ++k) {
    cf.c1[k] = k < n_coeffs ? c1[k] : 0.0;
    cf.c2[k] = k < n_coeffs ? c2[k] : 0.0;
  }
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  T* ox = static_cast<T*>(out_x);
  T* orr = static_cast<T*>(out_r);
  T* pt = static_cast<T*>(partials);
  unsigned* tk = static_cast<unsigned*>(ticket);
  T* rrt = static_cast<T*>(rr);
  const Stencil9 st = load_stencil(s);
  const int deg = 1 + n_coeffs;
  using G = ChebyGeometry<T>;
  if (deg <= kChebySmallDegree) {
    return launch_cheby_reg<T, G::kSmallTY, G::kSmallR>(
        xt, rt, ox, orr, pt, n_partials, tk, rrt, H, W, st, inv_theta, cf,
        n_coeffs, tile_rows, tile_cols, stream);
  }
  if (deg <= kChebyRegMaxDegree) {
    return launch_cheby_reg<T, G::kLargeTY, G::kLargeR>(
        xt, rt, ox, orr, pt, n_partials, tk, rrt, H, W, st, inv_theta, cf,
        n_coeffs, tile_rows, tile_cols, stream);
  }
  const int tile = tile_rows;
  if (tile_cols != tile) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile);
  if (n_partials < (int)(grid.x * grid.y)) return (int)cudaErrorInvalidValue;
  const size_t side = (size_t)tile + 2 * (size_t)deg;
  const size_t smem = (2 * side * side + (size_t)tile * tile) * sizeof(T);
  const int e = opt_in_smem(cheby_block_smem_kernel<T>, smem);
  if (e != 0) return e;
  cheby_block_smem_kernel<T><<<grid, dim3(32, 16), smem, stream>>>(
      xt, rt, ox, orr, pt, tk, rrt, H, W, st, inv_theta, cf, n_coeffs, tile);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_recurrence_r0(const void* u, const void* up, void* out_r0,
                         void* out_x0, void* partials, int n_partials,
                         void* ticket, void* norms, int H, int W,
                         const double* s, double c_u, double c_up,
                         int mask_combo, cudaStream_t stream) {
  const dim3 grid = recurrence_r0_grid(H, W);
  if (n_partials < 2 * (int)(grid.x * grid.y)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kR0TileX, kR0ThreadsY);
  auto kernel = mask_combo ? recurrence_r0_kernel<T, true>
                           : recurrence_r0_kernel<T, false>;
  kernel<<<grid, block, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(up),
      static_cast<T*>(out_r0), static_cast<T*>(out_x0),
      static_cast<T*>(partials), static_cast<unsigned*>(ticket),
      static_cast<T*>(norms), H, W, load_stencil(s), (T)c_u, (T)c_up);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. Pointers are device pointers except s
// (9 host doubles, the row-major 3x3 stencil) and c1 / c2 (n_coeffs host
// doubles each). `partials` holds n_partials values of the dtype; `rr`
// receives ||r_new||^2 (one value), `norms` ||r0||^2 then ||x0||^2.
// B4: x null = a zero initial guess. `ticket` (B4, B5) is one unsigned
// int that is 0 before the call and 0 again after it.

int tw_cheby_block(int dtype, const void* x, const void* r, void* out_x,
                   void* out_r, void* partials, int n_partials, void* ticket,
                   void* rr, int H, int W, const double* s, double inv_theta,
                   const double* c1, const double* c2, int n_coeffs,
                   int tile_rows, int tile_cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = dtype == 0 ? launch_cheby<float> : launch_cheby<double>;
  return launch(x, r, out_x, out_r, partials, n_partials, ticket, rr, H, W,
                s, inv_theta, c1, c2, n_coeffs, tile_rows, tile_cols, st);
}

// B5: `partials` holds n_partials >= 2 tw_recurrence_r0_blocks(H, W)
// values.
int tw_recurrence_r0(int dtype, const void* u, const void* up, void* out_r0,
                     void* out_x0, void* partials, int n_partials,
                     void* ticket, void* norms, int H, int W,
                     const double* s, double c_u, double c_up,
                     int mask_combo, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = dtype == 0 ? launch_recurrence_r0<float>
                           : launch_recurrence_r0<double>;
  return launch(u, up, out_r0, out_x0, partials, n_partials, ticket, norms,
                H, W, s, c_u, c_up, mask_combo, st);
}

// B5's blocks on an H x W grid (the wrapper sizes its partials buffer from
// it).
int tw_recurrence_r0_blocks(int H, int W) {
  const dim3 grid = recurrence_r0_grid(H, W);
  return (int)(grid.x * grid.y);
}

}  // extern "C"
