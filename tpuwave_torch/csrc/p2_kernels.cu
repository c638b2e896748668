// Hand-written Hopper (sm_90a) kernels for the P2 (R = 2) canvas engine.
//
// Three kernels, each a port of one Pallas TPU kernel of
// tpuwave/ops/pallas_p2.py, templated on float and double:
//
//   B11  p2_constrained_apply  <- p2_constrained_apply_pallas (_p2_kernel)
//        (the pattern kernel, and the general kernel for other term
//        lists)
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

#include <utility>

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
// values.
//
// Bound on this card: memory, one stack read and one written (8 canvases:
// 67.5 MB at Nel 1024 f64, 20 us at 3.35 TB/s); ~46 multiply-adds per site
// are 2-3x below that.
//
// Two kernels. Term lists that fit the fixed 46-slot pattern of the P2
// mass, stiffness and system stencils (every list the engines build) take
// p2_apply_pattern_kernel below, after the slot machinery of B12 / B13;
// the host picks it by the terms alone (ops/kernels_p2.py
// p2_apply_route). Any other list (a foreign, reordered or repeated term)
// takes this general kernel: one thread per canvas site computes all four
// output planes, with a run-time term loop that reads each operand through
// L1 and tests the mask per term.
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
//   which nothing reads. Both chain n_upd applies (B13's first is corr_m's),
//   so a block's slab is its tile plus a halo of n_upd sites: after the
//   k-th apply r is exact at distance >= k from the slab edge, and so is d
//   after its update, so the tile is exact at the end.
//
// Bound on this card: memory (B12 reads 1 stack and writes 2, B13 reads 3
// and writes 1: 101 MB and 135 MB at Nel 1024 f64, 30 and 40 us at 3.35
// TB/s), against ~116 operations per site and apply, 46 of them
// multiply-adds (degree 4 at 4 x 1027^2 f64: 0.49 GFLOP, 14 us at 34
// TFLOP/s; 1.8x that over the slabs, which hold the tile and its halo).
//
// Register design (degrees up to kRegMaxDegree):
// - The term pattern is fixed at compile time: the 46 (target, source, dx,
//   dy) slots of slot_at, which the mass, stiffness and Newmark-system
//   stencils all fill (a stencil that drops an exact zero leaves its slot
//   at 0). The wrapper maps its terms onto the slots; the coefficients
//   arrive as a __grid_constant__ parameter, so each is a constant-bank
//   operand that every thread of a warp reads alike. The 46 multiply-adds
//   of a site are unrolled over register operands.
// - Only d is read at neighbours. A thread owns R consecutive slab rows of
//   one column and keeps r and x of the four planes in registers for the
//   whole chain; d of the four planes sits in shared memory, double
//   buffered (one barrier per step), read through a sliding register
//   window: per site and apply 10 shared loads (V and W 3 columns, H and D
//   2) for the 19 distinct operands, and the site's own d is the window's
//   centre.
// - Blocks whose slab is interior for all four planes run with no mask
//   test; the others set each site's 4-bit interior mask once, at staging,
//   load zeros outside the canvas, and mask corr_m as they stage it.
// - B13 issues its loads of r_pre, x_in and corr together.
// - Slab shapes per dtype are ops/kernels_p2.py's p2_smooth_geometry, one
//   of TW_P2_SMOOTH_GEOMETRIES: 64 x 32 sites in f32 (8 rows a thread),
//   32 x 32 in f64 (4 rows), 256 threads, registers capped at 128 so that
//   two blocks share an SM and one's loads overlap the other's steps. That
//   cap spills a few bytes (f32 B13, f64 B12) and still beats the same
//   shapes uncapped (one block per SM, no spill) and slabs of 16 to 64
//   rows, 32 to 128 columns and 128 to 512 threads
//   (scripts/torch_p2_smooth_geometry.py times them side by side).
//   Every slab site is computed at every step; sites near the slab edge
//   read the buffers' zero pads or a neighbouring row's values and are
//   never stored (the halo covers them).
// Higher degrees take p2_smooth_smem_kernel below, the first version.
// ---------------------------------------------------------------------------
constexpr int kRegMaxDegree = 8;

struct Slot {
  int tgt, src, dx, dy;
};
constexpr int kSlots = 46;

// Slot k: (target plane, source plane, dx, dy) in coeffs_to_static order
// (ops/kernels_p2.py SMOOTH_PATTERN). Device code calls this and the
// helpers below in constant expressions only.
__host__ __device__ constexpr Slot slot_at(int k) {
  constexpr Slot table[kSlots] = {
      {0, 0, -1, -1}, {0, 0, -1, 0}, {0, 0, 0, -1}, {0, 0, 0, 0},
      {0, 0, 0, 1},   {0, 0, 1, 0},  {0, 0, 1, 1},  {0, 1, -1, -1},
      {0, 1, -1, 0},  {0, 1, 0, 0},  {0, 1, 0, 1},  {0, 2, -1, -1},
      {0, 2, 0, -1},  {0, 2, 0, 0},  {0, 2, 1, 0},  {0, 3, -1, -1},
      {0, 3, -1, 0},  {0, 3, 0, -1}, {0, 3, 0, 0},  {1, 0, 0, -1},
      {1, 0, 0, 0},   {1, 0, 1, 0},  {1, 0, 1, 1},  {1, 1, 0, 0},
      {1, 2, 0, -1},  {1, 2, 1, 0},  {1, 3, 0, -1}, {1, 3, 0, 0},
      {2, 0, -1, 0},  {2, 0, 0, 0},  {2, 0, 0, 1},  {2, 0, 1, 1},
      {2, 1, -1, 0},  {2, 1, 0, 1},  {2, 2, 0, 0},  {2, 3, -1, 0},
      {2, 3, 0, 0},   {3, 0, 0, 0},  {3, 0, 0, 1},  {3, 0, 1, 0},
      {3, 0, 1, 1},   {3, 1, 0, 0},  {3, 1, 0, 1},  {3, 2, 0, 0},
      {3, 2, 1, 0},   {3, 3, 0, 0}};
  return table[k];
}

// source plane q is read at column offset dx
__host__ __device__ constexpr bool slot_reads(int q, int dx) {
  for (int k = 0; k < kSlots; ++k) {
    if (slot_at(k).src == q && slot_at(k).dx == dx) return true;
  }
  return false;
}

// lowest (hi = false) or highest row offset at which plane q is read
__host__ __device__ constexpr int slot_dy(int q, bool hi) {
  int v = hi ? -2 : 2;
  for (int k = 0; k < kSlots; ++k) {
    const int dy = slot_at(k).dy;
    if (slot_at(k).src == q && (hi ? dy > v : dy < v)) v = dy;
  }
  return v;
}

// first slot of target plane p (kSlots for p = 4)
__host__ __device__ constexpr int slot_first(int p) {
  for (int k = 0; k < kSlots; ++k) {
    if (slot_at(k).tgt >= p) return k;
  }
  return kSlots;
}

template <typename T>
struct SmoothParams {
  T c[kSlots];          // the slot coefficients
  T inv[4];             // inverse plane diagonals
  T c1[kRegMaxDegree];  // update j: d = c1[j] d + c2[j] (inv r),
  T c2[kRegMaxDegree];  // c2[0] = 1 / theta (c1[0] unused)
};

// A thread's window over the four planes of one d buffer: w[q][1 + dy][1 +
// dx] holds plane q at row offset dy and column offset dx from the current
// site; only the entries the pattern reads are set.
template <typename T>
using Window4 = T[4][3][3];

// Loads row offset DY of plane Q (the columns the pattern reads) from the
// buffer `cur`, whose plane 0 has the current site at index i.
template <typename T, int SX, int SXY, int Q, int DY>
__device__ __forceinline__ void window_row(Window4<T>& w,
                                           const T* __restrict__ cur, int i) {
  const T* row = cur + Q * SXY + i + DY * SX;
  if constexpr (slot_reads(Q, -1)) w[Q][1 + DY][0] = row[-1];
  w[Q][1 + DY][1] = row[0];
  if constexpr (slot_reads(Q, 1)) w[Q][1 + DY][2] = row[1];
}

// Before the first site: rows lo .. hi - 1 of each plane.
template <typename T, int SX, int SXY, int Q>
__device__ __forceinline__ void window_prime_plane(Window4<T>& w,
                                                   const T* __restrict__ cur,
                                                   int i) {
  constexpr int lo = slot_dy(Q, false), hi = slot_dy(Q, true);
  if constexpr (lo < hi) window_row<T, SX, SXY, Q, lo>(w, cur, i);
  if constexpr (lo + 1 < hi) window_row<T, SX, SXY, Q, lo + 1>(w, cur, i);
}

template <typename T, int SX, int SXY>
__device__ __forceinline__ void window_prime(Window4<T>& w,
                                             const T* __restrict__ cur,
                                             int i) {
  window_prime_plane<T, SX, SXY, 0>(w, cur, i);
  window_prime_plane<T, SX, SXY, 1>(w, cur, i);
  window_prime_plane<T, SX, SXY, 2>(w, cur, i);
  window_prime_plane<T, SX, SXY, 3>(w, cur, i);
}

// At each site: the leading row (offset hi) of each plane.
template <typename T, int SX, int SXY>
__device__ __forceinline__ void window_lead(Window4<T>& w,
                                            const T* __restrict__ cur,
                                            int i) {
  window_row<T, SX, SXY, 0, slot_dy(0, true)>(w, cur, i);
  window_row<T, SX, SXY, 1, slot_dy(1, true)>(w, cur, i);
  window_row<T, SX, SXY, 2, slot_dy(2, true)>(w, cur, i);
  window_row<T, SX, SXY, 3, slot_dy(3, true)>(w, cur, i);
}

// One row down: offset dy of plane Q takes offset dy + 1's values,
// lo <= dy < hi.
template <typename T, int Q>
__device__ __forceinline__ void window_slide_plane(Window4<T>& w) {
  constexpr int lo = slot_dy(Q, false), hi = slot_dy(Q, true);
#pragma unroll
  for (int dy = lo; dy < hi; ++dy) {
    if constexpr (slot_reads(Q, -1)) w[Q][1 + dy][0] = w[Q][2 + dy][0];
    w[Q][1 + dy][1] = w[Q][2 + dy][1];
    if constexpr (slot_reads(Q, 1)) w[Q][1 + dy][2] = w[Q][2 + dy][2];
  }
}

template <typename T>
__device__ __forceinline__ void window_slide(Window4<T>& w) {
  window_slide_plane<T, 0>(w);
  window_slide_plane<T, 1>(w);
  window_slide_plane<T, 2>(w);
  window_slide_plane<T, 3>(w);
}

// acc_p = sum over the slots of target p, in slot order, of c_k * operand.
template <int K, typename T>
__device__ __forceinline__ void slot_add(T (&acc)[4], const Window4<T>& w,
                                         const T* __restrict__ c) {
  constexpr Slot s = slot_at(K);
  constexpr int p = s.tgt, q = s.src, dx = s.dx, dy = s.dy;
  const T v = c[K] * w[q][1 + dy][1 + dx];
  if constexpr (slot_first(p) == K) {
    acc[p] = v;
  } else {
    acc[p] += v;
  }
}

template <typename T, int... K>
__device__ __forceinline__ void slot_sums(T (&acc)[4], const Window4<T>& w,
                                          const T* __restrict__ c,
                                          std::integer_sequence<int, K...>) {
  (slot_add<K>(acc, w, c), ...);
}

// ---------------------------------------------------------------------------
// B11 pattern kernel: the 46 slots of slot_at, coefficients and plane
// diagonals as a __grid_constant__ parameter (constant-bank operands).
//
// Each block owns a TX x (TY R) tile of canvas sites and stages x of the
// four planes over the tile plus a one-site halo in shared memory, every
// thread issuing all its loads before it stores the first. With mask_input
// it stages 0 for a site outside its plane's interior (and outside the
// canvas), so the mask costs one test per staged site instead of one per
// term; without it, raw x (0 outside the canvas). Each thread then walks R
// rows of one column with the sliding window of B12 / B13 over the 19
// distinct operands (10 shared loads per site for the four planes) and
// sums the 46 multiply-adds unrolled in slot order, which is
// coeffs_to_static order, the order of the plain version. An output
// outside its plane's interior is diag_p times raw x: staged raw x without
// mask_input, else a load of x. Only a block whose slab holds a site that
// is not interior for some plane (rows < 2 or > ny, columns < 2 or > nx)
// tests masks or canvas bounds; every other block runs the instance with
// no test. Tile shapes per dtype and canvas size: ops/kernels_p2.py
// p2_apply_geometry, one of TW_P2_APPLY_GEOMETRIES.
// ---------------------------------------------------------------------------
template <typename T>
struct ApplyParams {
  T c[kSlots];  // the slot coefficients
  T diag[4];    // the pinned outputs' scale per plane
};

template <typename T, int TX, int TY, int R, bool WALLS, bool MASK>
__device__ __forceinline__ void p2_apply_pattern_walk(
    const T* __restrict__ x, T* __restrict__ out, T* __restrict__ xs,
    int Hc, int Wc, int nx, int ny, int r0, int c0,
    const ApplyParams<T>& ap) {
  constexpr int SX = TX + 2, SY = TY * R + 2, SXY = SX * SY;
  constexpr int NT = TX * TY, NS = (4 * SXY + NT - 1) / NT;
  const size_t plane = (size_t)Hc * Wc;
  const int tid = threadIdx.y * TX + threadIdx.x;
  // slab site (sr, sc) of plane p is canvas site (r0 - 1 + sr, c0 - 1 + sc)
  T v[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int i = tid + k * NT;
    const int p = i / SXY, j = i - p * SXY;
    const int sr = j / SX, gr = r0 - 1 + sr, gc = c0 - 1 + (j - sr * SX);
    bool in = i < 4 * SXY;
    if (WALLS) {
      in = in && gr >= 0 && gr < Hc && gc >= 0 && gc < Wc &&
           (!MASK || p2_interior(p, gr, gc, nx, ny));
    }
    v[k] = in ? __ldg(x + p * plane + (size_t)gr * Wc + gc) : T(0);
  }
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int i = tid + k * NT;
    if (i < 4 * SXY) xs[i] = v[k];
  }
  __syncthreads();
  const int gc = c0 + threadIdx.x;
  if (gc >= Wc) return;
  const int row0 = r0 + threadIdx.y * R;
  const int base = (threadIdx.y * R + 1) * SX + threadIdx.x + 1;
  Window4<T> w;
  window_prime<T, SX, SXY>(w, xs, base);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int gr = row0 + i;
    if (gr >= Hc) break;
    window_lead<T, SX, SXY>(w, xs, base + i * SX);
    T acc[4];
    slot_sums(acc, w, ap.c, std::make_integer_sequence<int, kSlots>{});
    const size_t g = (size_t)gr * Wc + gc;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      T o = acc[p];
      if (WALLS && !p2_interior(p, gr, gc, nx, ny)) {
        o = ap.diag[p] * (MASK ? __ldg(x + p * plane + g) : w[p][1][1]);
      }
      out[p * plane + g] = o;
    }
    window_slide(w);
  }
}

template <typename T, int TX, int TY, int R>
__global__ void __launch_bounds__(TX * TY)
p2_apply_pattern_kernel(const T* __restrict__ x, T* __restrict__ out, int Hc,
                        int Wc, int nx, int ny, int mask_input,
                        const __grid_constant__ ApplyParams<T> ap) {
  __shared__ T xs[4 * (TX + 2) * (TY * R + 2)];
  const int r0 = blockIdx.y * (TY * R);  // canvas row of the tile's row 0
  const int c0 = blockIdx.x * TX;
  // the slab (tile and halo) holds a site that is not interior for some
  // plane: every plane's interior covers rows 2 .. ny, columns 2 .. nx
  const bool walls = r0 - 1 < 2 || c0 - 1 < 2 || r0 + TY * R > ny ||
                     c0 + TX > nx;
  if (!walls) {
    p2_apply_pattern_walk<T, TX, TY, R, false, false>(x, out, xs, Hc, Wc, nx,
                                                      ny, r0, c0, ap);
  } else if (mask_input) {
    p2_apply_pattern_walk<T, TX, TY, R, true, true>(x, out, xs, Hc, Wc, nx,
                                                    ny, r0, c0, ap);
  } else {
    p2_apply_pattern_walk<T, TX, TY, R, true, false>(x, out, xs, Hc, Wc, nx,
                                                     ny, r0, c0, ap);
  }
}

template <typename T, int SX, int TY, int R, bool POST, bool WALLS>
__device__ __forceinline__ void p2_smooth_walk(
    const T* __restrict__ rin, const T* __restrict__ xin,
    const T* __restrict__ corr, T* __restrict__ out_x, T* __restrict__ out_r,
    T* __restrict__ ds, int Hc, int Wc, int nx, int ny, int r0, int c0,
    int deg, int tile_y, int tile_x, const SmoothParams<T>& sp) {
  static_assert(4 * R <= 32, "one 32-bit interior mask per thread");
  constexpr int SY = TY * R, SXY = SX * SY, kPad = SX + 1;
  constexpr int SB = 4 * SXY + 2 * kPad;
  const int sc = threadIdx.x, sr0 = threadIdx.y * R;
  const int gc = c0 + sc;
  const int base = kPad + sr0 * SX + sc;  // plane 0, the thread's first row
  const size_t plane = (size_t)Hc * Wc;
  const bool col_tile = sc >= deg && sc < deg + tile_x && gc < Wc;
  T rv[R][4], xv[R][4], dv[R][4];
  unsigned inter = 0, tile_bits = 0;
  // every load of the block's inputs is issued before any is used
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int sr = sr0 + i, gr = r0 + sr;
    const bool in = !WALLS || (gr >= 0 && gr < Hc && gc >= 0 && gc < Wc);
    const bool t = col_tile && sr >= deg && sr < deg + tile_y &&
                   (!WALLS || gr < Hc);
    const size_t g = in ? (size_t)gr * Wc + gc : 0;
    tile_bits |= (unsigned)t << i;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const bool ip = !WALLS || (in && p2_interior(p, gr, gc, nx, ny));
      inter |= (unsigned)ip << (4 * i + p);
      rv[i][p] = in ? __ldg(rin + p * plane + g) : T(0);
      if constexpr (POST) {
        xv[i][p] = t ? __ldg(xin + p * plane + g) : T(0);
        dv[i][p] = ip ? __ldg(corr + p * plane + g) : T(0);
      }
    }
  }
  // the first d: corr_m (B13) or c2_0 inv r (B12)
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      T d;
      if constexpr (POST) {
        d = dv[i][p];
        xv[i][p] += d;
      } else {
        d = sp.c2[0] * (sp.inv[p] * rv[i][p]);
        xv[i][p] = d;
      }
      ds[p * SXY + base + i * SX] = d;
    }
  }
  __syncthreads();

  for (int s = 0; s < deg; ++s) {
    // apply s reads buffer s & 1; the update after it writes the other
    const T* __restrict__ cur = ds + (s & 1) * SB;
    T* __restrict__ nxt = ds + ((s + 1) & 1) * SB;
    const bool write = s + 1 < deg;
    const bool update = POST || write;
    const int j = POST ? s : s + 1;
    const T c1 = update ? sp.c1[j] : T(0);
    const T c2 = update ? sp.c2[j] : T(0);
    Window4<T> w;
    window_prime<T, SX, SXY>(w, cur, base);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int q = base + i * SX;
      window_lead<T, SX, SXY>(w, cur, q);
      T acc[4];
      slot_sums(acc, w, sp.c, std::make_integer_sequence<int, kSlots>{});
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (!WALLS || ((inter >> (4 * i + p)) & 1u)) rv[i][p] -= acc[p];
      }
      if (update) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const T z = sp.inv[p] * rv[i][p];
          const T d = j == 0 ? c2 * z : c1 * w[p][1][1] + c2 * z;
          xv[i][p] += d;
          if (write) nxt[p * SXY + q] = d;
        }
      }
      window_slide(w);
    }
    if (write) __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!((tile_bits >> i) & 1u)) continue;
    const size_t g = (size_t)(r0 + sr0 + i) * Wc + gc;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      out_x[p * plane + g] = xv[i][p];
      if constexpr (!POST) out_r[p * plane + g] = rv[i][p];
    }
  }
}

template <typename T, int SX, int TY, int R, int MINB, bool POST>
__global__ void __launch_bounds__(SX * TY, MINB)
p2_smooth_reg_kernel(const T* __restrict__ rin, const T* __restrict__ xin,
                     const T* __restrict__ corr, T* __restrict__ out_x,
                     T* __restrict__ out_r, int Hc, int Wc, int nx, int ny,
                     int deg, const __grid_constant__ SmoothParams<T> sp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ds = reinterpret_cast<T*>(smem_raw);
  constexpr int SY = TY * R, kPad = SX + 1;
  constexpr int SB = 4 * SX * SY + 2 * kPad;
  const int tile_y = SY - 2 * deg, tile_x = SX - 2 * deg;
  const int r0 = blockIdx.y * tile_y - deg;  // canvas row of slab row 0
  const int c0 = blockIdx.x * tile_x - deg;  // canvas col of slab col 0
  const int tid = threadIdx.y * SX + threadIdx.x;
  // the zero pads before and after each buffer's four planes
  for (int q = tid; q < 2 * kPad; q += SX * TY) {
    const int k = q < kPad ? q : SB - 2 * kPad + q;
    ds[k] = T(0);
    ds[SB + k] = T(0);
  }
  // the slab holds a site that is not interior for some plane
  const bool walls = r0 < 2 || c0 < 2 || r0 + SY - 1 > ny ||
                     c0 + SX - 1 > nx;
  if (walls) {
    p2_smooth_walk<T, SX, TY, R, POST, true>(rin, xin, corr, out_x, out_r,
                                             ds, Hc, Wc, nx, ny, r0, c0, deg,
                                             tile_y, tile_x, sp);
  } else {
    p2_smooth_walk<T, SX, TY, R, POST, false>(rin, xin, corr, out_x, out_r,
                                              ds, Hc, Wc, nx, ny, r0, c0,
                                              deg, tile_y, tile_x, sp);
  }
}

// The first version, kept for degrees above kRegMaxDegree: each block
// loads its inputs with a halo of n_upd sites on every side into dynamic
// shared memory (zero outside the canvas) and runs the chain there. The
// slab holds r and d of the four planes, (tile + 2 n_upd)^2 each, and the
// centre tile of x; the wrapper picks the largest tile (64, 32, 16) that
// fits the card's opt-in limit. A barrier after the loads (the x tile is
// written by other threads than those that add d into it), then two per
// step: d (and x) in place, then r from d's neighbours. Every stencil
// operand is read from shared memory, with the terms (coefficient and slab
// offset each) staged there too.
//
// r -= A_I(d) over slab sites at distance >= lo from the slab edge.
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
__global__ void p2_smooth_smem_kernel(const T* __restrict__ rin,
                                      const T* __restrict__ xin,
                                      const T* __restrict__ corr,
                                      T* __restrict__ out_x,
                                      T* __restrict__ out_r, int Hc, int Wc,
                                      int nx, int ny, P2Terms tm, Plane4 inv,
                                      SmoothCoeffs cf, int n_upd, int post,
                                      int tile) {
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

// The slot pattern with its coefficients as a term list (the shared-slab
// kernel's form).
P2Terms slot_terms(const double* c) {
  P2Terms tm;
  for (int k = 0; k < kMaxTerms; ++k) {
    const bool on = k < kSlots;
    tm.c[k] = on ? c[k] : 0.0;
    tm.src[k] = on ? slot_at(k).src : 0;
    tm.dx[k] = on ? slot_at(k).dx : 0;
    tm.dy[k] = on ? slot_at(k).dy : 0;
  }
  for (int p = 0; p <= 4; ++p) tm.start[p] = slot_first(p);
  return tm;
}

// dynamic shared memory of p2_smooth_smem_kernel: r and d slabs and the x
// tile of the four planes, then the staged terms
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

template <typename K>
int opt_in_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

// The pattern kernel's tile shapes: (element type, tile columns, threads in
// y, rows per thread), the shapes ops/kernels_p2.py's p2_apply_geometry
// picks (a large tile on large canvases, a small one below). A build may
// define others first (nvcc --pre-include) to time them
// (scripts/torch_p2_apply_geometry.py).
#ifndef TW_P2_APPLY_GEOMETRIES
#define TW_P2_APPLY_GEOMETRIES(X) \
  X(float, 128, 2, 8) X(float, 32, 8, 2) X(double, 64, 2, 4) X(double, 32, 8, 2)
#endif

template <typename T, int TX, int TY, int R>
int launch_apply_pattern(const void* x, void* out, int Hc, int Wc, int nx,
                         int ny, const double* slot_c, const double* diag,
                         int mask_input, cudaStream_t stream) {
  ApplyParams<T> ap;
  for (int k = 0; k < kSlots; ++k) ap.c[k] = T(slot_c[k]);
  for (int p = 0; p < 4; ++p) ap.diag[p] = T(diag[p]);
  const dim3 block(TX, TY);
  const dim3 grid((Wc + TX - 1) / TX, (Hc + TY * R - 1) / (TY * R));
  p2_apply_pattern_kernel<T, TX, TY, R><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), Hc, Wc, nx, ny,
      mask_input, ap);
  return (int)cudaGetLastError();
}

// The smoothing call's arguments (host values except the canvases).
struct SmoothArgs {
  int post;
  const void *rin, *xin, *corr;
  void *out_x, *out_r;
  int Hc, Wc, nx, ny;
  const double* slot_c;    // kSlots coefficients
  const double* inv_diag;  // 4
  double inv_theta;
  const double *c1, *c2;   // n_pairs each
  int n_pairs;
  int tile_rows, tile_cols;
  cudaStream_t stream;
};

template <typename T, int SX, int TY, int R, int MINB>
int launch_smooth_reg(const SmoothArgs& a) {
  const int deg = 1 + a.n_pairs;
  if (deg > kRegMaxDegree || a.tile_rows != TY * R - 2 * deg ||
      a.tile_cols != SX - 2 * deg || a.tile_rows <= 0 || a.tile_cols <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  SmoothParams<T> sp;
  for (int k = 0; k < kSlots; ++k) sp.c[k] = T(a.slot_c[k]);
  for (int p = 0; p < 4; ++p) sp.inv[p] = T(a.inv_diag[p]);
  for (int k = 0; k < kRegMaxDegree; ++k) {
    sp.c1[k] = (k >= 1 && k <= a.n_pairs) ? T(a.c1[k - 1]) : T(0);
    sp.c2[k] = k == 0 ? T(a.inv_theta)
                      : (k <= a.n_pairs ? T(a.c2[k - 1]) : T(0));
  }
  const size_t smem = 2 * (4 * (size_t)SX * TY * R + 2 * (SX + 1)) * sizeof(T);
  const dim3 grid((a.Wc + a.tile_cols - 1) / a.tile_cols,
                  (a.Hc + a.tile_rows - 1) / a.tile_rows);
  const dim3 block(SX, TY);
  const T* rin = static_cast<const T*>(a.rin);
  const T* xin = static_cast<const T*>(a.xin);
  const T* corr = static_cast<const T*>(a.corr);
  T* out_x = static_cast<T*>(a.out_x);
  T* out_r = static_cast<T*>(a.out_r);
  if (a.post) {
    const int e =
        opt_in_smem(p2_smooth_reg_kernel<T, SX, TY, R, MINB, true>, smem);
    if (e != 0) return e;
    p2_smooth_reg_kernel<T, SX, TY, R, MINB, true>
        <<<grid, block, smem, a.stream>>>(
        rin, xin, corr, out_x, out_r, a.Hc, a.Wc, a.nx, a.ny, deg, sp);
  } else {
    const int e =
        opt_in_smem(p2_smooth_reg_kernel<T, SX, TY, R, MINB, false>, smem);
    if (e != 0) return e;
    p2_smooth_reg_kernel<T, SX, TY, R, MINB, false>
        <<<grid, block, smem, a.stream>>>(
        rin, xin, corr, out_x, out_r, a.Hc, a.Wc, a.nx, a.ny, deg, sp);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_smooth_smem(const SmoothArgs& a) {
  const int tile = a.tile_rows;
  if (a.n_pairs < 0 || a.n_pairs > kMaxPairs || tile <= 0 ||
      a.tile_cols != tile) {
    return (int)cudaErrorInvalidValue;
  }
  SmoothCoeffs cf;
  for (int k = 0; k <= kMaxPairs; ++k) {
    cf.c1[k] = (k >= 1 && k <= a.n_pairs) ? a.c1[k - 1] : 0.0;
    cf.c2[k] = k == 0 ? a.inv_theta : (k <= a.n_pairs ? a.c2[k - 1] : 0.0);
  }
  const int n_upd = 1 + a.n_pairs;
  const size_t smem = smooth_smem_bytes(tile, n_upd, sizeof(T));
  const int e = opt_in_smem(p2_smooth_smem_kernel<T>, smem);
  if (e != 0) return e;
  const dim3 block(32, 16);
  const dim3 grid((a.Wc + tile - 1) / tile, (a.Hc + tile - 1) / tile);
  p2_smooth_smem_kernel<T><<<grid, block, smem, a.stream>>>(
      static_cast<const T*>(a.rin), static_cast<const T*>(a.xin),
      static_cast<const T*>(a.corr), static_cast<T*>(a.out_x),
      static_cast<T*>(a.out_r), a.Hc, a.Wc, a.nx, a.ny,
      slot_terms(a.slot_c), load4(a.inv_diag), cf, n_upd, a.post, tile);
  return (int)cudaGetLastError();
}

// The register kernel's geometries: (element type, slab columns, threads
// in y, rows per thread, blocks per SM its registers must allow), the
// shapes ops/kernels_p2.py's p2_smooth_geometry picks. A build may define
// others first (nvcc --pre-include) to time them.
#ifndef TW_P2_SMOOTH_GEOMETRIES
#define TW_P2_SMOOTH_GEOMETRIES(X) X(float, 64, 4, 8, 2) X(double, 32, 8, 4, 2)
#endif

int launch_smooth(int dtype, const SmoothArgs& a, int threads_y, int rows) {
  if (threads_y <= 0) {
    return dtype == 0 ? launch_smooth_smem<float>(a)
                      : launch_smooth_smem<double>(a);
  }
  const int slab_cols = a.tile_cols + 2 * (1 + a.n_pairs);
#define TW_P2_TRY(TT, SX, TY, R, MINB)                                 \
  if (dtype == (sizeof(TT) == 8 ? 1 : 0) && slab_cols == SX &&         \
      threads_y == TY && rows == R) {                                  \
    return launch_smooth_reg<TT, SX, TY, R, MINB>(a);                  \
  }
  TW_P2_SMOOTH_GEOMETRIES(TW_P2_TRY)
#undef TW_P2_TRY
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. Pointers are device pointers except the
// term arrays (n_terms host values each: target plane, source plane, dx,
// dy, coefficient), the slot coefficients (kSlots host doubles), the four
// host doubles of diag / inv_diag, and c1 / c2 (n_pairs host doubles
// each). Canvases are (4, Hc, Wc), contiguous.

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

// slot_c: kSlots host doubles, the terms on the slots of slot_at (0 for an
// absent term); diag: 4 host doubles; a tile of tile_cols x (threads_y *
// rows) sites, one of TW_P2_APPLY_GEOMETRIES (else refused).
int tw_p2_apply_pattern(int dtype, const void* x, void* out, int Hc, int Wc,
                        int nx, int ny, const double* slot_c,
                        const double* diag, int mask_input, int tile_cols,
                        int threads_y, int rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TW_P2_TRY_APPLY(TT, TX, TY, R)                                      \
  if (dtype == (sizeof(TT) == 8 ? 1 : 0) && tile_cols == TX &&              \
      threads_y == TY && rows == R) {                                       \
    return launch_apply_pattern<TT, TX, TY, R>(x, out, Hc, Wc, nx, ny,      \
                                               slot_c, diag, mask_input, st); \
  }
  TW_P2_APPLY_GEOMETRIES(TW_P2_TRY_APPLY)
#undef TW_P2_TRY_APPLY
  return (int)cudaErrorInvalidValue;
}

// post = 0: B12, rin = b, out (x, r); xin and corr unused (may be null).
// post = 1: B13, rin = r_pre, xin = x, corr; out x; out_r unused.
// threads_y > 0: the register kernel, slabs of (tile_cols + 2 degree)
// columns and threads_y * rows rows (one of TW_P2_SMOOTH_GEOMETRIES, else
// refused); threads_y = 0: the shared-slab kernel, square tiles of
// tile_rows = tile_cols sites.
int tw_p2_smooth(int dtype, int post, const void* rin, const void* xin,
                 const void* corr, void* out_x, void* out_r, int Hc, int Wc,
                 int nx, int ny, const double* slot_c,
                 const double* inv_diag, double inv_theta, const double* c1,
                 const double* c2, int n_pairs, int tile_rows, int tile_cols,
                 int threads_y, int rows, void* stream) {
  if (n_pairs < 0) return (int)cudaErrorInvalidValue;
  const SmoothArgs a{post,     rin,      xin,       corr,   out_x,
                     out_r,    Hc,       Wc,        nx,     ny,
                     slot_c,   inv_diag, inv_theta, c1,     c2,
                     n_pairs,  tile_rows, tile_cols,
                     static_cast<cudaStream_t>(stream)};
  return launch_smooth(dtype, a, threads_y, rows);
}

}  // extern "C"
