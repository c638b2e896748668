// Hand-written Hopper (sm_90a) kernels for the structured-P1 wave step.
//
// Four kernels, each a port of one Pallas TPU kernel of
// tpuwave/ops/pallas_kernels.py, templated on float and double:
//
//   B1  leapfrog_step          <- leapfrog_step_pallas (_kernel)
//   B2  leapfrog_multistep     <- leapfrog_multistep_pallas (_multistep_kernel)
//   B3  constrained_apply      <- constrained_stencil_apply_pallas
//                                 (_constrained_apply_kernel)
//   B6  leapfrog_multistep_driven
//                              <- leapfrog_multistep_driven_pallas
//                                 (_multistep_driven_kernel)
//
// All four act on a row-major (H, W) vertex grid at its true shape: no
// padding, no layout rule. The 3x3 stencil is a run-time argument
// (s[1 + dj][1 + di] couples node (r, c) to node (r + dj, c + di)), so a new
// dt or mesh needs no rebuild. A node is PINNED when its global row is
// <= 0 or >= n_rows - 1, or its column is <= 0 or >= W - 1 (the Dirichlet
// walls; B2 adds a global row offset for a row block of a larger grid, B3 a
// row and a column offset and the global shape).
//
// Plain C interface, bound from Python with ctypes (ops/kernels.py). Every
// entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 = success).

#include <algorithm>
#include <type_traits>
#include <utility>

#include "grid_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B3: constrained stencil apply (the CG matvec of every implicit solve).
//
//   interior node: sum_d s_d * xm[n + d], xm = x with pinned nodes set to 0
//   pinned node:   diag * x[n]            (raw, unmasked x)
//   diff = 1:      sum_{d != 0} s_d * (xm[n + d] - xm[n])  (zero-row-sum form)
//
// Bound on this card: memory. It reads 1 array and writes 1 (8 B/point in
// f32, 16 B in f64) for ~9 multiply-adds per point.
//
// Each block owns a 64 x (4 R) tile of outputs. It stages xm over the tile
// plus a one-node halo in shared memory, so the mask is applied once per
// node, at staging (a pinned node or one outside the array stages 0), and
// the stencil needs no test per neighbour; a thread starts all its staging
// loads before it stores the first. Each thread then walks down one column
// of the tile for R outputs with a sliding 3x3 register window (three
// shared-memory loads per output instead of nine). Pinned outputs lie only
// on rows 0 and H - 1 and columns 0 and W - 1: only a block whose tile
// touches a wall tests for them, once per output row and once per column,
// and takes diag * x from the raw array. R = 8 on grids of at least
// kB3LargeNodes nodes (less halo per output), R = 2 below (enough blocks
// to fill the card at 641^2); tiny grids take the direct kernel below. (The
// first version ran one thread per output with nine masked __ldg loads and
// nine four-compare mask tests each: 17-38% of the bound.)
//
// Global offsets (B3Place): the array may be a block of a larger (NH, NW)
// grid whose node (ro, co) is the array's (0, 0) -- a rank's halo-padded
// block under domain decomposition. The walls are then the global grid's:
// a node is pinned by its global row and column, and nodes outside the
// array stage 0 (their outputs are not exact; the caller crops them).
// The host turns the offsets into the walls' rows and columns in array
// coordinates. The whole grid (ro = co = 0, (NH, NW) = (H, W)) runs the
// kernels' PLACED = false instances, whose tests are the array's own walls
// as before the offsets existed (a placed instance there ran 5-10% slower
// at 4097^2 f32 in device time).
// ---------------------------------------------------------------------------
constexpr int kB3TileX = 64, kB3ThreadsY = 4;
constexpr int kB3SlabX = kB3TileX + 2;
constexpr int kB3Threads = kB3TileX * kB3ThreadsY;
constexpr int kB3SmallRows = 2, kB3LargeRows = 8;
constexpr long long kB3LargeNodes = 1LL << 21;

struct B3Place {
  // the walls in array coordinates: a node is pinned where r <= r0, r >=
  // r1, c <= c0 or c >= c1 (clamped to [-2, H + 1] x [-2, W + 1])
  int r0, r1, c0, c1;
  // staged (in the array and not pinned) where lr0 < r < lr1, lc0 < c < lc1
  int lr0, lr1, lc0, lc1;
  __device__ __forceinline__ bool pinned(int r, int c) const {
    return r <= r0 || r >= r1 || c <= c0 || c >= c1;
  }
  __device__ __forceinline__ bool live(int r, int c) const {
    return r > lr0 && r < lr1 && c > lc0 && c < lc1;
  }
};

B3Place b3_place(int H, int W, long long ro, long long co, long long nh,
                 long long nw) {
  auto clamp = [](long long v, long long n) {
    return (int)std::max(-2LL, std::min(n + 1, v));
  };
  B3Place p;
  p.r0 = clamp(-ro, H);
  p.r1 = clamp(nh - 1 - ro, H);
  p.c0 = clamp(-co, W);
  p.c1 = clamp(nw - 1 - co, W);
  p.lr0 = std::max(p.r0, -1);
  p.lr1 = std::min(p.r1, H);
  p.lc0 = std::max(p.c0, -1);
  p.lc1 = std::min(p.c1, W);
  return p;
}

template <typename T, int R, bool WALLS, bool PLACED>
__device__ __forceinline__ void constrained_apply_walk(
    const T* __restrict__ xs, const T* __restrict__ x, T* __restrict__ out,
    int H, int W, int r0, int c0, const StencilT<T>& st, T diag, int diff,
    const B3Place& pl) {
  const int gc = c0 + 1 + threadIdx.x;
  const bool col_wall = PLACED ? gc <= pl.c0 || gc >= pl.c1
                               : gc == 0 || gc == W - 1;
  int gr = r0 + 1 + threadIdx.y * R;
  int i = (threadIdx.y * R + 1) * kB3SlabX + threadIdx.x + 1;
  Window<T, kB3SlabX> w;
  w.start(xs, i);
#pragma unroll
  for (int j = 0; j < R; ++j, ++gr, i += kB3SlabX) {
    if (gr >= H) break;
    w.next_row(xs, i);
    const size_t g = (size_t)gr * W + gc;
    const bool row_wall = PLACED ? gr <= pl.r0 || gr >= pl.r1
                                 : gr == 0 || gr == H - 1;
    if (WALLS && (col_wall || row_wall)) {
      out[g] = diag * __ldg(x + g);
    } else {
      out[g] = diff ? w.apply_diff(st) : w.apply(st);
    }
    w.advance();
  }
}

template <typename T, int R, bool PLACED>
__global__ void __launch_bounds__(kB3Threads)
constrained_apply_kernel(const T* __restrict__ x, T* __restrict__ out, int H,
                         int W, Stencil9 st9, T diag, int diff,
                         B3Place pl) {
  constexpr int kTileY = kB3ThreadsY * R;
  constexpr int kSlab = kB3SlabX * (kTileY + 2);
  constexpr int kStage = (kSlab + kB3Threads - 1) / kB3Threads;
  __shared__ T xs[kSlab];
  const int r0 = blockIdx.y * kTileY - 1;  // array row of slab row 0
  const int c0 = blockIdx.x * kB3TileX - 1;
  const int tid = threadIdx.y * kB3TileX + threadIdx.x;
  T v[kStage];
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    if constexpr (PLACED) {
      const int i = tid + k * kB3Threads;
      const int sr = i / kB3SlabX;
      const int gr = r0 + sr, gc = c0 + (i - sr * kB3SlabX);
      const bool live = i < kSlab && pl.live(gr, gc);
      v[k] = live ? __ldg(x + (size_t)gr * W + gc) : T(0);
    } else {
      const size_t g = slab_node<kB3SlabX, kSlab>(tid + k * kB3Threads, r0,
                                                  c0, H, W);
      v[k] = g != kNoNode ? __ldg(x + g) : T(0);
    }
  }
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int i = tid + k * kB3Threads;
    if (i < kSlab) xs[i] = v[k];
  }
  __syncthreads();
  if (c0 + 1 + (int)threadIdx.x >= W) return;
  const StencilT<T> st(st9);
  // the tile's rows r0 + 1 .. r0 + kTileY and columns c0 + 1 ..
  // c0 + kB3TileX touch a wall
  const bool walls =
      PLACED ? r0 < pl.r0 || c0 < pl.c0 || r0 + kTileY >= pl.r1 ||
                   c0 + kB3TileX >= pl.c1
             : r0 < 0 || c0 < 0 || r0 + kTileY >= H - 1 ||
                   c0 + kB3TileX >= W - 1;
  if (walls) {
    constrained_apply_walk<T, R, true, PLACED>(xs, x, out, H, W, r0, c0, st,
                                               diag, diff, pl);
  } else {
    constrained_apply_walk<T, R, false, PLACED>(xs, x, out, H, W, r0, c0,
                                                st, diag, diff, pl);
  }
}

// Grids below kB3TinyNodes nodes (the V-cycle's coarse levels): one thread
// per output in 32 x 8 blocks, no shared memory, nine __ldg loads. There
// the kernel is a few DRAM round trips above the launch floor, and the
// staged tiles' shared-memory hop and barrier cost more than they save.
// The mask takes four compares per output (the centre row and column are
// never walls), not one test per neighbour.
constexpr long long kB3TinyNodes = 1LL << 16;

template <typename T, bool PLACED>
__global__ void __launch_bounds__(256)
constrained_apply_direct_kernel(const T* __restrict__ x, T* __restrict__ out,
                                int H, int W, Stencil9 st9, T diag,
                                int diff, B3Place pl) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int r = blockIdx.y * 8 + threadIdx.y;
  if (r >= H || c >= W) return;
  const size_t i = (size_t)r * W + c;
  if (PLACED ? pl.pinned(r, c)
             : r == 0 || r == H - 1 || c == 0 || c == W - 1) {
    out[i] = diag * __ldg(x + i);
    return;
  }
  // which neighbouring rows and columns lie in the array and are not walls
  const bool ru = PLACED ? r - 1 > pl.lr0 : r - 1 > 0;
  const bool rd = PLACED ? r + 1 < pl.lr1 : r + 1 < H - 1;
  const bool cl = PLACED ? c - 1 > pl.lc0 : c - 1 > 0;
  const bool cr = PLACED ? c + 1 < pl.lc1 : c + 1 < W - 1;
  const T* xu = x + i - W;
  const T* xm = x + i;
  const T* xd = x + i + W;
  Window<T, 0> w;
  w.up.v[0] = ru && cl ? __ldg(xu - 1) : T(0);
  w.up.v[1] = ru ? __ldg(xu) : T(0);
  w.up.v[2] = ru && cr ? __ldg(xu + 1) : T(0);
  w.mid.v[0] = cl ? __ldg(xm - 1) : T(0);
  w.mid.v[1] = __ldg(xm);
  w.mid.v[2] = cr ? __ldg(xm + 1) : T(0);
  w.down.v[0] = rd && cl ? __ldg(xd - 1) : T(0);
  w.down.v[1] = rd ? __ldg(xd) : T(0);
  w.down.v[2] = rd && cr ? __ldg(xd + 1) : T(0);
  const StencilT<T> st(st9);
  out[i] = diff ? w.apply_diff(st) : w.apply(st);
}

template <typename T, int R, bool PLACED>
int launch_b3_tiles(const void* x, void* out, int H, int W, const double* s,
                    double diag, int diff, const B3Place& pl,
                    cudaStream_t stream) {
  const dim3 block(kB3TileX, kB3ThreadsY);
  const int tile_y = kB3ThreadsY * R;
  const dim3 grid((W + kB3TileX - 1) / kB3TileX, (H + tile_y - 1) / tile_y);
  constrained_apply_kernel<T, R, PLACED><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), H, W, load_stencil(s),
      (T)diag, diff, pl);
  return (int)cudaGetLastError();
}

template <typename T, bool PLACED>
int launch_b3(const void* x, void* out, int H, int W, const double* s,
              double diag, int diff, const B3Place& pl,
              cudaStream_t stream) {
  const long long nodes = (long long)H * W;
  if (nodes < kB3TinyNodes) {
    const dim3 block(32, 8);
    constrained_apply_direct_kernel<T, PLACED>
        <<<point_grid(H, W, block), block, 0, stream>>>(
            static_cast<const T*>(x), static_cast<T*>(out), H, W,
            load_stencil(s), (T)diag, diff, pl);
    return (int)cudaGetLastError();
  }
  if (nodes >= kB3LargeNodes) {
    return launch_b3_tiles<T, kB3LargeRows, PLACED>(
        x, out, H, W, s, diag, diff, pl, stream);
  }
  return launch_b3_tiles<T, kB3SmallRows, PLACED>(
      x, out, H, W, s, diag, diff, pl, stream);
}

template <typename T>
int launch_constrained_apply(const void* x, void* out, int H, int W,
                             const double* s, double diag, int diff,
                             long long ro, long long co, long long nh,
                             long long nw, cudaStream_t stream) {
  const B3Place pl = b3_place(H, W, ro, co, nh, nw);
  if (ro == 0 && co == 0 && nh == H && nw == W) {
    return launch_b3<T, false>(x, out, H, W, s, diag, diff, pl, stream);
  }
  return launch_b3<T, true>(x, out, H, W, s, diag, diff, pl, stream);
}

// An empty kernel: chip_smoke.py times it as the launch-and-event floor
// against which the small grids' times are read.
__global__ void noop_kernel() {}

// ---------------------------------------------------------------------------
// B1: one lumped leapfrog step, u' = 2u - u_prev - coef * S(u), pinned -> 0.
//
// Bound on this card: memory. It reads 2 arrays and writes 1 (12 B/point in
// f32, 24 B in f64) for ~11 multiply-adds per point. One thread per point,
// 32x8 blocks: the 3x3 reads of u are coalesced along rows and reused
// through L1/L2.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void leapfrog_step_kernel(const T* __restrict__ u,
                                     const T* __restrict__ up,
                                     T* __restrict__ out, int H, int W,
                                     Stencil9 st, T coef) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= H || c >= W) return;
  const size_t i = (size_t)r * W + c;
  if (is_pinned(r, c, H, W)) {
    out[i] = T(0);
    return;
  }
  const T uc = __ldg(u + i);
  T ku = T(st.c[4]) * uc;
#pragma unroll
  for (int dj = -1; dj <= 1; ++dj) {
#pragma unroll
    for (int di = -1; di <= 1; ++di) {
      if (dj == 0 && di == 0) continue;
      ku += T(st.c[(dj + 1) * 3 + (di + 1)]) *
            __ldg(u + (size_t)(r + dj) * W + (c + di));
    }
  }
  out[i] = (T(2) * uc - __ldg(up + i)) - coef * ku;
}

// ---------------------------------------------------------------------------
// B2: n_steps leapfrog steps in one pass (temporal blocking), a streaming
// wavefront.
//
// Each block owns a strip of tile_cols output columns and a band of output
// rows, and keeps for every time level q of its pass (q = -1 is u_prev,
// q = 0 is u, q = 1 .. depth the steps) a ring of a few rows of a
// slab_cols-wide slab (the strip plus a depth-wide column halo on each
// side) in shared memory. It marches down its band in ticks: at tick t
// level q steps the RB rows from base + RB t - L q (RB = 2 rows a tick,
// L = RB + 1 = 3): level 0 (and -1) is loaded from device memory, every
// level q >= 1 computes its rows from level q - 1's rows above, at and
// below them and level q - 2's same rows. Level q - 1 finished the lowest
// of those rows in an earlier tick (the lag L), so all levels of a tick
// are independent and one barrier per tick suffices. The band's first
// level-0 row is depth rows above it and its last depth rows below: level
// q covers depth - q rows beyond the band on each side, so level depth is
// exact on the band. Row R of every level sits in ring row (R - base) mod
// the ring (8 rows, >= 3 RB + 2): its readers (level q + 1 one tick later,
// level q + 2 as its u_prev, the writer) are done before it is
// overwritten.
//
// A thread owns up to IPT items, each one (level, group of V columns); a
// group's V values move as one 16-byte shared load or store. An item keeps
// a sliding window of RB + 2 register rows over its level's input, so per
// tick it loads RB new rows: its own V values, and the value on each side
// from the neighbouring lanes by warp shuffles (a shared load only at a
// warp's or a level's first and last group). Its u_prev is a vector load
// per row, its result a vector store. The 9 coefficients and the time step
// come as a __grid_constant__ parameter (constant-bank operands), and the
// stencil's exact zeros are compiled in (the structured P1 stencils have
// zero anti-diagonal corners, square cells' stiffness zero corners: 7 or 5
// multiply-adds instead of 9), as the plain version skips them. Rows of
// level depth leave through the ring as well: one tick later the block
// writes them, and level depth - 1's same rows (u_prev), as whole coalesced
// rows of its tile.
//
// The loads of level -1 and 0 run PF ticks ahead in registers, so a
// block's loads, steps and stores overlap. The tick loop is unrolled so
// that the window rows and the load buffers rotate by name (no register
// moves, none of a register with a load in flight); the loader and writer
// columns are fixed per thread; a warp whose items of a slot are all idle
// skips them. Only a block whose slab holds a pinned row or column tests
// for them: the walls (columns 0, W - 1) and the row offset's pinned rows
// (global row <= 0 or >= n_rows - 1); each item keeps its columns' pins as
// bits. The block shapes (TW_B2_SHAPES) were chosen on the card
// (scripts/torch_b2_geometry.py): 512 threads and one block per SM, 3
// items a thread in f32 and 2 in f64, loads 4 ticks ahead. An earlier
// step of one row a tick (ring of 5, lag 2), four rows a tick, two blocks
// per SM and fewer items each were slower (PERF.md).
//
// Work: level q computes its slab's width over band + 2 (depth - q) rows,
// so a pass does about (slab_cols / tile_cols) (1 + depth / band_rows)
// times the useful steps; the strips are evened out and their count picked
// so that the blocks fill the SMs. Device memory: u and u_prev read once,
// u and u_prev written once per pass (plus the rings' column halo from L2).
// Bound on this card: operations above depth ~4 in f32 (21 per node and
// step counted); the kernel is held by its instruction throughput, the
// integer and control work around each step.
//
// A pass of n_steps steps is ceil(n_steps / max_depth) launches of depths
// as even as they can be (ops/kernels.py multistep_geometry, which picks
// max_depth per dtype: 16 in f32, 8 in f64). Between launches the state is
// kept on the rows a single pass would still step (depth rows beyond the
// array on each side that the remaining launches need), so every node
// takes the same arithmetic as in one pass of all the steps, row-block
// offsets included.
// ---------------------------------------------------------------------------
constexpr int kB2MaxSlab = 512;  // widest slab (columns)

__host__ __device__ constexpr int b2_gcd(int x, int y) {
  return y == 0 ? x : b2_gcd(y, x % y);
}
__host__ __device__ constexpr int b2_pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * b2_pow2_at_least((x + 1) / 2);
}

// B2's block shape per dtype: (element type, threads, items per thread,
// blocks per SM that its registers must allow, ticks the loads run ahead
// (1, 2 or 4), rows each level steps per tick (RB)). A level trails the
// one below it by RB + 1 rows and keeps a ring of the power of 2 >= 3 RB +
// 2 rows; a slab of depth d holds at most threads * items / d groups of V
// columns, and its rings take 1 / (blocks per SM) of the shared memory. A
// build may define others first (nvcc --pre-include) to time them
// (scripts/torch_b2_geometry.py); ops/kernels.py mirrors these in
// _B2_SHAPE.
#ifndef TW_B2_SHAPES
#define TW_B2_SHAPES(X) X(float, 512, 3, 1, 4, 2) X(double, 512, 2, 1, 4, 2)
#endif

template <typename T>
struct B2Shape;
#define TW_B2_SHAPE(TT, NT, IPT, MINB, PF, RB)                          \
  template <>                                                            \
  struct B2Shape<TT> {                                                   \
    static constexpr int kThreads = NT, kIPT = IPT, kMinBlocks = MINB,   \
                         kPrefetch = PF, kRows = RB, kLag = RB + 1,      \
                         kRing = b2_pow2_at_least(3 * RB + 2);           \
  };
TW_B2_SHAPES(TW_B2_SHAPE)
#undef TW_B2_SHAPE

// 16-byte moves of V values
template <typename T>
struct B2Vec;
template <>
struct B2Vec<float> {
  static constexpr int kV = 4;
  __device__ __forceinline__ static void load(float (&a)[4], const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&a)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
};
template <>
struct B2Vec<double> {
  static constexpr int kV = 2;
  __device__ __forceinline__ static void load(double (&a)[2],
                                              const double* p) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    a[0] = v.x;
    a[1] = v.y;
  }
  __device__ __forceinline__ static void store(double* p,
                                               const double (&a)[2]) {
    *reinterpret_cast<double2*>(p) = make_double2(a[0], a[1]);
  }
};

template <typename T>
struct B2Params {
  const T* u;    // input rows in_a .. in_a + in_h - 1 (0 outside)
  const T* up;
  T* out_u;      // output rows out_a .. out_a + out_h - 1
  T* out_up;
  int in_a, in_h, out_a, out_h, W;
  int depth, tile_cols, slab_cols, band_rows;
  int pin_lo, pin_hi;  // rows <= pin_lo or >= pin_hi are pinned
  T s[9];
  T coef;
  // B6 only: the edge tables (n_steps, 2, W) and (n_steps, H, 2), and the
  // pass's substep that this launch's level 1 steps
  const T* gtb;
  const T* glr;
  int s0;
};

// ring rows of one level at slab width sw
__host__ __device__ constexpr int b2_pitch(int sw, int v) { return sw + 2 * v; }

// The stencil's exact zeros, compiled in: kB2Full all 9 terms, kB2NoAnti
// without the anti-diagonal corners s[0][2], s[2][0] (the P1 mass and
// stiffness stencils of the structured triangulation), kB2Cross without
// any corner (the stiffness on square cells: 5 terms). The plain version
// skips zero terms too.
constexpr int kB2Full = 0, kB2NoAnti = 1, kB2Cross = 2;

// One row of an item's step: the 3x3 stencil on rows up / mid / dn (V + 2
// values each, the group and a column on each side) in the plain version's
// order (the centre, then the rows above, at and below); 2 u - u_prev is
// exact in one rounding; pinned columns (pins bit i) and rows give 0.
template <typename T, int V, int PAT, bool WALLS>
__device__ __forceinline__ void b2_step(const B2Params<T>& a,
                                        const T (&up)[V + 2],
                                        const T (&mid)[V + 2],
                                        const T (&dn)[V + 2],
                                        const T (&pv)[V], bool row_pin,
                                        unsigned pins, T (&out)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    T ku = a.s[4] * mid[i + 1];
    if constexpr (PAT < kB2Cross) ku += a.s[0] * up[i];
    ku += a.s[1] * up[i + 1];
    if constexpr (PAT < kB2NoAnti) ku += a.s[2] * up[i + 2];
    ku += a.s[3] * mid[i];
    ku += a.s[5] * mid[i + 2];
    if constexpr (PAT < kB2NoAnti) ku += a.s[6] * dn[i];
    ku += a.s[7] * dn[i + 1];
    if constexpr (PAT < kB2Cross) ku += a.s[8] * dn[i + 2];
    const T v = fma(-a.coef, ku, fma(T(2), mid[i + 1], -pv[i]));
    out[i] = (WALLS && (row_pin || ((pins >> i) & 1u))) ? T(0) : v;
  }
}

// ---------------------------------------------------------------------------
// B6: n_steps DRIVEN leapfrog steps in one pass: B2's wavefront (the same
// shapes, rings, ticks, zero patterns and launch split; DRIVEN instances of
// the same body), where each level's pinned nodes take their substep's
// Dirichlet data instead of 0. Level q of a launch steps the pass's
// substep s0 + q - 1; after it, by GLOBAL coordinates,
//
//   row H - 1: gtb[s, 1, c]     row 0:     gtb[s, 0, c]
//   col W - 1: glr[s, r, 1]     col 0:     glr[s, r, 0]
//
// tested in that order (the rows win at the corners, as in tpuwave's
// overlay order left, right, bottom, top); nodes outside the array are 0.
// The value depends only on global coordinates, so every slab that holds a
// boundary row or column, its halo copies of a neighbour's boundary
// included, injects the same value at every level: blocks stay
// independent, and no atomics are used (reruns are bitwise equal). gtb is
// (n_steps, 2, W) and glr (n_steps, H, 2), row-major in the state's dtype.
// The rows outside the array are 0 at every substep, so a split pass
// chains its launches on H x W pairs.
//
// The interior blocks run B2's tick as it is. A block whose slab holds a
// pinned node (WALLS) runs B2's items too (0 on the pinned nodes), then,
// after a second barrier, a wall stage writes the tick's boundary values
// into the rings: one thread per (level, row of the tick, side) for the
// nodes of columns 0 and W - 1, its descriptor set once in shared memory
// and its values copied from glr kB6Ahead ticks ahead by cp.async; and,
// in the ticks that step rows 0 or H - 1, one thread per slab column from
// gtb. B2's tick sits at the 128-register cap: anything the stage kept in
// registers over the item loop cost more than the stage (PERF.md), so it
// reads what it needs from shared memory. (The first version stepped a
// square slab of side tile + 2 n_steps in shared memory, one barrier per
// substep: 4-16% of the bound at k >= 8.)
// ---------------------------------------------------------------------------

// an asynchronous N-byte copy from device to shared memory, the end of a
// group of them, and the waits for the thread's earlier groups
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(sa),
               "l"(gmem), "n"(N)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of the thread's latest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// B6's wall values are copied kB6Ahead ticks ahead into kB6Ahead + 1
// buffers, so that a buffer is refilled a tick after it was read
constexpr int kB6Ahead = 3;

// B6's wall jobs (below): per job a descriptor (int4 and a 64-bit table
// index) and kB6Ahead + 1 values, and 8 ints of block facts, after the
// rings in shared memory
template <typename T>
constexpr size_t b6_job_bytes(int depth) {
  return (size_t)2 * depth * B2Shape<T>::kRows *
             (16 + 8 + (kB6Ahead + 1) * sizeof(T)) +
         8 * sizeof(int);
}

// floor(x / y) for y > 0
__device__ __forceinline__ int b6_floor_div(int x, int y) {
  return x >= 0 ? x / y : -((y - 1 - x) / y);
}

template <int... PH, typename F>
__device__ __forceinline__ void b2_unrolled(std::integer_sequence<int, PH...>,
                                            F&& f) {
  (f(std::integral_constant<int, PH>{}), ...);
}

template <typename T, int PAT, bool WALLS, bool DRIVEN>
__device__ __forceinline__ void leapfrog_wavefront_body(
    const B2Params<T>& a, T* __restrict__ ring) {
  using S = B2Shape<T>;
  constexpr int V = B2Vec<T>::kV, IPT = S::kIPT, NT = S::kThreads;
  constexpr int NL = kB2MaxSlab / NT, PF = S::kPrefetch;
  constexpr int RB = S::kRows, L = S::kLag, M = S::kRing - 1;
  constexpr int NB = RB + 2;  // window rows of an item: 2 kept, RB new
  // the window rows rotate with period NB / gcd(RB, NB), the load buffers
  // with period PF; the tick loop is unrolled by both
  constexpr int PER = NB / b2_gcd(RB, NB);
  constexpr int U = PER * PF / b2_gcd(PER, PF);
  static_assert(NL * NT == kB2MaxSlab, "threads must divide the widest slab");
  const int d = a.depth, sw = a.slab_cols, G = sw / V;
  const int P = b2_pitch(sw, V);  // slab column j at ring index V + j
  const int LS = S::kRing * P;    // level q's ring at ring + (q + 1) LS
  const int tid = threadIdx.x, lane = tid & 31;
  const int c_lo = blockIdx.x * a.tile_cols - d;  // column of slab col 0
  const int band0 = a.out_a + blockIdx.y * a.band_rows;
  const int rows = min(a.band_rows, a.out_a + a.out_h - band0);
  const int base = band0 - d;  // level-0 row of tick 0
  const int n_load = (rows + 2 * d + RB - 1) / RB;  // ticks of level 0
  const int n_ticks = (rows + (L + 1) * d - 1) / RB + 2;

  // the loader's and the writer's columns: slab column tid + l NT; the
  // input row base + x lies in the input iff in_lo <= x < in_hi
  int col[NL];
  bool lok[NL], wok[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const int j = tid + l * NT, c = c_lo + j;
    col[l] = c;
    lok[l] = j < sw && c >= 0 && c < a.W;
    wok[l] = j >= d && j < d + a.tile_cols && c < a.W;
  }
  const int in_lo = a.in_a - base, in_hi = a.in_a + a.in_h - base;
  const long long in_off = (long long)(base - a.in_a) * a.W;
  const long long out_off = (long long)(band0 - a.out_a) * a.W;
  using Buf = T[RB][NL];  // one tick's input rows of a field
  // level 0's (and -1's) rows of tick t
  auto fetch = [&](int t, Buf& pu, Buf& pp) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int x = RB * t + r;
      const bool row_in = t < n_load && x >= in_lo && x < in_hi;
      const long long ro = in_off + (long long)x * a.W;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const bool ok = row_in && lok[l];
        pu[r][l] = ok ? __ldg(a.u + ro + col[l]) : T(0);
        pp[r][l] = ok ? __ldg(a.up + ro + col[l]) : T(0);
      }
    }
  };
  Buf bu[PF], bp[PF];
#pragma unroll
  for (int k = 0; k < PF; ++k) fetch(k, bu[k], bp[k]);

  // the items: level lev (1 .. d, 0 = idle), its group at ring offset
  // wofs of the ring of level lev - 1, slot = ring row of its first row
  // (RB t - L lev, mod the ring); flags: bit 0 the level's first group,
  // bit 1 its last, bit 2 + i column i pinned, bit 31 the warp holds an
  // item of this slot
  int lev[IPT], wofs[IPT], slot[IPT];
  unsigned flags[IPT];
  T win[NB][IPT][V + 2];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int item = tid + j * NT;
    const bool on = item < d * G;
    const int q = on ? item / G + 1 : 0;
    const int g = on ? item - (q - 1) * G : 0;
    lev[j] = q;
    wofs[j] = q * LS + V + g * V;
    slot[j] = (-L * q) & M;
    unsigned f = (unsigned)(g == 0) | (unsigned)(g == G - 1) << 1 |
                 (unsigned)((item & ~31) < d * G) << 31;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = c_lo + g * V + i;
      f |= (unsigned)(c <= 0 || c >= a.W - 1) << (2 + i);
    }
    flags[j] = f;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int i = 0; i < V + 2; ++i) win[b][j][i] = T(0);
    }
  }
  for (int i = tid; i < (d + 2) * LS; i += NT) ring[i] = T(0);

  // level q steps rows base + RB t - L q .. in tick t
  auto active = [&](int q, int t) {
    return t >= (L + 1) * q / RB && t <= (rows + 2 * d - q - 1 + L * q) / RB;
  };
  // B6's wall jobs: thread tid < NJ = 2 d RB injects, in every tick, the
  // node of column 0 (even tid) or W - 1 (odd) on row r = (tid / 2) mod RB
  // of level q = tid / (2 RB) + 1, in the ticks t0 .. t1 where that row
  // lies strictly between rows 0 and H - 1 and the column in the slab. Its
  // descriptor (t0, t1, ring index but the row's, the row's index at tick
  // 0; glr index at tick 0) sits in shared memory after the rings, then
  // the block's facts (the ticks that step row H - 1, stage[0] ..
  // stage[1], and row 0, stage[2] .. stage[3]; those rows from base; the
  // slab's first column), then the values in flight.
  const int NJ = DRIVEN && WALLS ? 2 * d * RB : 0;
  int4* jobs = reinterpret_cast<int4*>(ring + (d + 2) * LS);
  long long* job_g = reinterpret_cast<long long*>(jobs + NJ);
  int* stage = reinterpret_cast<int*>(job_g + NJ);
  T* staged = reinterpret_cast<T*>(stage + 8);

  if constexpr (DRIVEN && WALLS) {
    if (tid == 0) {
      // levels 1 .. d step row x in the ticks t with
      // x + L - RB + 1 <= RB t <= x + L d
      const int x_hi = a.pin_hi - base, x_lo = a.pin_lo - base;
      stage[0] = b6_floor_div(x_hi + L, RB);
      stage[1] = b6_floor_div(x_hi + L * d, RB);
      stage[2] = a.pin_lo == a.pin_hi ? 1 : b6_floor_div(x_lo + L, RB);
      stage[3] = a.pin_lo == a.pin_hi ? 0 : b6_floor_div(x_lo + L * d, RB);
      stage[4] = x_hi;
      stage[5] = x_lo;
      stage[6] = c_lo;
    }
    if (tid < NJ) {
      const int p = tid >> 1, side = tid & 1;
      const int q = p / RB + 1, r = p - (q - 1) * RB;
      const int j = (side ? a.W - 1 : 0) - c_lo;
      const int x0 = r - L * q;  // its row at tick 0, from base
      // active ticks, then rows pin_lo < base + x0 + RB t < pin_hi
      int t0 = max((L + 1) * q / RB,
                   b6_floor_div(a.pin_lo - base - x0, RB) + 1);
      int t1 = min((rows + 2 * d - q - 1 + L * q) / RB,
                   b6_floor_div(a.pin_hi - base - x0 - 1, RB));
      if (j < 0 || j >= sw || (side == 0 && a.W == 1)) t1 = t0 - 1;
      jobs[tid] = make_int4(t0, t1, (q + 1) * LS + V + j, x0);
      job_g[tid] =
          ((long long)(a.s0 + q - 1) * (a.pin_hi + 1) + base + x0) * 2 +
          side;
#pragma unroll
      for (int t = 0; t < kB6Ahead; ++t) {
        if (t0 <= t && t <= t1) {
          cp_async<sizeof(T)>(staged + t * NJ + tid,
                              a.glr + job_g[tid] + 2 * RB * t);
        }
        cp_async_commit();
      }
    }
  }
  __syncthreads();

  // One tick, at phase PH of the unrolled loop: level q steps rows
  // base + RB t - L q .. + RB - 1. The load buffer PH mod PF holds level
  // 0's (and -1's) rows of this tick, fetched PF ticks before, and takes
  // those PF ticks ahead; each item keeps its window rows above and at its
  // first row (window rows K0, K0 + 1, mod NB) and loads the RB below,
  // whose last two it keeps for the next tick. Phases rename the rows and
  // buffers: no register moves, none of a buffer with loads in flight.
  auto run_tick = [&](auto phase, int t) {
    constexpr int PH = decltype(phase)::value;
    constexpr int K0 = (PH * RB) % NB;
    Buf& pu = bu[PH % PF];
    Buf& pp = bp[PH % PF];
    if (t < n_load) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        T* rp = ring + ((RB * t + r) & M) * P + V;
        T* ru = rp + LS;
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          const int j = tid + l * NT;
          if (j < sw) {
            ru[j] = pu[r][l];
            rp[j] = pp[r][l];
          }
        }
      }
    }
    fetch(t + PF, pu, pp);

    // the rows level d finished last tick, and level d - 1's same rows
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int o = RB * (t - 1) - (L + 1) * d + r;  // row of the band
      if (o >= 0 && o < rows) {
        const T* ou = ring + (d + 1) * LS + ((o + d) & M) * P + V;
        const T* op = ou - LS;
        const long long oo = out_off + (long long)o * a.W;
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          if (wok[l]) {
            const int j = tid + l * NT;
            a.out_u[oo + col[l]] = ou[j];
            a.out_up[oo + col[l]] = op[j];
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      const int q = lev[j], m = slot[j];
      slot[j] = (m + RB) & M;
      const unsigned f = flags[j];
      if (!(f >> 31)) continue;  // the whole warp is idle in this slot
      // the window's new rows: level q - 1, the RB below the item's first
      // row and the one below its last
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const T* src = ring + wofs[j] + ((m + 1 + r) & M) * P;
        T cv[V];
        if (q != 0) {
          B2Vec<T>::load(cv, src);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) cv[i] = T(0);
        }
        T left = __shfl_up_sync(0xffffffffu, cv[V - 1], 1);
        T right = __shfl_down_sync(0xffffffffu, cv[0], 1);
        if (q != 0 && (lane == 0 || (f & 1u))) left = src[-1];
        if (q != 0 && (lane == 31 || (f & 2u))) right = src[V];
        T(&nr)[V + 2] = win[(K0 + 2 + r) % NB][j];
        nr[0] = left;
#pragma unroll
        for (int i = 0; i < V; ++i) nr[i + 1] = cv[i];
        nr[V + 1] = right;
      }

      // active on the groups that hold a row of base + q .. base + rows +
      // 2 d - q - 1
      if (q != 0 && active(q, t)) {
        const T* prv = ring + wofs[j] - LS;
        T* dst = ring + wofs[j] + LS;
        const int R = base + RB * t - L * q;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          T pv[V], out[V];
          B2Vec<T>::load(pv, prv + ((m + r) & M) * P);
          const bool pin = WALLS && (R + r <= a.pin_lo || R + r >= a.pin_hi);
          b2_step<T, V, PAT, WALLS>(a, win[(K0 + r) % NB][j],
                                    win[(K0 + r + 1) % NB][j],
                                    win[(K0 + r + 2) % NB][j], pv, pin,
                                    f >> 2, out);
          B2Vec<T>::store(dst + ((m + r) & M) * P, out);
        }
      }
    }
    if constexpr (DRIVEN && WALLS) {
      // B6's wall stage: the items stored 0 on the pinned nodes; after
      // them, the nodes of columns 0 and W - 1 between rows 0 and H - 1
      // (the wall jobs), and the slab rows of rows 0 and H - 1, take their
      // substep's data
      __syncthreads();
      if (tid < NJ) {
        const int4 jd = jobs[tid];
        const long long g = job_g[tid];
        cp_async_wait<kB6Ahead - 1>();  // this tick's copy has landed
        const T v = staged[(t % (kB6Ahead + 1)) * NJ + tid];
        if (t >= jd.x && t <= jd.y) {
          ring[jd.z + ((jd.w + RB * t) & M) * P] = v;
        }
        const int tn = t + kB6Ahead;
        if (tn >= jd.x && tn <= jd.y) {
          cp_async<sizeof(T)>(staged + (tn % (kB6Ahead + 1)) * NJ + tid,
                              a.glr + g + 2 * RB * tn);
        }
        cp_async_commit();
      }
      const int4 rt = *reinterpret_cast<const int4*>(stage);
      const bool hi_now = t >= rt.x && t <= rt.y;
      const bool lo_now = t >= rt.z && t <= rt.w;
      if (hi_now || lo_now) {
        const int c = stage[6] + tid;
        if (tid < sw && c >= 0 && c < a.W) {
          // row H - 1 (over row 0 when they coincide), then row 0
#pragma unroll
          for (int k = 1; k >= 0; --k) {
            if (!(k ? hi_now : lo_now)) continue;
            const int x = stage[k ? 4 : 5];
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              // the level that steps row x in this tick, if any
              const int num = RB * t + r - x;
              const int q = num / L;
              if (num > 0 && num == q * L && q <= d && active(q, t)) {
                ring[(q + 1) * LS + (x & M) * P + V + tid] = __ldg(
                    a.gtb + ((size_t)(a.s0 + q - 1) * 2 + k) * a.W + c);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  };
  for (int t = 0; t < n_ticks; t += U) {
    b2_unrolled(std::make_integer_sequence<int, U>{}, [&](auto phase) {
      if (t + decltype(phase)::value < n_ticks) {
        run_tick(phase, t + decltype(phase)::value);
      }
    });
  }
}

template <typename T, int PAT, bool DRIVEN>
__global__ void __launch_bounds__(B2Shape<T>::kThreads,
                                  B2Shape<T>::kMinBlocks)
leapfrog_wavefront_kernel(const __grid_constant__ B2Params<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  // the slab's columns and its levels' rows hold a pinned node
  const int c_lo = blockIdx.x * a.tile_cols - a.depth;
  const int band0 = a.out_a + blockIdx.y * a.band_rows;
  const int rows = min(a.band_rows, a.out_a + a.out_h - band0);
  const bool walls = c_lo <= 0 || c_lo + a.slab_cols - 1 >= a.W - 1 ||
                     band0 - a.depth <= a.pin_lo ||
                     band0 + rows + a.depth - 1 >= a.pin_hi;
  if (walls) {
    leapfrog_wavefront_body<T, PAT, true, DRIVEN>(a, ring);
  } else {
    leapfrog_wavefront_body<T, PAT, false, DRIVEN>(a, ring);
  }
}

// One launch's blocks (ops/kernels.py multistep_slab mirrors the slab
// rule): the widest slab, a multiple of V columns, that the items
// (threads * items per thread / depth groups of V), kB2MaxSlab and the
// shared memory of one of the shape's blocks per SM allow, with a tile of
// at least 2 depth columns, else the whole block limit with a tile of at
// least one column; then as many strips as that slab needs, their tile
// evened out, and enough bands of rows to give every SM its blocks.
struct B2Launch {
  int slab_cols, tile_cols, band_rows, n_strips, n_bands;
  size_t smem;
};

template <typename T>
int b2_slab(int depth, int max_smem, size_t extra) {
  constexpr int v = B2Vec<T>::kV, minb = B2Shape<T>::kMinBlocks;
  const int cap = v * std::min(B2Shape<T>::kThreads * B2Shape<T>::kIPT /
                                   depth,
                               kB2MaxSlab / v);
  const long long level = (long long)(depth + 2) * B2Shape<T>::kRing *
                          sizeof(T);
  const long long budgets[2] = {
      max_smem / minb - (minb > 1 ? 1024 : 0) - (long long)extra,
      max_smem - (long long)extra};
  for (int k = 0; k < 2; ++k) {
    const int fit = (int)((budgets[k] / level - 2 * v) / v * v);
    const int sw = std::min(cap, fit);
    if (sw - 2 * depth >= (k == 0 ? 2 * depth : 1)) return sw;
  }
  return 0;
}

template <typename T>
B2Launch b2_launch(int depth, int W, int out_h, int max_smem, int n_sm,
                   size_t extra) {
  B2Launch g{};
  constexpr int v = B2Vec<T>::kV, minb = B2Shape<T>::kMinBlocks;
  const int sw_max = b2_slab<T>(depth, max_smem, extra);
  if (sw_max <= 0) return g;
  const int tw_max = sw_max - 2 * depth;
  const int fewest = (W + tw_max - 1) / tw_max;
  // of up to 4 more strips than the slab needs, the count whose blocks
  // (strips x bands, bands = the SMs' blocks / strips) fill most SMs
  const size_t smem_max = (size_t)(depth + 2) * B2Shape<T>::kRing *
                              b2_pitch(sw_max, v) * sizeof(T) +
                          extra;
  const int per_sm =
      smem_max <= (size_t)(max_smem / minb - (minb > 1 ? 1024 : 0)) ? minb
                                                                    : 1;
  int best = 0;
  for (int n = fewest; n <= fewest + 4 && n <= W; ++n) {
    const int blocks = n * std::max(1, per_sm * n_sm / n);
    if (blocks > best) {
      best = blocks;
      g.n_strips = n;
    }
  }
  g.tile_cols = (W + g.n_strips - 1) / g.n_strips;
  g.slab_cols = (g.tile_cols + 2 * depth + v - 1) / v * v;
  g.smem = (size_t)(depth + 2) * B2Shape<T>::kRing *
               b2_pitch(g.slab_cols, v) * sizeof(T) +
           extra;
  const int bands = std::max(1, per_sm * n_sm / g.n_strips);
  g.band_rows = std::max((out_h + bands - 1) / bands, depth);
  g.n_bands = (out_h + g.band_rows - 1) / g.band_rows;
  return g;
}

template <typename T, int PAT, bool DRIVEN>
cudaError_t launch_wavefront(const B2Params<T>& a, dim3 grid, size_t smem,
                             cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        leapfrog_wavefront_kernel<T, PAT, DRIVEN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  leapfrog_wavefront_kernel<T, PAT, DRIVEN>
      <<<grid, B2Shape<T>::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the instance of the stencil's zero pattern
template <typename T, bool DRIVEN>
cudaError_t launch_pattern(int pat, const B2Params<T>& a, dim3 grid,
                           size_t smem, cudaStream_t stream) {
  if (pat == kB2Cross) {
    return launch_wavefront<T, kB2Cross, DRIVEN>(a, grid, smem, stream);
  }
  if (pat == kB2NoAnti) {
    return launch_wavefront<T, kB2NoAnti, DRIVEN>(a, grid, smem, stream);
  }
  return launch_wavefront<T, kB2Full, DRIVEN>(a, grid, smem, stream);
}

// The pass's launches: depths as even as they can be (the first is the
// shallowest), the state between them in scratch (two pairs of
// (H + 2 keep) x W arrays, one pair when there are two launches), each
// launch's output covering the rows the later launches still step. B2
// keeps keep = n_steps - first depth rows beyond the array on each side (a
// row block of a taller grid steps them); B6 (gtb non-null) keeps none: its
// rows outside the array are 0 at every substep, so its launches chain on
// H x W pairs, and each reads its edge tables from its first substep.
template <typename T>
int launch_multistep(const void* u, const void* up, const void* gtb,
                     const void* glr, void* out_u, void* out_up,
                     void* scratch, int H, int W, const double* s,
                     double coef, int n_steps, int max_depth,
                     long long row_offset, long long n_rows,
                     cudaStream_t stream) {
  if (n_steps < 1 || max_depth < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return (int)e;
  const bool driven = gtb != nullptr;
  const int n = (n_steps + max_depth - 1) / max_depth;
  if (n > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int d0 = n_steps / n;  // the first launch, the shallowest
  const size_t plane = (size_t)(H + (driven ? 0 : 2 * (n_steps - d0))) * W;
  T* sp = static_cast<T*>(scratch);
  B2Params<T> a{};
  a.u = static_cast<const T*>(u);
  a.up = static_cast<const T*>(up);
  a.in_a = 0;
  a.in_h = H;
  a.W = W;
  // pinned rows: global row <= 0 or >= n_rows - 1, as local rows (every
  // row a pass touches lies within n_steps of the array)
  const long long lo = -row_offset, hi = n_rows - 1 - row_offset;
  const long long reach = (long long)H + n_steps + 1;
  a.pin_lo = (int)std::max(-reach, std::min(reach, lo));
  a.pin_hi = (int)std::max(-reach, std::min(reach, hi));
  for (int k = 0; k < 9; ++k) a.s[k] = T(s[k]);
  a.coef = T(coef);
  a.gtb = static_cast<const T*>(gtb);
  a.glr = static_cast<const T*>(glr);
  const bool anti = s[2] == 0.0 && s[6] == 0.0;
  const int pat = anti && s[0] == 0.0 && s[8] == 0.0
                      ? kB2Cross
                      : (anti ? kB2NoAnti : kB2Full);
  int done = 0;
  for (int i = 0; i < n; ++i) {
    const int d = (int)(((long long)n_steps * (i + 1)) / n - done);
    a.s0 = done;
    done += d;
    const int keep = driven ? 0 : n_steps - done;  // rows beyond the array
    const B2Launch g = b2_launch<T>(d, W, H + 2 * keep, max_smem, n_sm,
                                    driven ? b6_job_bytes<T>(d) : 0);
    // (B6's wall jobs take a thread each: 2 d RB <= threads)
    if (g.slab_cols <= 0 ||
        (driven && 2 * d * B2Shape<T>::kRows > B2Shape<T>::kThreads)) {
      return (int)cudaErrorInvalidValue;
    }
    a.depth = d;
    a.slab_cols = g.slab_cols;
    a.tile_cols = g.tile_cols;
    a.band_rows = g.band_rows;
    a.out_a = -keep;
    a.out_h = H + 2 * keep;
    if (i == n - 1) {
      a.out_u = static_cast<T*>(out_u);
      a.out_up = static_cast<T*>(out_up);
    } else {
      T* pair = sp + (size_t)(i & 1) * 2 * plane;
      a.out_u = pair;
      a.out_up = pair + plane;
    }
    const dim3 grid(g.n_strips, g.n_bands);
    e = driven ? launch_pattern<T, true>(pat, a, grid, g.smem, stream)
               : launch_pattern<T, false>(pat, a, grid, g.smem, stream);
    if (e != cudaSuccess) return (int)e;
    a.u = a.out_u;
    a.up = a.out_up;
    a.in_a = a.out_a;
    a.in_h = a.out_h;
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. Pointers are device pointers; s points to
// 9 host doubles (row-major 3x3 stencil).

// B3 on an array that is a block of a larger (NH, NW) grid whose node
// (ro, co) is the array's (0, 0): the walls are the global grid's.
int tw_constrained_apply_at(int dtype, const void* x, void* out, int H,
                            int W, const double* s, double diag, int diff,
                            int ro, int co, int NH, int NW, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_constrained_apply<float>(x, out, H, W, s, diag, diff, ro,
                                           co, NH, NW, st);
  }
  return launch_constrained_apply<double>(x, out, H, W, s, diag, diff, ro,
                                          co, NH, NW, st);
}

// B3 on the whole grid (offsets 0, the array's own shape).
int tw_constrained_apply(int dtype, const void* x, void* out, int H, int W,
                         const double* s, double diag, int diff,
                         void* stream) {
  return tw_constrained_apply_at(dtype, x, out, H, W, s, diag, diff, 0, 0, H,
                                 W, stream);
}

int tw_leapfrog_step(int dtype, const void* u, const void* up, void* out,
                     int H, int W, const double* s, double coef,
                     void* stream) {
  const dim3 block(32, 8);
  const dim3 grid = point_grid(H, W, block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    leapfrog_step_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(u), static_cast<const float*>(up),
        static_cast<float*>(out), H, W, load_stencil(s), (float)coef);
  } else {
    leapfrog_step_kernel<double><<<grid, block, 0, st>>>(
        static_cast<const double*>(u), static_cast<const double*>(up),
        static_cast<double*>(out), H, W, load_stencil(s), coef);
  }
  return (int)cudaGetLastError();
}

// n_steps steps in ceil(n_steps / max_depth) launches; scratch: two pairs
// of (H + 2 (n_steps - n_steps / n_launches)) x W arrays of the dtype (one
// pair for two launches, null for one).
int tw_leapfrog_multistep(int dtype, const void* u, const void* up,
                          void* out_u, void* out_up, void* scratch, int H,
                          int W, const double* s, double coef, int n_steps,
                          int max_depth, long long row_offset,
                          long long n_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = dtype == 0 ? launch_multistep<float> : launch_multistep<double>;
  return launch(u, up, nullptr, nullptr, out_u, out_up, scratch, H, W, s,
                coef, n_steps, max_depth, row_offset, n_rows, st);
}

// B6: gtb (n_steps, 2, W) bottom / top edge values per substep, glr
// (n_steps, H, 2) left / right edge values per substep; n_steps steps in
// ceil(n_steps / max_depth) launches; scratch: two pairs of H x W arrays of
// the dtype (one pair for two launches, null for one).
int tw_leapfrog_multistep_driven(int dtype, const void* u, const void* up,
                                 const void* gtb, const void* glr,
                                 void* out_u, void* out_up, void* scratch,
                                 int H, int W, const double* s, double coef,
                                 int n_steps, int max_depth, void* stream) {
  if (gtb == nullptr || glr == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = dtype == 0 ? launch_multistep<float> : launch_multistep<double>;
  return launch(u, up, gtb, glr, out_u, out_up, scratch, H, W, s, coef,
                n_steps, max_depth, 0, H, st);
}

int tw_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// Largest dynamic shared memory a block may opt in to on ``device``
// (bytes), or -1 on error.
int tw_max_dynamic_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}

}  // extern "C"
