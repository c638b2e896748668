// Hand-written Hopper (sm_90a) kernels of the FWI propagator.
//
// Four kernels, each a port of one Pallas TPU kernel of
// tpuwave/ops/pallas_varcoef.py, templated on float and double:
//
//   B14  varcoef_step               <- varcoef_leapfrog_step_pallas
//   B15  varcoef_multistep          <- varcoef_leapfrog_multistep_pallas
//   B16  varcoef_adjoint_step       <- varcoef_adjoint_step_pallas
//   B17  varcoef_adjoint_multistep  <- varcoef_adjoint_multistep_pallas
//
// All act on a row-major (H, W) vertex grid at its true shape and on
// (n, H, W) plane stacks. The stencil is the variable-coefficient 7-plane
// one of ops/kernels_varcoef.py: (K u)[I] = sum_j planes[j][I] * u[I + d_j]
// with d_j = (dx, dy) in OFFSETS order (0,0) (-1,0) (1,0) (0,-1) (-1,-1)
// (0,1) (1,1), summed in that order. A node is PINNED when its row is <= 0
// or >= H - 1 or its column is <= 0 or >= W - 1; pinned nodes come out 0
// in every updated field, and nodes outside the array read as 0 (nothing
// wraps).
//
// Plain C interface, bound from Python with ctypes (ops/kernels_varcoef.py).
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 = success).
// Nothing is reduced across threads (B17 marks its receiver nodes with
// integer atomicOr, whose result does not depend on the order), so reruns
// are bitwise equal.

#include "grid_common.cuh"

namespace {

__device__ __forceinline__ int off_dx(int j) {
  return (j == 1 || j == 4) ? -1 : ((j == 2 || j == 6) ? 1 : 0);
}

__device__ __forceinline__ int off_dy(int j) {
  return (j == 3 || j == 4) ? -1 : ((j == 5 || j == 6) ? 1 : 0);
}

// ---------------------------------------------------------------------------
// B14: one leapfrog step.
//   undamped: u' = 2u - u_prev - coef * K u
//   damped:   u' = (2u - dnum * u_prev - coef * K u) * dden
//
// Bound on this card: memory. It reads 9 arrays (11 damped) and writes 1
// (40 B per node in f32, 48 damped: 42.0 / 50.4 MB at 1025^2, 12.5 / 15.0
// us at 3.35 TB/s) for ~17 (19) operations per node. One thread per node,
// 32x8 blocks: a warp reads 32 consecutive addresses of every plane, and
// the neighbours of u come from L1/L2 after their first touch. What a node
// alone reads (u_prev, the 7 planes, dnum, dden) is read once, so it is
// loaded evict-first (__ldcs) and leaves the L2 before other lines; u,
// which neighbours read again, stays __ldg (52-60% of the bound by device
// time without the hint, 55-63% with it). u and u_prev may be one array (the
// half start passes u0 as both): both are only read. B16's register column
// march, with the same hint, was no faster here, and slower in the FWI
// loop, where these inputs are warm.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void varcoef_step_kernel(const T* __restrict__ u,
                                    const T* __restrict__ up,
                                    const T* __restrict__ planes,
                                    const T* __restrict__ dnum,
                                    const T* __restrict__ dden,
                                    T* __restrict__ out, int H, int W,
                                    T coef) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= H || c >= W) return;
  const long long i = (long long)r * W + c;
  if (is_pinned(r, c, H, W)) {
    out[i] = T(0);
    return;
  }
  const long long n = (long long)H * W;
  const T uc = __ldg(u + i);
  T ku = __ldcs(planes + i) * uc;
#pragma unroll
  for (int j = 1; j < 7; ++j) {
    ku += __ldcs(planes + j * n + i) *
          __ldg(u + i + (long long)off_dy(j) * W + off_dx(j));
  }
  if (dnum == nullptr) {
    out[i] = (T(2) * uc - __ldcs(up + i)) - coef * ku;
  } else {
    out[i] = ((T(2) * uc - __ldcs(dnum + i) * __ldcs(up + i)) - coef * ku) *
             __ldcs(dden + i);
  }
}

// The K stencil on a window, in OFFSETS order (0,0) (-1,0) (1,0) (0,-1)
// (-1,-1) (0,1) (1,1) as (dx, dy).
template <typename T, int SX>
__device__ __forceinline__ T window_k(const T* __restrict__ p,
                                      const Window<T, SX>& w) {
  T acc = p[0] * w.mid.v[1];
  acc += p[1] * w.mid.v[0];
  acc += p[2] * w.mid.v[2];
  acc += p[3] * w.up.v[1];
  acc += p[4] * w.up.v[0];
  acc += p[5] * w.down.v[1];
  acc += p[6] * w.down.v[2];
  return acc;
}

// ---------------------------------------------------------------------------
// B16: one backward step of the time-reversal adjoint (hard walls).
//   blam     = mask0(lam_next)
//   lam_cur  = mask0(lam_partial + 2 blam - coef * K blam)
//   u_prev   = mask0(2 u_cur - u_next - coef * K u_cur)
//   lpart'   = -blam
//   wbar[j] -= coef * blam * u_cur[I + d_j]      (in place)
//
// Bound on this card: memory. It reads 18 grids and writes 10 (112 B per
// node in f32: 117.7 MB at 1025^2, 35.1 us at 3.35 TB/s) for ~49
// operations per node.
//
// A register column march: each warp owns a strip of 32 columns over a
// band of rows and walks down the band one row a step, a lane per column.
// u_cur and blam arrive as 3-row register windows: a lane loads its own
// column's value of a row, its left and right neighbours come from the
// neighbouring lanes by warp shuffles, and lanes 0 and 31 load the one
// value beyond the strip on their side. blam is masked once, when its row
// is loaded, so no neighbour is tested for the mask. The windows' rows are
// loaded two rows ahead of the row computed, and the node's 16 own values
// (u_next, lam_partial, the 7 planes and the 7 wbar) one row ahead, so a
// warp keeps them in flight across a row's arithmetic. Only a warp whose
// strip or band, with its one-node halo, reaches a pinned node or the
// array's edge runs the instance that tests for them. The bands are as
// many as fit one wave of resident warps (adjoint_step_band, at least
// kAdjMinBand rows high). Each node's seven wbar values belong to its own
// lane, read and written in place: no atomics, reruns are bitwise equal.
// (The first version ran one thread per node in 32 x 8 blocks, with 12
// neighbour loads through L1 and a four-compare mask test on each of its
// six lam neighbours: 44-48% of the bound.)
// ---------------------------------------------------------------------------
constexpr int kAdjWarps = 4;     // warps of a block, a (strip, band) each
constexpr int kAdjMinBand = 8;   // rows of a band, at least

// one row of a lane's column: u_cur, blam, and (lanes 0 and 31) the values
// one column beyond the strip
template <typename T>
struct AdjRow {
  T u, l, ue, le;
};

// a node's own values
template <typename T>
struct AdjOwn {
  T un, lp, p[7], w[7];
};

template <typename T, bool WALLS>
__device__ __forceinline__ AdjRow<T> adj_fetch(const T* __restrict__ uc,
                                               const T* __restrict__ lamn,
                                               int gr, int gc, int ec,
                                               bool edge, int H, int W) {
  AdjRow<T> x;
  if (WALLS) {
    const bool row_in = gr >= 0 && gr < H;
    const bool in = row_in && gc < W;
    const bool ein = edge && row_in && ec >= 0 && ec < W;
    const size_t g = in ? (size_t)gr * W + gc : 0;
    const size_t e = ein ? (size_t)gr * W + ec : 0;
    x.u = in ? __ldg(uc + g) : T(0);
    x.l = is_pinned(gr, gc, H, W) ? T(0) : __ldg(lamn + g);
    x.ue = ein ? __ldg(uc + e) : T(0);
    x.le = (edge && !is_pinned(gr, ec, H, W)) ? __ldg(lamn + e) : T(0);
  } else {
    const size_t g = (size_t)gr * W + gc, e = (size_t)gr * W + ec;
    x.u = __ldg(uc + g);
    x.l = __ldg(lamn + g);
    x.ue = edge ? __ldg(uc + e) : T(0);
    x.le = edge ? __ldg(lamn + e) : T(0);
  }
  return x;
}

// a fetched row into the windows' rows (every lane of the warp calls it)
template <typename T>
__device__ __forceinline__ void adj_spread(const AdjRow<T>& x, int lane,
                                           Row3<T>& u3, Row3<T>& l3) {
  const T ul = __shfl_up_sync(0xffffffffu, x.u, 1);
  const T ur = __shfl_down_sync(0xffffffffu, x.u, 1);
  const T ll = __shfl_up_sync(0xffffffffu, x.l, 1);
  const T lr = __shfl_down_sync(0xffffffffu, x.l, 1);
  u3.v[0] = lane == 0 ? x.ue : ul;
  u3.v[1] = x.u;
  u3.v[2] = lane == 31 ? x.ue : ur;
  l3.v[0] = lane == 0 ? x.le : ll;
  l3.v[1] = x.l;
  l3.v[2] = lane == 31 ? x.le : lr;
}

// the node's own values, when it is updated (inside the array, not pinned)
template <typename T>
__device__ __forceinline__ AdjOwn<T> adj_own(const T* __restrict__ un,
                                             const T* __restrict__ lpart,
                                             const T* __restrict__ planes,
                                             const T* wbar, size_t g,
                                             size_t n, bool need) {
  AdjOwn<T> o;
  o.un = need ? __ldg(un + g) : T(0);
  o.lp = need ? __ldg(lpart + g) : T(0);
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    o.p[j] = need ? __ldg(planes + j * n + g) : T(0);
  }
#pragma unroll
  for (int j = 0; j < 7; ++j) o.w[j] = need ? wbar[j * n + g] : T(0);
  return o;
}

template <typename T, bool WALLS>
__device__ __forceinline__ void adjoint_march(
    const T* __restrict__ un, const T* __restrict__ uc,
    const T* __restrict__ lamn, const T* __restrict__ lpart,
    const T* __restrict__ planes, T* wbar, T* __restrict__ out_up,
    T* __restrict__ out_lc, T* __restrict__ out_lp, int H, int W, int gc,
    int lane, int ra, int rb, T coef) {
  const size_t n = (size_t)H * W;
  const bool edge = lane == 0 || lane == 31;
  const int ec = lane == 0 ? gc - 1 : gc + 1;
  const bool col_in = !WALLS || gc < W;
  const bool col_pin = WALLS && (gc == 0 || gc >= W - 1);
  auto fetch = [&](int gr) {
    return adj_fetch<T, WALLS>(uc, lamn, gr, gc, ec, edge, H, W);
  };
  // rows ra .. rb - 1: the node of row gr is updated when it is inside
  // the array and not pinned
  auto updated = [&](int gr) {
    return col_in && !(col_pin || (WALLS && (gr == 0 || gr == H - 1)));
  };
  auto own = [&](int gr) {
    return adj_own(un, lpart, planes, wbar, (size_t)gr * W + gc, n,
                   gr < rb && updated(gr));
  };
  Window<T, 1> uw, lw;
  adj_spread(fetch(ra - 1), lane, uw.up, lw.up);
  adj_spread(fetch(ra), lane, uw.mid, lw.mid);
  AdjRow<T> down = fetch(ra + 1);
  AdjOwn<T> cur = own(ra);
  for (int gr = ra; gr < rb; ++gr) {
    // two rows ahead for the windows, one for the node's own values
    AdjRow<T> far = {};
    if (gr + 2 <= rb) far = fetch(gr + 2);
    const AdjOwn<T> nxt = own(gr + 1);
    adj_spread(down, lane, uw.down, lw.down);
    if (col_in) {
      const size_t g = (size_t)gr * W + gc;
      if (updated(gr)) {
        const T bl = lw.mid.v[1], ucv = uw.mid.v[1];
        const T kb = window_k(cur.p, lw);
        const T ku = window_k(cur.p, uw);
        out_lc[g] = (cur.lp + T(2) * bl) - coef * kb;
        out_up[g] = (T(2) * ucv - cur.un) - coef * ku;
        out_lp[g] = -bl;
        const T mu = coef * bl;
        const T sh[7] = {ucv,        uw.mid.v[0],  uw.mid.v[2], uw.up.v[1],
                         uw.up.v[0], uw.down.v[1], uw.down.v[2]};
#pragma unroll
        for (int j = 0; j < 7; ++j) wbar[j * n + g] = cur.w[j] - mu * sh[j];
      } else {
        // blam = 0 here: wbar keeps its value
        out_up[g] = T(0);
        out_lc[g] = T(0);
        out_lp[g] = -T(0);
      }
    }
    uw.advance();
    lw.advance();
    down = far;
    cur = nxt;
  }
}

// blocks of B16 per SM that its registers must allow, per dtype (f32: 5,
// at most 102 registers a thread, where ptxas fits it without spilling:
// 54.0 against 55.9 us at 1025^2 with 4; f64 keeps its 152)
template <typename T>
constexpr int kAdjMinBlocks = sizeof(T) == 4 ? 5 : 3;

template <typename T>
__global__ void __launch_bounds__(32 * kAdjWarps, kAdjMinBlocks<T>)
varcoef_adjoint_step_kernel(
    const T* __restrict__ un, const T* __restrict__ uc,
    const T* __restrict__ lamn, const T* __restrict__ lpart,
    const T* __restrict__ planes, T* wbar, T* __restrict__ out_up,
    T* __restrict__ out_lc, T* __restrict__ out_lp, int H, int W, int band,
    int n_strips, int n_units, T coef) {
  // (strip, band) units in strip order, a warp each
  const int unit = blockIdx.x * kAdjWarps + threadIdx.y;
  if (unit >= n_units) return;
  const int lane = threadIdx.x;
  const int c0 = (unit % n_strips) * 32;
  const int ra = (unit / n_strips) * band;
  const int rb = min(ra + band, H);
  // the rows ra - 1 .. rb and columns c0 - 1 .. c0 + 32 that the warp
  // reads hold a pinned node or reach past the array
  const bool walls = ra < 2 || rb > H - 2 || c0 < 2 || c0 + 32 > W - 2;
  if (walls) {
    adjoint_march<T, true>(un, uc, lamn, lpart, planes, wbar, out_up, out_lc,
                           out_lp, H, W, c0 + lane, lane, ra, rb, coef);
  } else {
    adjoint_march<T, false>(un, uc, lamn, lpart, planes, wbar, out_up,
                            out_lc, out_lp, H, W, c0 + lane, lane, ra, rb,
                            coef);
  }
}

// The height of B16's bands: as many bands of 32-column strips as one
// wave of the card's resident warps holds, each at least kAdjMinBand rows
// high where H allows, so that every warp starts at once and none waits
// for a second wave. Returns -cudaError when the card cannot be queried.
template <typename T>
int adjoint_step_band(int H, int W) {
  const int blocks =
      resident_blocks(varcoef_adjoint_step_kernel<T>, 32 * kAdjWarps);
  if (blocks < 0) return blocks;
  const long long warps = (long long)blocks * kAdjWarps;
  const long long most = H / kAdjMinBand > 1 ? H / kAdjMinBand : 1;
  long long bands = warps / ((W + 31) / 32);
  bands = bands < 1 ? 1 : (bands > most ? most : bands);
  return (int)((H + bands - 1) / bands);
}

template <typename T>
int launch_adjoint_step(const void* un, const void* uc, const void* lamn,
                        const void* lpart, const void* planes, void* wbar,
                        void* out_up, void* out_lc, void* out_lp, int H,
                        int W, int band, double coef, cudaStream_t stream) {
  if (band < 1) return (int)cudaErrorInvalidValue;
  const int n_strips = (W + 31) / 32;
  const long long n_units = (long long)n_strips * ((H + band - 1) / band);
  if (n_units >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_units + kAdjWarps - 1) / kAdjWarps);
  varcoef_adjoint_step_kernel<T><<<blocks, dim3(32, kAdjWarps), 0, stream>>>(
      static_cast<const T*>(un), static_cast<const T*>(uc),
      static_cast<const T*>(lamn), static_cast<const T*>(lpart),
      static_cast<const T*>(planes), static_cast<T*>(wbar),
      static_cast<T*>(out_up), static_cast<T*>(out_lc),
      static_cast<T*>(out_lp), H, W, band, n_strips, (int)n_units, (T)coef);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B15: n_steps forward steps in one pass (temporal blocking).
//
// Each block covers a kSide x kSide slab: its tile (side kSide - 2 (n_steps
// + 1)) plus a halo of n_steps + 1 nodes, so that after n_steps steps the
// tile and one ring around it are exact: the ring lets the block that owns
// a receiver's first point read the other points of its triangle. A pass
// of n_steps is split into launches of at most 8 steps
// (ops/kernels_varcoef.py fused_chunks), so the halo's share stays bounded. After every step:
//   - the source node gets wchunk[s] * coef (times dden = p2 / 2 at the
//     source when damped) after the mask, in every block whose slab holds
//     it, so no halo goes stale;
//   - each receiver's sample is written by the block that owns its first
//     point, summed over its points in point order;
//   - with a ring, rows rA / rB and cols cA / cB of the tile are saved.
// Damped (9 planes): [0:7] dden-folded stencil, [7] p2 = 2 dden,
// [8] pm = dden dnum; u' = p2 u - pm u_prev - coef K' u.
//
// Bound on this card: device memory (9, damped 11, reads and 2 writes per
// node per pass). A thread owns kRows consecutive slab rows of one column
// for all the steps and keeps in registers what only its own nodes read:
// the NP planes, u_prev, and its pin, source, tile and ring bits, all
// computed or loaded once (every load of the thread is issued before the
// first store). Shared memory holds only u_cur, which neighbours read,
// double buffered (one barrier per step); a thread walks its rows with a
// sliding 3x3 register window (three shared loads per node and step). Every
// step updates all the slab's nodes with no test of which are still exact
// (a node at distance d from the slab edge is exact after step s when
// d >= s, and the others feed only nodes that are not exact either); the
// mask and the source are selects. The tile's outputs and the ring saves
// are written from registers. (The first version staged u, u_prev and
// the planes in shared memory, re-mapped 32 x 16 threads onto the
// shrinking slab every step with a pin test per node, and read ~16 values
// of shared memory per node and step: 11-14% of the bound.)
// ---------------------------------------------------------------------------
template <typename T, int NP>
struct MultistepGeometry;
// kSide x (kSide / kRows) threads, one block per SM; the registers a thread
// keeps grow with kRows x NP. Each is the fastest of the shapes tried at
// 1025^2 f32 and 513^2 f64, k = 8, undamped and damped (3 to 16 rows per
// thread, 32- to 72-node slabs): a shape that makes ptxas spill loses more
// than fewer warps per SM cost (chip_smoke.py prints each kernel's
// registers and spills). ops/kernels_varcoef.py _MULTISTEP_SIDE repeats
// kSide for the tests' tile placement; launch_multistep refuses another.
template <int NP>
struct MultistepGeometry<float, NP> {
  static constexpr int kSide = 60, kRows = 6;
};
template <int NP>
struct MultistepGeometry<double, NP> {
  static constexpr int kSide = 48, kRows = 6;
};

template <typename T, int NP>
__global__ void __launch_bounds__(
    MultistepGeometry<T, NP>::kSide *
    (MultistepGeometry<T, NP>::kSide / MultistepGeometry<T, NP>::kRows))
varcoef_multistep_kernel(
    const T* __restrict__ u, const T* __restrict__ up,
    const T* __restrict__ planes, const T* __restrict__ wchunk,
    int n_steps, int src_r, int src_c, const int* __restrict__ rec_r,
    const int* __restrict__ rec_c, const T* __restrict__ rec_w, int n_rec,
    int per, int ra, int rb, int ca, int cb, T* __restrict__ out_u,
    T* __restrict__ out_up, T* __restrict__ traces,
    T* __restrict__ ring_rows, T* __restrict__ ring_cols, int H, int W,
    T coef, int tile) {
  constexpr int S = MultistepGeometry<T, NP>::kSide;
  constexpr int R = MultistepGeometry<T, NP>::kRows;
  constexpr int nth = S * (S / R);
  // a buffer holds the slab with one spare row above and below and one
  // spare value at each end: slab node s sits at kPad + s
  constexpr int kPad = S + 1;
  constexpr int SB = S * S + 2 * kPad;
  constexpr bool damped = NP == 9;
  static_assert(R <= 16, "ring_bits holds 4 bits for each of <= 16 rows");
  __shared__ T buf[2 * SB];
  const int halo = n_steps + 1;
  const int ir0 = blockIdx.y * tile, ic0 = blockIdx.x * tile;  // tile origin
  const int r0 = ir0 - halo, c0 = ic0 - halo;  // array row/col of slab (0,0)
  const int sc = threadIdx.x, sr0 = threadIdx.y * R;
  const int gc = c0 + sc;
  const int tid = threadIdx.y * S + threadIdx.x;
  const int base = kPad + sr0 * S + sc;  // the thread's first node
  const long long n = (long long)H * W;

  for (int q = tid; q < 2 * kPad; q += nth) {
    // the spare values (read only by nodes whose result is never used)
    T* b = buf + (q / kPad) * SB;
    const int j = q % kPad;
    b[j] = T(0);
    b[SB - 1 - j] = T(0);
  }

  // staging: every load of the thread is started before the first use
  const bool col_in = gc >= 0 && gc < W;
  const bool col_tile = sc >= halo && sc < halo + tile && gc < W;
  T pl[R][NP], prv[R], u0[R];
  unsigned pin_bits = 0, tile_bits = 0, src_bits = 0;
  unsigned long long ring_bits = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int sr = sr0 + i, gr = r0 + sr;
    const bool in = col_in && gr >= 0 && gr < H;
    const long long g = in ? (long long)gr * W + gc : 0;
    const bool t = col_tile && sr >= halo && sr < halo + tile && gr < H;
    u0[i] = in ? __ldg(u + g) : T(0);
    prv[i] = in ? __ldg(up + g) : T(0);
#pragma unroll
    for (int p = 0; p < NP; ++p) pl[i][p] = in ? __ldg(planes + p * n + g) : T(0);
    pin_bits |= (unsigned)is_pinned(gr, gc, H, W) << i;
    tile_bits |= (unsigned)t << i;
    src_bits |= (unsigned)(gr == src_r && gc == src_c) << i;
    if (ring_rows != nullptr && t) {
      const unsigned long long bits =
          (unsigned)(gr == ra) | (unsigned)(gr == rb) << 1 |
          (unsigned)(gc == ca) << 2 | (unsigned)(gc == cb) << 3;
      ring_bits |= bits << (4 * i);
    }
  }
  const T ssel =
      damped ? coef * (T(0.5) * __ldg(planes + 7 * n + (long long)src_r * W +
                                      src_c))
             : coef;
#pragma unroll
  for (int i = 0; i < R; ++i) buf[base + i * S] = u0[i];
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    const T* __restrict__ cur = buf + (step & 1) * SB;
    T* nxt = buf + (SB - (step & 1) * SB);
    const T ws = __ldg(wchunk + step) * ssel;
    const bool last = step == n_steps - 1;
    Window<T, S> w;
    w.start(cur, base);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int q = base + i * S;
      w.next_row(cur, q);
      const T c = w.mid.v[1];
      const T ku = window_k(pl[i], w);
      T v = damped ? (pl[i][7] * c - pl[i][8] * prv[i]) - coef * ku
                   : (T(2) * c - prv[i]) - coef * ku;
      v = ((pin_bits >> i) & 1u) ? T(0) : v;
      v = ((src_bits >> i) & 1u) ? v + ws : v;
      prv[i] = c;
      nxt[q] = v;
      const int gr = r0 + sr0 + i;
      if (last && ((tile_bits >> i) & 1u)) {
        const long long g = (long long)gr * W + gc;
        out_u[g] = v;
        out_up[g] = c;
      }
      const unsigned rbits = (unsigned)(ring_bits >> (4 * i)) & 15u;
      if (rbits != 0u) {
        if (rbits & 1u) ring_rows[((long long)step * 2) * W + gc] = v;
        if (rbits & 2u) ring_rows[((long long)step * 2 + 1) * W + gc] = v;
        if (rbits & 4u) ring_cols[((long long)step * H + gr) * 2] = v;
        if (rbits & 8u) ring_cols[((long long)step * H + gr) * 2 + 1] = v;
      }
      w.advance();
    }
    __syncthreads();
    // nxt is read below and written again only after the next barrier
    for (int q = tid; q < n_rec; q += nth) {
      const int p0 = q * per;
      const int ar = __ldg(rec_r + p0), ac = __ldg(rec_c + p0);
      if (ar < ir0 || ar >= ir0 + tile || ac < ic0 || ac >= ic0 + tile) {
        continue;
      }
      T acc = __ldg(rec_w + p0) * nxt[kPad + (ar - r0) * S + (ac - c0)];
      for (int j = 1; j < per; ++j) {
        acc += __ldg(rec_w + p0 + j) *
               nxt[kPad + (__ldg(rec_r + p0 + j) - r0) * S +
                   (__ldg(rec_c + p0 + j) - c0)];
      }
      traces[(long long)step * n_rec + q] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// B17: n_steps backward steps in one pass, in time-descending order.
//
// Step s, with (A, B) = (u_next, u_cur):
//   wavbar[s] = coef * lam[src]          (before the update; written by the
//                                         block that owns src, halo copies
//                                         do not write it)
//   blam      = mask0(lam)                (damped: mask0(dden * lam))
//   lam'      = mask0(lpart + 2 blam - coef K blam) + inj[s] at the points
//   u_prev    = mask0(2 B - A - coef K B) + coef * wchunk[s] at src
//   ring:       u_prev = 0 strictly outside [rA..rB] x [cA..cB], then cols
//               cA, cB and rows rA, rB restored from the saves (halo rows
//               too)
//   wbar[j]  -= coef * blam * B[I + d_j]  (the tile's nodes only)
//   (A, B, lam, lpart) <- (B, u_prev, lam', -blam)   (damped: -dnum blam)
// Damped: 9 planes, [0:7] plain stencil, [7] dden, [8] dnum.
//
// Bound on this card: device memory (18, damped 20, reads and 11 writes
// per node per pass). What bounds it is less plain: a block (one per SM,
// by its registers) stages, steps and stores in turn, and the steps are
// the largest part (scripts/torch_b17_phases.py times each phase per
// block).
//
// Each block covers a kSide x kSide slab: its tile (side kSide - 2 n_steps)
// plus an n_steps halo, so the halo's share grows with n_steps; the wrapper
// (ops/kernels_varcoef.py fused_chunks) launches at most 8 steps at a
// time. A thread owns kRows consecutive slab rows of one column for all the
// steps, and keeps in registers what only its own nodes read: the 7 (9)
// planes, lpart and, on tile nodes, the seven wbar accumulators, all loaded
// once. Shared memory holds only what neighbours read, double buffered (one
// barrier per step): u_cur, and blam already masked (damped: times dden),
// formed by the node's owner when it writes lam', so no neighbour is tested
// for the mask. u_next is u_cur of the step before, so it is read from the
// buffer the step is about to overwrite, at the thread's own node. A thread
// walks its rows with a sliding 3x3 register window per array (three new
// shared loads per array and row); the correlations come from the same
// window. Every step updates all the slab's nodes, with no test of which are
// still exact and no branch in the row loop (the source is a select, the
// correlations of nodes off the tile are computed and never stored), so the
// compiler can interleave a thread's rows; the receiver cotangents are added
// after the loop, in point order, on the few nodes that hold a point: lam'
// keeps them on a pinned node, while the staged blam there is 0. The tile's
// outputs are written from registers at the last step. (The first version
// staged all five fields and the planes in 12 slabs, re-mapped threads onto
// the shrinking slab every step, tested the mask of each neighbour, and
// injected receivers on one thread between two barriers per step: 9-15% of
// the bound.)
// ---------------------------------------------------------------------------
template <typename T>
struct AdjointGeometry;

#ifdef TW_B17_STAMPS
// Built with -DTW_B17_STAMPS (scripts/torch_b17_phases.py), every block of
// B17 records the card's %globaltimer at its start, after staging, after
// its steps and at its end; tw_b17_stamps copies them to the host.
__device__ unsigned long long g_b17_stamps[16384][4];
__device__ __forceinline__ unsigned long long b17_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TW_B17_STAMP(name) const unsigned long long name = b17_timer()
#else
#define TW_B17_STAMP(name)
#endif
// kSide x (kSide / kRows) threads; the registers a thread keeps grow with
// kRows, the slab's redundant halo work shrinks with kSide (48 x 16 f32
// threads take 80 registers, 32 x 16 f64 threads 128: one block per SM)
template <>
struct AdjointGeometry<float> {
  static constexpr int kSide = 48, kRows = 3;
  static constexpr int kThreads = kSide * kSide / kRows;
};
template <>
struct AdjointGeometry<double> {
  static constexpr int kSide = 32, kRows = 2;
  static constexpr int kThreads = kSide * kSide / kRows;
};

// A shared buffer holds the slab with one spare row above and below and one
// spare value at each end, so the neighbours of every slab node, the
// outermost included, lie inside it: slab node s sits at kPad + s.
template <typename T>
struct AdjointBuffer {
  static constexpr int kS = AdjointGeometry<T>::kSide;
  static constexpr int kPad = kS + 1;
  static constexpr int kSize = kS * kS + 2 * kPad;
};

// u_cur and the masked blam, double buffered, and one bit per slab node
template <typename T>
constexpr size_t adjoint_smem() {
  constexpr int S2 = AdjointGeometry<T>::kSide * AdjointGeometry<T>::kSide;
  return 4 * (size_t)AdjointBuffer<T>::kSize * sizeof(T) +
         (size_t)((S2 + 31) / 32) * 4;
}

template <typename T, int NP>
__global__ void __launch_bounds__(AdjointGeometry<T>::kThreads)
varcoef_adjoint_multistep_kernel(
    const T* __restrict__ un, const T* __restrict__ uc,
    const T* __restrict__ lam, const T* __restrict__ lpart,
    const T* __restrict__ planes, T* __restrict__ wbar,
    const T* __restrict__ wchunk, const T* __restrict__ inj, int n_steps,
    int src_r, int src_c, const int* __restrict__ pt_r,
    const int* __restrict__ pt_c, int n_pts, int ra, int rb, int ca, int cb,
    const T* __restrict__ ring_rows, const T* __restrict__ ring_cols,
    T* __restrict__ out_un, T* __restrict__ out_uc, T* __restrict__ out_lam,
    T* __restrict__ out_lp, T* __restrict__ wavbar, int H, int W, T coef,
    int tile) {
  TW_B17_STAMP(t0);
  constexpr int S = AdjointGeometry<T>::kSide;
  constexpr int R = AdjointGeometry<T>::kRows;
  constexpr int S2 = S * S;
  constexpr int nth = AdjointGeometry<T>::kThreads;
  constexpr int SB = AdjointBuffer<T>::kSize;
  constexpr bool damped = NP == 9;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Bs = reinterpret_cast<T*>(smem_raw);   // u_cur, two buffers
  T* Ls = Bs + 2 * SB;                      // masked blam, two buffers
  unsigned* marks = reinterpret_cast<unsigned*>(Ls + 2 * SB);  // points
  const int halo = n_steps;
  const int ir0 = blockIdx.y * tile, ic0 = blockIdx.x * tile;
  const int r0 = ir0 - halo, c0 = ic0 - halo;  // array row/col of slab (0,0)
  const int sc = threadIdx.x, sr0 = threadIdx.y * R;
  const int gc = c0 + sc;
  const int tid = threadIdx.y * S + threadIdx.x;
  const int base = AdjointBuffer<T>::kPad + sr0 * S + sc;  // first node
  const long long n = (long long)H * W;

  for (int q = tid; q < (S2 + 31) / 32; q += nth) marks[q] = 0u;
  for (int q = tid; q < 4 * AdjointBuffer<T>::kPad; q += nth) {
    // the spare values (read only by nodes whose result is never used)
    const int b = q / AdjointBuffer<T>::kPad, j = q % AdjointBuffer<T>::kPad;
    T* buf = Bs + b * SB;
    buf[j] = T(0);
    buf[SB - 1 - j] = T(0);
  }

  // staging: every load of the thread is started before the first use
  const bool col_in = gc >= 0 && gc < W;
  const bool col_tile = sc >= halo && sc < halo + tile;
  T pl[R][NP], lp[R], wacc[R][7], a0[R], b0[R], l0[R];
  unsigned pin_bits = 0, tile_bits = 0, src_bits = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int sr = sr0 + i, gr = r0 + sr;
    const bool in = col_in && gr >= 0 && gr < H;
    const long long g = in ? (long long)gr * W + gc : 0;
    const bool t = in && col_tile && sr >= halo && sr < halo + tile;
    a0[i] = in ? __ldg(un + g) : T(0);
    b0[i] = in ? __ldg(uc + g) : T(0);
    l0[i] = in ? __ldg(lam + g) : T(0);
    lp[i] = in ? __ldg(lpart + g) : T(0);
#pragma unroll
    for (int p = 0; p < NP; ++p) pl[i][p] = in ? __ldg(planes + p * n + g) : T(0);
#pragma unroll
    for (int j = 0; j < 7; ++j) wacc[i][j] = t ? wbar[j * n + g] : T(0);
    pin_bits |= (unsigned)is_pinned(gr, gc, H, W) << i;
    tile_bits |= (unsigned)t << i;
    src_bits |= (unsigned)(gr == src_r && gc == src_c) << i;
  }
  // the raw lam at src, for wavbar (its owner thread only)
  T lam_src = T(0);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int q = base + i * S;
    const bool pin = (pin_bits >> i) & 1u;
    Bs[q] = b0[i];
    Bs[SB + q] = a0[i];  // u_next: read at step 0 from the buffer it writes
    Ls[q] = pin ? T(0) : (damped ? pl[i][7] * l0[i] : l0[i]);
    if ((src_bits >> i) & 1u) lam_src = l0[i];
  }
  __syncthreads();  // marks cleared
  for (int p = tid; p < n_pts; p += nth) {
    const int sr = __ldg(pt_r + p) - r0, scc = __ldg(pt_c + p) - c0;
    if (sr >= 0 && sr < S && scc >= 0 && scc < S) {
      const int q = sr * S + scc;
      atomicOr(marks + (q >> 5), 1u << (q & 31));
    }
  }
  __syncthreads();  // slabs staged, points marked
  TW_B17_STAMP(t1);
  unsigned pt_bits = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int q = (sr0 + i) * S + sc;
    pt_bits |= ((marks[q >> 5] >> (q & 31)) & 1u) << i;
  }
  const bool owner = src_r >= ir0 && src_r < ir0 + tile && src_c >= ic0 &&
                     src_c < ic0 + tile;

  // Every step updates all the thread's nodes without a test: a node at
  // distance d from the slab edge is exact after step s when d > s, and
  // the nodes that are not only feed nodes that are not either, so their
  // values are never used. The tile (d >= n_steps) is exact at the end.
  for (int step = 0; step < n_steps; ++step) {
    const int cur = (step & 1) * SB, nxt = SB - cur;
    const T* __restrict__ Bc = Bs + cur;
    const T* __restrict__ Lc = Ls + cur;
    T* Bn = Bs + nxt;
    T* Ln = Ls + nxt;
    const bool last = step == n_steps - 1;
    if (owner && src_bits != 0u) wavbar[step] = coef * lam_src;
    const T w_s = __ldg(wchunk + step);
    T lnw[R];
    Window<T, S> bw, lw;
    bw.start(Bc, base);
    lw.start(Lc, base);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int q = base + i * S;
      bw.next_row(Bc, q);
      lw.next_row(Lc, q);
      const int gr = r0 + sr0 + i;
      const bool pin = (pin_bits >> i) & 1u;
      const T bl = lw.mid.v[1];
      const T bc = bw.mid.v[1];
      const T kb = window_k(pl[i], lw);
      const T kB = window_k(pl[i], bw);
      T lnew = pin ? T(0) : (lp[i] + T(2) * bl) - coef * kb;
      T upv = pin ? T(0) : (T(2) * bc - Bn[q]) - coef * kB;
      upv = ((src_bits >> i) & 1u) ? upv + w_s * coef : upv;
      if (ring_rows != nullptr) {
        if (gr < ra || gr > rb || gc < ca || gc > cb) upv = T(0);
        if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
          if (gc == ca) upv = __ldg(ring_cols + ((long long)step * H + gr) * 2);
          if (gc == cb) {
            upv = __ldg(ring_cols + ((long long)step * H + gr) * 2 + 1);
          }
          if (gr == ra) upv = __ldg(ring_rows + ((long long)step * 2) * W + gc);
          if (gr == rb) {
            upv = __ldg(ring_rows + ((long long)step * 2 + 1) * W + gc);
          }
        }
      }
      lnw[i] = lnew;
      lam_src = ((src_bits >> i) & 1u) ? lnew : lam_src;
      {
        // branch-free: a node off the tile accumulates what is never
        // stored; a pinned tile node adds 0
        const T mu = (((tile_bits >> i) & 1u) && !pin) ? coef * bl : T(0);
        const T bsh[7] = {bc, bw.mid.v[0], bw.mid.v[2], bw.up.v[1],
                          bw.up.v[0], bw.down.v[1], bw.down.v[2]};
#pragma unroll
        for (int j = 0; j < 7; ++j) wacc[i][j] = wacc[i][j] - mu * bsh[j];
      }
      const T lpn = damped ? -(pl[i][8] * bl) : -bl;
      if (last) {
        if ((tile_bits >> i) & 1u) {
          const long long g = (long long)gr * W + gc;
          out_un[g] = bc;
          out_uc[g] = upv;
          out_lam[g] = lnew;
          out_lp[g] = lpn;
        }
      } else {
        Bn[q] = upv;
        Ln[q] = pin ? T(0) : (damped ? pl[i][7] * lnew : lnew);
        lp[i] = lpn;
      }
      bw.advance();
      lw.advance();
    }
    // the receiver cotangents, added after the mask in point order, on the
    // (rare) nodes that hold a point
    if (pt_bits != 0u) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (!((pt_bits >> i) & 1u)) continue;
        const int gr = r0 + sr0 + i, q = base + i * S;
        T lnew = lnw[i];
        for (int p = 0; p < n_pts; ++p) {
          if (__ldg(pt_r + p) == gr && __ldg(pt_c + p) == gc) {
            lnew += __ldg(inj + (long long)step * n_pts + p);
          }
        }
        if ((src_bits >> i) & 1u) lam_src = lnew;
        if (last) {
          if ((tile_bits >> i) & 1u) out_lam[(long long)gr * W + gc] = lnew;
        } else {
          const bool pin = (pin_bits >> i) & 1u;
          Ln[q] = pin ? T(0) : (damped ? pl[i][7] * lnew : lnew);
        }
      }
    }
    __syncthreads();
  }

  TW_B17_STAMP(t2);
  // the tile's accumulated wbar
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if ((tile_bits >> i) & 1u) {
      const long long g = (long long)(r0 + sr0 + i) * W + gc;
#pragma unroll
      for (int j = 0; j < 7; ++j) wbar[j * n + g] = wacc[i][j];
    }
  }
#ifdef TW_B17_STAMPS
  __syncthreads();
  const int b = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0 && b < 16384) {
    g_b17_stamps[b][0] = t0;
    g_b17_stamps[b][1] = t1;
    g_b17_stamps[b][2] = t2;
    g_b17_stamps[b][3] = b17_timer();
  }
#endif
}

template <typename K>
int opt_in_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// n_steps steps as ceil(n_steps / max_steps) near-equal launches (the
// wrapper's fused_chunks), each on its own tile (MultistepGeometry's slab
// less its halo; `side` is the wrapper's copy of kSide, refused unless
// equal). Launch i reads what launch i - 1 wrote and writes
// the other pair of (out_u, out_up) and (scratch_u, scratch_up), so that the
// last one writes the outputs; each writes its steps' rows of traces and
// of the ring saves.
template <typename T, int NP>
int launch_multistep(const void* u, const void* up, const void* planes,
                     const void* wchunk, int n_steps, int max_steps,
                     int side, int src_r, int src_c, const void* rec_r,
                     const void* rec_c, const void* rec_w, int n_rec, int per,
                     int ra, int rb, int ca, int cb, void* out_u, void* out_up,
                     void* scratch_u, void* scratch_up, void* traces,
                     void* ring_rows, void* ring_cols, int H, int W,
                     double coef, cudaStream_t stream) {
  constexpr int S = MultistepGeometry<T, NP>::kSide;
  if (side != S || n_steps < 1 || max_steps < 1 ||
      S - 2 * (max_steps + 1) < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = (n_steps + max_steps - 1) / max_steps;
  if (n > 1 && (scratch_u == nullptr || scratch_up == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(S, S / MultistepGeometry<T, NP>::kRows);
  const T* cu = static_cast<const T*>(u);
  const T* cp = static_cast<const T*>(up);
  T* rows = static_cast<T*>(ring_rows);
  T* cols = static_cast<T*>(ring_cols);
  for (int i = 0; i < n; ++i) {
    const int s0 = (int)((long long)n_steps * i / n);
    const int kc = (int)((long long)n_steps * (i + 1) / n) - s0;
    const int tile = S - 2 * (kc + 1);
    const bool to_out = (n - 1 - i) % 2 == 0;
    T* ou = static_cast<T*>(to_out ? out_u : scratch_u);
    T* oup = static_cast<T*>(to_out ? out_up : scratch_up);
    const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile);
    varcoef_multistep_kernel<T, NP><<<grid, block, 0, stream>>>(
        cu, cp, static_cast<const T*>(planes),
        static_cast<const T*>(wchunk) + s0, kc, src_r, src_c,
        static_cast<const int*>(rec_r), static_cast<const int*>(rec_c),
        static_cast<const T*>(rec_w), n_rec, per, ra, rb, ca, cb, ou, oup,
        static_cast<T*>(traces) + (long long)s0 * n_rec,
        rows == nullptr ? nullptr : rows + (long long)s0 * 2 * W,
        cols == nullptr ? nullptr : cols + (long long)s0 * H * 2, H, W,
        (T)coef, tile);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    cu = ou;
    cp = oup;
  }
  return 0;
}

template <typename T, int NP>
int launch_adjoint_multistep(
    const void* un, const void* uc, const void* lam, const void* lpart,
    const void* planes, void* wbar, const void* wchunk,
    const void* inj, int n_steps, int src_r, int src_c, const void* pt_r,
    const void* pt_c, int n_pts, int ra, int rb, int ca, int cb,
    const void* ring_rows, const void* ring_cols, void* out_un, void* out_uc,
    void* out_lam, void* out_lp, void* wavbar, int H, int W, double coef,
    int tile, cudaStream_t stream) {
  constexpr int S = AdjointGeometry<T>::kSide;
  if (n_steps < 1 || tile < 1 || tile != S - 2 * n_steps) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = adjoint_smem<T>();
  const int e = opt_in_smem(varcoef_adjoint_multistep_kernel<T, NP>, smem);
  if (e != 0) return e;
  const dim3 block(S, S / AdjointGeometry<T>::kRows);
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile);
  varcoef_adjoint_multistep_kernel<T, NP><<<grid, block, smem, stream>>>(
      static_cast<const T*>(un), static_cast<const T*>(uc),
      static_cast<const T*>(lam), static_cast<const T*>(lpart),
      static_cast<const T*>(planes), static_cast<T*>(wbar),
      static_cast<const T*>(wchunk), static_cast<const T*>(inj), n_steps,
      src_r, src_c, static_cast<const int*>(pt_r),
      static_cast<const int*>(pt_c), n_pts, ra, rb, ca, cb,
      static_cast<const T*>(ring_rows), static_cast<const T*>(ring_cols),
      static_cast<T*>(out_un), static_cast<T*>(out_uc),
      static_cast<T*>(out_lam), static_cast<T*>(out_lp),
      static_cast<T*>(wavbar), H, W, (T)coef, tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#ifdef TW_B17_STAMPS
int tw_b17_stamps(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_b17_stamps, (size_t)n * 32);
}
#endif

// dtype: 0 = float32, 1 = float64. Pointers are device pointers; point
// indices are int32. dnum / dden null: the undamped step. ring_rows /
// ring_cols null: no ring (ra .. cb are then ignored).

int tw_varcoef_step(int dtype, const void* u, const void* up,
                    const void* planes, const void* dnum, const void* dden,
                    void* out, int H, int W, double coef, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid = point_grid(H, W, block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    varcoef_step_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(u), static_cast<const float*>(up),
        static_cast<const float*>(planes), static_cast<const float*>(dnum),
        static_cast<const float*>(dden), static_cast<float*>(out), H, W,
        (float)coef);
  } else {
    varcoef_step_kernel<double><<<grid, block, 0, st>>>(
        static_cast<const double*>(u), static_cast<const double*>(up),
        static_cast<const double*>(planes), static_cast<const double*>(dnum),
        static_cast<const double*>(dden), static_cast<double*>(out), H, W,
        coef);
  }
  return (int)cudaGetLastError();
}

// B15: scratch_u / scratch_up (null when n_steps <= max_steps) hold the
// state between the launches of a split pass.
int tw_varcoef_multistep(int dtype, const void* u, const void* up,
                         const void* planes, int n_planes, const void* wchunk,
                         int n_steps, int max_steps, int side, int src_r,
                         int src_c, const void* rec_r, const void* rec_c,
                         const void* rec_w, int n_rec, int per, int ra,
                         int rb, int ca, int cb, void* out_u, void* out_up,
                         void* scratch_u, void* scratch_up, void* traces,
                         void* ring_rows, void* ring_cols, int H, int W,
                         double coef, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_planes != 7 && n_planes != 9) return (int)cudaErrorInvalidValue;
  auto launch = n_planes == 7
                    ? (dtype == 0 ? launch_multistep<float, 7>
                                  : launch_multistep<double, 7>)
                    : (dtype == 0 ? launch_multistep<float, 9>
                                  : launch_multistep<double, 9>);
  return launch(u, up, planes, wchunk, n_steps, max_steps, side, src_r,
                src_c, rec_r, rec_c, rec_w, n_rec, per, ra, rb, ca, cb,
                out_u, out_up, scratch_u, scratch_up, traces, ring_rows,
                ring_cols, H, W, coef, st);
}

// B16: `band` is tw_varcoef_adjoint_step_band's.
int tw_varcoef_adjoint_step(int dtype, const void* un, const void* uc,
                            const void* lamn, const void* lpart,
                            const void* planes, void* wbar, void* out_up,
                            void* out_lc, void* out_lp, int H, int W,
                            int band, double coef, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = dtype == 0 ? launch_adjoint_step<float>
                           : launch_adjoint_step<double>;
  return launch(un, uc, lamn, lpart, planes, wbar, out_up, out_lc, out_lp, H,
                W, band, coef, st);
}

// B16's band height on an H x W grid on the current card (one wave of
// resident warps), or -cudaError
int tw_varcoef_adjoint_step_band(int dtype, int H, int W) {
  return dtype == 0 ? adjoint_step_band<float>(H, W)
                    : adjoint_step_band<double>(H, W);
}

int tw_varcoef_adjoint_multistep(
    int dtype, const void* un, const void* uc, const void* lam,
    const void* lpart, const void* planes, int n_planes, void* wbar,
    const void* wchunk, const void* inj, int n_steps, int src_r, int src_c,
    const void* pt_r, const void* pt_c, int n_pts, int ra, int rb, int ca,
    int cb, const void* ring_rows, const void* ring_cols, void* out_un,
    void* out_uc, void* out_lam, void* out_lp, void* wavbar, int H, int W,
    double coef, int tile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_planes != 7 && n_planes != 9) return (int)cudaErrorInvalidValue;
  auto launch = n_planes == 7
                    ? (dtype == 0 ? launch_adjoint_multistep<float, 7>
                                  : launch_adjoint_multistep<double, 7>)
                    : (dtype == 0 ? launch_adjoint_multistep<float, 9>
                                  : launch_adjoint_multistep<double, 9>);
  return launch(un, uc, lam, lpart, planes, wbar, wchunk, inj, n_steps, src_r,
                src_c, pt_r, pt_c, n_pts, ra, rb, ca, cb, ring_rows,
                ring_cols, out_un, out_uc, out_lam, out_lp, wavbar, H, W,
                coef, tile, st);
}

}  // extern "C"
