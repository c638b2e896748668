// Hand-written Hopper (sm_90a) kernels for the fused implicit steps of
// FastWaveSolver (models/fast.py: run_implicit_mg_kernel,
// run_implicit_cheby).
//
// Four kernels, each a port of one Pallas TPU kernel of
// tpuwave/ops/pallas_kernels.py, templated on float and double:
//
//   B7   newmark_rhs_r0  <- newmark_rhs_r0_pallas (_newmark_rhs_r0_kernel)
//   B8   newmark_update  <- newmark_update_pallas (_newmark_update_kernel)
//   B9   theta_r0u       <- theta_r0u_pallas (_theta_r0u_kernel)
//   B10  theta_r0v       <- theta_r0v_pallas (_theta_r0v_kernel)
//
// Same conventions as stencil_kernels.cu and solver_kernels.cu: a row-major
// (H, W) vertex grid at its true shape, 3x3 stencils and every coefficient
// as run-time arguments, the Dirichlet mask in global coordinates
// (grid_common.cuh). B7, B9 and B10 also return three squared norms
// (||r0||^2, ||rhs||^2, ||x0||^2), reduced deterministically in the
// tensor's dtype: one partial per block and norm, then sum_partials_kernel
// (B7, B10) or the last block of the same launch (B9).
//
// B7, B9 and B10 apply two or three stencils to fields that are masked
// combinations of the inputs. Each block owns a kTileX x kTileY tile of
// output nodes (B9: tiles in turn, from a persistent grid) and first
// stages those combinations over the tile plus a one-node halo in shared
// memory (zero on pinned nodes and outside the array), so every input
// value is loaded from global memory once per block and combined once; a
// thread starts all its loads (kStage per input) before it uses the
// first, to keep enough bytes in flight. Each thread then walks down one
// column of the tile for kRows outputs with a sliding 3x3 window in
// registers: three shared-memory loads per slab and output instead of
// nine. A stencil is summed in the plain version's order: the centre,
// then dj, di = -1, 0, 1.
//
// Bound on this card: memory, for all four (B7 reads 3 grids and writes 2
// for ~47 operations per node; B8 4 + 3, elementwise; B9 2 + 1; B10 3 + 2).
// A block's phases (load, barrier, stencils, stores) do not overlap, so
// what keeps device memory busy is the loads in flight per block times the
// blocks resident on an SM.
//
// Plain C interface, bound from Python with ctypes (ops/kernels.py). Every
// entry point launches on the stream it is given, allocates nothing (the
// caller passes the partials buffer), does not synchronise, and returns
// cudaGetLastError() (0 = success).

#include "grid_common.cuh"

namespace {

constexpr int kTileX = 64, kTileY = 16;            // output nodes per block
constexpr int kSlabX = kTileX + 2, kSlabY = kTileY + 2;
constexpr int kSlab = kSlabX * kSlabY;
constexpr int kThreadsX = kTileX, kThreadsY = 4;   // one column per thread
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kRows = kTileY / kThreadsY;          // output rows per thread
constexpr int kWarps = kThreads / 32;
constexpr int kStage = (kSlab + kThreads - 1) / kThreads;  // loads per thread

// slab_node (grid_common.cuh) at this file's tile
__device__ __forceinline__ size_t tile_node(int i, int r0, int c0, int H,
                                            int W) {
  return slab_node<kSlabX, kSlab>(i, r0, c0, H, W);
}

// Reduce three values per thread over the block in a fixed order (warp
// shuffles, then the warps' sums in warp order) and write the block's
// partials; every thread of the block calls it.
template <typename T>
__device__ void store_partials(T* __restrict__ partials, int n_blocks, T p0,
                               T p1, T p2) {
  __shared__ T warp_sums[3][kWarps];
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  p0 = warp_sum(p0);
  p1 = warp_sum(p1);
  p2 = warp_sum(p2);
  if ((tid & 31) == 0) {
    warp_sums[0][tid >> 5] = p0;
    warp_sums[1][tid >> 5] = p1;
    warp_sums[2][tid >> 5] = p2;
  }
  __syncthreads();
  if (tid < 3) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[tid][w];
    partials[tid * n_blocks + blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// ---------------------------------------------------------------------------
// B7: the fused setup of the implicit Newmark a-solve,
//
//   z   = u + c_zv v + c_za a        on interior nodes, 0 pinned
//   x0  = a                          on interior nodes, 0 pinned
//   rhs = -K z                       on interior nodes, 0 pinned
//   r0  = rhs - A x0                 on interior nodes, 0 pinned
//
// Writes r0 and z; reduces ||r0||^2, ||rhs||^2, ||x0||^2. Slabs: z, x0.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
newmark_rhs_r0_kernel(const T* __restrict__ u, const T* __restrict__ v,
                      const T* __restrict__ a, T* __restrict__ out_r0,
                      T* __restrict__ out_z, T* __restrict__ partials,
                      int n_blocks, int H, int W, Stencil9 k9, Stencil9 a9,
                      T c_zv, T c_za) {
  __shared__ T zs[kSlab];
  __shared__ T xs[kSlab];
  const int r0 = blockIdx.y * kTileY - 1;  // array row of slab row 0
  const int c0 = blockIdx.x * kTileX - 1;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  // every global load of the thread is started before the first use
  T ur[kStage], vr[kStage], ar[kStage];
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const size_t g = tile_node(tid + k * kThreads, r0, c0, H, W);
    const bool in = g != kNoNode;
    ur[k] = in ? __ldg(u + g) : T(0);
    vr[k] = in ? __ldg(v + g) : T(0);
    ar[k] = in ? __ldg(a + g) : T(0);
  }
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int i = tid + k * kThreads;
    if (i < kSlab) {
      zs[i] = ur[k] + c_zv * vr[k] + c_za * ar[k];
      xs[i] = ar[k];
    }
  }
  __syncthreads();
  const StencilT<T> kst(k9), ast(a9);
  T pr = T(0), pb = T(0), px = T(0);
  const int gc = c0 + 1 + threadIdx.x;
  if (gc < W) {
    int i = (threadIdx.y * kRows + 1) * kSlabX + threadIdx.x + 1;
    int gr = r0 + 1 + threadIdx.y * kRows;
    Window<T, kSlabX> zw, xw;
    zw.start(zs, i);
    xw.start(xs, i);
#pragma unroll
    for (int j = 0; j < kRows; ++j, ++gr, i += kSlabX) {
      if (gr >= H) break;
      zw.next_row(zs, i);
      xw.next_row(xs, i);
      T rhs = T(0), r = T(0);
      if (!is_pinned(gr, gc, H, W)) {
        rhs = -zw.apply(kst);
        r = rhs - xw.apply(ast);
      }
      const size_t g = (size_t)gr * W + gc;
      out_r0[g] = r;
      out_z[g] = zw.mid.v[1];
      pr += r * r;
      pb += rhs * rhs;
      px += xw.mid.v[1] * xw.mid.v[1];
      zw.advance();
      xw.advance();
    }
  }
  store_partials(partials, n_blocks, pr, pb, px);
}

// ---------------------------------------------------------------------------
// B9: the fused setup of the theta u-solve, on u and v masked to 0 on pinned
// nodes (warm start x0 = u, so the M u terms of rhs - A x0 cancel):
//
//   r0  = c_r0k K u + c_mv M v            on interior nodes, 0 pinned
//   rhs = M u + c_comb K u + c_mv M v     reduced only, never written
//
// Writes r0; reduces ||r0||^2, ||rhs||^2, ||masked u||^2 in the same
// launch.
//
// Bound on this card: memory. It reads 2 grids and writes 1 (12 B per node
// in f32: 201 MB at 4097^2, 60 us at 3.35 TB/s) for 62 operations per node.
//
// Persistent tiles: a grid of one wave of resident blocks, each block
// taking tiles of 64 x 16 output nodes in turn (tile t + gridDim.x after
// tile t), so that the norms' per-block cost (the partials, a fence and
// the ticket's atomic) is paid once a block and not once a tile. A block
// stages masked u and v over a tile plus a one-node halo in shared memory
// (a pinned node, or one outside the array, stages 0), then each thread
// walks down one column of the tile for kRows outputs with a sliding
// 3-row register window per slab. In f32 the loads of the block's next
// tile go to registers before it computes this one, so they are in flight
// across the tile's stencils; in f64 those registers would cut the blocks
// an SM holds (110 registers a thread against 63) and the tile is loaded
// when its turn comes (PERF.md). Only a tile whose slab reaches a pinned
// node or the array's edge tests its loads and its outputs for them; the
// others load from offsets each thread computes once. The norms: each
// thread sums its outputs in tile and row order, each block its threads in
// a fixed order, and the last block to finish sums the blocks' partials in
// block order (finish_norms, B4's ticket): no float atomics, reruns are
// bitwise equal. (The first version, one block a tile, tested every
// output for the mask and summed the partials in a second launch: 44-56%
// of the bound; one block a tile with the ticket was slower still,
// PERF.md.)
// ---------------------------------------------------------------------------

// whether a B9 block loads its next tile while it computes this one
template <typename T>
constexpr bool kR0uAhead = sizeof(T) == 4;

// the thread's values of masked u and v over the slab whose node 0 is
// array node (r0, c0), loaded into registers; off[k] is the array offset
// of the thread's k-th slab node from node (r0, c0). A slab clear of the
// walls and the array's edges (WALLS false) loads with no test.
template <typename T, bool WALLS>
__device__ __forceinline__ void r0u_load(const T* __restrict__ u,
                                         const T* __restrict__ v,
                                         T (&ur)[kStage], T (&vr)[kStage],
                                         int r0, int c0, int H, int W,
                                         const int (&off)[kStage]) {
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const size_t base = WALLS ? 0 : (size_t)r0 * W + c0;
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int i = tid + k * kThreads;
    if (WALLS) {
      const size_t g = tile_node(i, r0, c0, H, W);
      ur[k] = g != kNoNode ? __ldg(u + g) : T(0);
      vr[k] = g != kNoNode ? __ldg(v + g) : T(0);
    } else {
      const bool in = i < kSlab;
      ur[k] = in ? __ldg(u + base + off[k]) : T(0);
      vr[k] = in ? __ldg(v + base + off[k]) : T(0);
    }
  }
}

template <typename T, bool WALLS>
__device__ __forceinline__ void theta_r0u_walk(
    const T* __restrict__ us, const T* __restrict__ vs, T* __restrict__ out_r0,
    int H, int W, int r0, int c0, const StencilT<T>& mst,
    const StencilT<T>& kst, T c_comb, T c_r0k, T c_mv, T& pr, T& pb, T& px) {
  const int gc = c0 + 1 + threadIdx.x;
  if (WALLS && gc >= W) return;
  const bool col_wall = gc == 0 || gc == W - 1;
  int gr = r0 + 1 + threadIdx.y * kRows;
  int i = (threadIdx.y * kRows + 1) * kSlabX + threadIdx.x + 1;
  Window<T, kSlabX> uw, vw;
  uw.start(us, i);
  vw.start(vs, i);
#pragma unroll
  for (int j = 0; j < kRows; ++j, ++gr, i += kSlabX) {
    if (WALLS && gr >= H) break;
    uw.next_row(us, i);
    vw.next_row(vs, i);
    T rhs = T(0), r = T(0);
    if (!WALLS || !(col_wall || gr == 0 || gr == H - 1)) {
      const T ku = uw.apply(kst);
      const T mu = uw.apply(mst);
      const T mv = vw.apply(mst);
      r = c_r0k * ku + c_mv * mv;
      rhs = mu + c_comb * ku + c_mv * mv;
    }
    out_r0[(size_t)gr * W + gc] = r;
    pr += r * r;
    pb += rhs * rhs;
    px += uw.mid.v[1] * uw.mid.v[1];
    uw.advance();
    vw.advance();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
theta_r0u_kernel(const T* __restrict__ u, const T* __restrict__ v,
                 T* __restrict__ out_r0, T* __restrict__ partials,
                 unsigned* __restrict__ ticket, T* __restrict__ norms, int H,
                 int W, int tiles_x, int n_tiles, Stencil9 m9, Stencil9 k9,
                 T c_comb, T c_r0k, T c_mv) {
  __shared__ T su[kSlab];
  __shared__ T sv[kSlab];
  const StencilT<T> mst(m9), kst(k9);
  int off[kStage];
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int i = threadIdx.y * kTileX + threadIdx.x + k * kThreads;
    off[k] = (i / kSlabX) * W + i % kSlabX;
  }
  // tile t's slab origin (array row and column of slab node 0), and
  // whether the slab reaches a pinned node or past the array
  auto origin = [&](int t, int& r0, int& c0) {
    r0 = (t / tiles_x) * kTileY - 1;
    c0 = (t % tiles_x) * kTileX - 1;
    return r0 < 1 || c0 < 1 || r0 + kTileY + 1 > H - 2 ||
           c0 + kTileX + 1 > W - 2;
  };
  T ur[kStage], vr[kStage];
  auto load = [&](int t) {
    int r0, c0;
    if (origin(t, r0, c0)) {
      r0u_load<T, true>(u, v, ur, vr, r0, c0, H, W, off);
    } else {
      r0u_load<T, false>(u, v, ur, vr, r0, c0, H, W, off);
    }
  };
  auto store = [&]() {
    const int tid = threadIdx.y * kTileX + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = tid + k * kThreads;
      if (i < kSlab) {
        su[i] = ur[k];
        sv[i] = vr[k];
      }
    }
  };
  T pr = T(0), pb = T(0), px = T(0);
  int t = blockIdx.x;
  if (kR0uAhead<T> && t < n_tiles) {
    load(t);
    store();
  }
  for (; t < n_tiles; t += gridDim.x) {
    if (!kR0uAhead<T>) {
      load(t);
      store();
    }
    __syncthreads();  // the slab of tile t is in
    // f32: the next tile's loads are in flight while this one is computed
    const bool more = kR0uAhead<T> && t + (int)gridDim.x < n_tiles;
    if (more) load(t + gridDim.x);
    int r0, c0;
    if (origin(t, r0, c0)) {
      theta_r0u_walk<T, true>(su, sv, out_r0, H, W, r0, c0, mst, kst,
                              c_comb, c_r0k, c_mv, pr, pb, px);
    } else {
      theta_r0u_walk<T, false>(su, sv, out_r0, H, W, r0, c0, mst, kst,
                               c_comb, c_r0k, c_mv, pr, pb, px);
    }
    __syncthreads();  // every thread is done with the slab
    if (more) store();
  }
  finish_norms<T, 3>({pr, pb, px}, partials, ticket, norms);
}

// ---------------------------------------------------------------------------
// B10: the u update and the fused setup of the theta v-solve, on u, e and v
// masked to 0 on pinned nodes (warm start x0 = v, so the M v terms cancel):
//
//   u'  = u + e                              (masked u plus masked e)
//   r0  = c_ku K u + c_kun K u'              on interior nodes, 0 pinned
//   rhs = M v + c_ku K u + c_kun K u'        reduced only, never written
//
// Writes u' and r0; reduces ||r0||^2, ||rhs||^2, ||masked v||^2. Slabs: u,
// u', v.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
theta_r0v_kernel(const T* __restrict__ u, const T* __restrict__ e,
                 const T* __restrict__ v, T* __restrict__ out_un,
                 T* __restrict__ out_r0, T* __restrict__ partials,
                 int n_blocks, int H, int W, Stencil9 m9, Stencil9 k9,
                 T c_ku, T c_kun) {
  __shared__ T us[kSlab];
  __shared__ T ns[kSlab];
  __shared__ T vs[kSlab];
  const int r0 = blockIdx.y * kTileY - 1;
  const int c0 = blockIdx.x * kTileX - 1;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  T ur[kStage], er[kStage], vr[kStage];
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const size_t g = tile_node(tid + k * kThreads, r0, c0, H, W);
    const bool in = g != kNoNode;
    ur[k] = in ? __ldg(u + g) : T(0);
    er[k] = in ? __ldg(e + g) : T(0);
    vr[k] = in ? __ldg(v + g) : T(0);
  }
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int i = tid + k * kThreads;
    if (i < kSlab) {
      us[i] = ur[k];
      ns[i] = ur[k] + er[k];
      vs[i] = vr[k];
    }
  }
  __syncthreads();
  const StencilT<T> mst(m9), kst(k9);
  T pr = T(0), pb = T(0), px = T(0);
  const int gc = c0 + 1 + threadIdx.x;
  if (gc < W) {
    int i = (threadIdx.y * kRows + 1) * kSlabX + threadIdx.x + 1;
    int gr = r0 + 1 + threadIdx.y * kRows;
    Window<T, kSlabX> uw, nw, vw;
    uw.start(us, i);
    nw.start(ns, i);
    vw.start(vs, i);
#pragma unroll
    for (int j = 0; j < kRows; ++j, ++gr, i += kSlabX) {
      if (gr >= H) break;
      uw.next_row(us, i);
      nw.next_row(ns, i);
      vw.next_row(vs, i);
      T rhs = T(0), r = T(0);
      if (!is_pinned(gr, gc, H, W)) {
        const T ku = uw.apply(kst);
        const T kun = nw.apply(kst);
        const T mv = vw.apply(mst);
        r = c_ku * ku + c_kun * kun;
        rhs = mv + c_ku * ku + c_kun * kun;
      }
      const size_t g = (size_t)gr * W + gc;
      out_un[g] = nw.mid.v[1];
      out_r0[g] = r;
      pr += r * r;
      pb += rhs * rhs;
      px += vw.mid.v[1] * vw.mid.v[1];
      uw.advance();
      nw.advance();
      vw.advance();
    }
  }
  store_partials(partials, n_blocks, pr, pb, px);
}

// ---------------------------------------------------------------------------
// B8: the Newmark state update, elementwise (no halo):
//
//   a' = (a on interior nodes, 0 pinned) + e
//   u' = z + c_ua a'
//   v' = v + c_va a + c_van a'          (the raw a, pinned nodes included)
//
// Reads 4 grids and writes 3. One thread per kUpdatePerThread nodes of the
// flat array, block-strided so a warp always touches consecutive addresses;
// the mask comes from the flat index.
// ---------------------------------------------------------------------------
constexpr int kUpdateThreads = 256, kUpdatePerThread = 4;

template <typename T>
__global__ void newmark_update_kernel(const T* __restrict__ z,
                                      const T* __restrict__ v,
                                      const T* __restrict__ a,
                                      const T* __restrict__ e,
                                      T* __restrict__ out_u,
                                      T* __restrict__ out_v,
                                      T* __restrict__ out_a, int H, int W,
                                      T c_ua, T c_va, T c_van) {
  const long long n = (long long)H * W;
  const long long base =
      (long long)blockIdx.x * (kUpdateThreads * kUpdatePerThread) +
      threadIdx.x;
#pragma unroll
  for (int j = 0; j < kUpdatePerThread; ++j) {
    const long long i = base + (long long)j * kUpdateThreads;
    if (i >= n) break;
    const int r = (int)(i / W);
    const int c = (int)(i - (long long)r * W);
    const T av = __ldg(a + i);
    const T an = (is_pinned(r, c, H, W) ? T(0) : av) + __ldg(e + i);
    out_a[i] = an;
    out_u[i] = __ldg(z + i) + c_ua * an;
    out_v[i] = __ldg(v + i) + c_va * av + c_van * an;
  }
}

dim3 tile_grid(int H, int W) {
  return dim3((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
}

// Sum the three rows of per-block partials into norms[0..2].
template <typename T>
int sum_three(void* partials, int n_blocks, void* norms,
              cudaStream_t stream) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials_kernel<T><<<3, kSumThreads, 0, stream>>>(
      static_cast<const T*>(partials), n_blocks, static_cast<T*>(norms));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_newmark_rhs_r0(const void* u, const void* v, const void* a,
                          void* out_r0, void* out_z, void* partials,
                          int n_partials, void* norms, int H, int W,
                          const double* ks, const double* as, double c_zv,
                          double c_za, cudaStream_t stream) {
  const dim3 grid = tile_grid(H, W);
  const int n_blocks = (int)(grid.x * grid.y);
  if (n_partials < 3 * n_blocks) return (int)cudaErrorInvalidValue;
  newmark_rhs_r0_kernel<T>
      <<<grid, dim3(kThreadsX, kThreadsY), 0, stream>>>(
          static_cast<const T*>(u), static_cast<const T*>(v),
          static_cast<const T*>(a), static_cast<T*>(out_r0),
          static_cast<T*>(out_z), static_cast<T*>(partials), n_blocks, H, W,
          load_stencil(ks), load_stencil(as), (T)c_zv, (T)c_za);
  return sum_three<T>(partials, n_blocks, norms, stream);
}

int theta_r0u_tiles(int H, int W) {
  return ((W + kTileX - 1) / kTileX) * ((H + kTileY - 1) / kTileY);
}

// B9's blocks: one wave of resident blocks, or fewer where there are fewer
// tiles
template <typename T>
int theta_r0u_blocks(int H, int W) {
  const int tiles = theta_r0u_tiles(H, W);
  const int blocks = resident_blocks(theta_r0u_kernel<T>, kThreads);
  if (blocks <= 0) return blocks < 0 ? blocks : -(int)cudaErrorUnknown;
  return blocks < tiles ? blocks : tiles;
}

template <typename T>
int launch_theta_r0u(const void* u, const void* v, void* out_r0,
                     void* partials, int n_partials, void* ticket,
                     void* norms, int H, int W, int blocks, const double* ms,
                     const double* ks, double c_comb, double c_r0k,
                     double c_mv, cudaStream_t stream) {
  if (blocks < 1 || n_partials < 3 * blocks) {
    return (int)cudaErrorInvalidValue;
  }
  theta_r0u_kernel<T><<<blocks, dim3(kThreadsX, kThreadsY), 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(v),
      static_cast<T*>(out_r0), static_cast<T*>(partials),
      static_cast<unsigned*>(ticket), static_cast<T*>(norms), H, W,
      (W + kTileX - 1) / kTileX, theta_r0u_tiles(H, W), load_stencil(ms),
      load_stencil(ks), (T)c_comb, (T)c_r0k, (T)c_mv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_theta_r0v(const void* u, const void* e, const void* v,
                     void* out_un, void* out_r0, void* partials,
                     int n_partials, void* norms, int H, int W,
                     const double* ms, const double* ks, double c_ku,
                     double c_kun, cudaStream_t stream) {
  const dim3 grid = tile_grid(H, W);
  const int n_blocks = (int)(grid.x * grid.y);
  if (n_partials < 3 * n_blocks) return (int)cudaErrorInvalidValue;
  theta_r0v_kernel<T><<<grid, dim3(kThreadsX, kThreadsY), 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(e),
      static_cast<const T*>(v), static_cast<T*>(out_un),
      static_cast<T*>(out_r0), static_cast<T*>(partials), n_blocks, H, W,
      load_stencil(ms), load_stencil(ks), (T)c_ku, (T)c_kun);
  return sum_three<T>(partials, n_blocks, norms, stream);
}

template <typename T>
int launch_newmark_update(const void* z, const void* v, const void* a,
                          const void* e, void* out_u, void* out_v,
                          void* out_a, int H, int W, double c_ua,
                          double c_va, double c_van, cudaStream_t stream) {
  const long long n = (long long)H * W;
  const long long per_block = kUpdateThreads * kUpdatePerThread;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  newmark_update_kernel<T><<<blocks, kUpdateThreads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(v),
      static_cast<const T*>(a), static_cast<const T*>(e),
      static_cast<T*>(out_u), static_cast<T*>(out_v), static_cast<T*>(out_a),
      H, W, (T)c_ua, (T)c_va, (T)c_van);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. Pointers are device pointers except the
// stencils (9 host doubles each, row-major 3x3). B7, B10: `partials` holds
// n_partials >= 3 * tw_fast_blocks(H, W) values of the dtype; `norms`
// receives ||r0||^2, ||rhs||^2, ||x0||^2 (B9 too).

int tw_newmark_rhs_r0(int dtype, const void* u, const void* v, const void* a,
                      void* out_r0, void* out_z, void* partials,
                      int n_partials, void* norms, int H, int W,
                      const double* k_stencil, const double* a_stencil,
                      double c_zv, double c_za, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_newmark_rhs_r0<float>(u, v, a, out_r0, out_z, partials,
                                        n_partials, norms, H, W, k_stencil,
                                        a_stencil, c_zv, c_za, st);
  }
  return launch_newmark_rhs_r0<double>(u, v, a, out_r0, out_z, partials,
                                       n_partials, norms, H, W, k_stencil,
                                       a_stencil, c_zv, c_za, st);
}

int tw_newmark_update(int dtype, const void* z, const void* v, const void* a,
                      const void* e, void* out_u, void* out_v, void* out_a,
                      int H, int W, double c_ua, double c_va, double c_van,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_newmark_update<float>(z, v, a, e, out_u, out_v, out_a, H,
                                        W, c_ua, c_va, c_van, st);
  }
  return launch_newmark_update<double>(z, v, a, e, out_u, out_v, out_a, H, W,
                                       c_ua, c_va, c_van, st);
}

// B9: `blocks` is tw_theta_r0u_blocks's; `partials` holds n_partials >=
// 3 x blocks values; `ticket` is one unsigned int that is 0 before the
// call and 0 again after it.
int tw_theta_r0u(int dtype, const void* u, const void* v, void* out_r0,
                 void* partials, int n_partials, void* ticket, void* norms,
                 int H, int W, int blocks, const double* m_stencil,
                 const double* k_stencil, double c_comb, double c_r0k,
                 double c_mv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = dtype == 0 ? launch_theta_r0u<float>
                           : launch_theta_r0u<double>;
  return launch(u, v, out_r0, partials, n_partials, ticket, norms, H, W,
                blocks, m_stencil, k_stencil, c_comb, c_r0k, c_mv, st);
}

// B9's blocks on an H x W grid on the current card, or -cudaError
int tw_theta_r0u_blocks(int dtype, int H, int W) {
  return dtype == 0 ? theta_r0u_blocks<float>(H, W)
                    : theta_r0u_blocks<double>(H, W);
}

int tw_theta_r0v(int dtype, const void* u, const void* e, const void* v,
                 void* out_un, void* out_r0, void* partials, int n_partials,
                 void* norms, int H, int W, const double* m_stencil,
                 const double* k_stencil, double c_ku, double c_kun,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_theta_r0v<float>(u, e, v, out_un, out_r0, partials,
                                   n_partials, norms, H, W, m_stencil,
                                   k_stencil, c_ku, c_kun, st);
  }
  return launch_theta_r0v<double>(u, e, v, out_un, out_r0, partials,
                                  n_partials, norms, H, W, m_stencil,
                                  k_stencil, c_ku, c_kun, st);
}

// Blocks of B7 and B10 on an (H, W) grid (the wrapper sizes the partials
// buffer from it).
int tw_fast_blocks(int H, int W) {
  const dim3 grid = tile_grid(H, W);
  return (int)(grid.x * grid.y);
}

}  // extern "C"
