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
// walls; B2 adds a global row offset for a row block of a larger grid).
//
// Plain C interface, bound from Python with ctypes (ops/kernels.py). Every
// entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 = success).

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
// ---------------------------------------------------------------------------
constexpr int kB3TileX = 64, kB3ThreadsY = 4;
constexpr int kB3SlabX = kB3TileX + 2;
constexpr int kB3Threads = kB3TileX * kB3ThreadsY;
constexpr int kB3SmallRows = 2, kB3LargeRows = 8;
constexpr long long kB3LargeNodes = 1LL << 21;

template <typename T, int R, bool WALLS>
__device__ __forceinline__ void constrained_apply_walk(
    const T* __restrict__ xs, const T* __restrict__ x, T* __restrict__ out,
    int H, int W, int r0, int c0, const StencilT<T>& st, T diag, int diff) {
  const int gc = c0 + 1 + threadIdx.x;
  const bool col_wall = gc == 0 || gc == W - 1;
  int gr = r0 + 1 + threadIdx.y * R;
  int i = (threadIdx.y * R + 1) * kB3SlabX + threadIdx.x + 1;
  Window<T, kB3SlabX> w;
  w.start(xs, i);
#pragma unroll
  for (int j = 0; j < R; ++j, ++gr, i += kB3SlabX) {
    if (gr >= H) break;
    w.next_row(xs, i);
    const size_t g = (size_t)gr * W + gc;
    if (WALLS && (col_wall || gr == 0 || gr == H - 1)) {
      out[g] = diag * __ldg(x + g);
    } else {
      out[g] = diff ? w.apply_diff(st) : w.apply(st);
    }
    w.advance();
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kB3Threads)
constrained_apply_kernel(const T* __restrict__ x, T* __restrict__ out, int H,
                         int W, Stencil9 st9, T diag, int diff) {
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
    const size_t g = slab_node<kB3SlabX, kSlab>(tid + k * kB3Threads, r0,
                                                c0, H, W);
    v[k] = g != kNoNode ? __ldg(x + g) : T(0);
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
  const bool walls = r0 < 0 || c0 < 0 || r0 + kTileY >= H - 1 ||
                     c0 + kB3TileX >= W - 1;
  if (walls) {
    constrained_apply_walk<T, R, true>(xs, x, out, H, W, r0, c0, st, diag,
                                       diff);
  } else {
    constrained_apply_walk<T, R, false>(xs, x, out, H, W, r0, c0, st, diag,
                                        diff);
  }
}

// Grids below kB3TinyNodes nodes (the V-cycle's coarse levels): one thread
// per output in 32 x 8 blocks, no shared memory, nine __ldg loads. There
// the kernel is a few DRAM round trips above the launch floor, and the
// staged tiles' shared-memory hop and barrier cost more than they save.
// The mask takes four compares per output (the centre row and column are
// never walls), not one test per neighbour.
constexpr long long kB3TinyNodes = 1LL << 16;

template <typename T>
__global__ void __launch_bounds__(256)
constrained_apply_direct_kernel(const T* __restrict__ x, T* __restrict__ out,
                                int H, int W, Stencil9 st9, T diag,
                                int diff) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int r = blockIdx.y * 8 + threadIdx.y;
  if (r >= H || c >= W) return;
  const size_t i = (size_t)r * W + c;
  if (r == 0 || r == H - 1 || c == 0 || c == W - 1) {
    out[i] = diag * __ldg(x + i);
    return;
  }
  // which neighbouring rows and columns are not walls
  const bool ru = r - 1 > 0, rd = r + 1 < H - 1;
  const bool cl = c - 1 > 0, cr = c + 1 < W - 1;
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

template <typename T, int R>
int launch_constrained_apply(const void* x, void* out, int H, int W,
                             const double* s, double diag, int diff,
                             cudaStream_t stream) {
  const dim3 block(kB3TileX, kB3ThreadsY);
  const int tile_y = kB3ThreadsY * R;
  const dim3 grid((W + kB3TileX - 1) / kB3TileX, (H + tile_y - 1) / tile_y);
  constrained_apply_kernel<T, R><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), H, W, load_stencil(s),
      (T)diag, diff);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_constrained_apply(const void* x, void* out, int H, int W,
                             const double* s, double diag, int diff,
                             cudaStream_t stream) {
  const long long nodes = (long long)H * W;
  if (nodes < kB3TinyNodes) {
    const dim3 block(32, 8);
    constrained_apply_direct_kernel<T><<<point_grid(H, W, block), block, 0,
                                         stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), H, W,
        load_stencil(s), (T)diag, diff);
    return (int)cudaGetLastError();
  }
  if (nodes >= kB3LargeNodes) {
    return launch_constrained_apply<T, kB3LargeRows>(x, out, H, W, s, diag,
                                                     diff, stream);
  }
  return launch_constrained_apply<T, kB3SmallRows>(x, out, H, W, s, diag,
                                                   diff, stream);
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
// B2: n_steps leapfrog steps in one pass (temporal blocking).
//
// Each block owns a tile x tile square of output nodes. It loads u and
// u_prev over the tile plus an n_steps-wide halo on all four sides into
// dynamic shared memory (zeros outside the array), then runs n_steps
// substeps there with one __syncthreads() between them. Substep s updates
// the slab nodes at distance >= s from the slab edge, whose neighbours were
// all valid after substep s - 1, so after n_steps substeps the centre tile
// is exact. The global Dirichlet mask is applied at every substep. The
// update is in place: u_next overwrites u_prev's slot (it reads only its
// own u_prev value), and the two buffers swap roles.
//
// Bound on this card: shared memory bandwidth and the redundant halo work.
// Device memory traffic is 2 reads + 2 writes per n_steps steps (16 B per
// point per n_steps in f32); each substep reads 10 and writes 1 value of
// shared memory per slab node, over a slab (tile + 2 n_steps)^2 that
// shrinks by 2 per substep. The wrapper picks the largest tile (64, 32, 16)
// whose two slabs fit the card's opt-in shared memory.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void leapfrog_multistep_kernel(const T* __restrict__ u,
                                          const T* __restrict__ up,
                                          T* __restrict__ out_u,
                                          T* __restrict__ out_up, int H, int W,
                                          Stencil9 st, T coef, int n_steps,
                                          int tile, long long row_offset,
                                          long long n_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = tile + 2 * n_steps;  // slab side
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* prv = cur + (size_t)S * S;
  const int r0 = blockIdx.y * tile - n_steps;  // array row of slab row 0
  const int c0 = blockIdx.x * tile - n_steps;  // array col of slab col 0
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bx = blockDim.x, by = blockDim.y;

  for (int sr = ty; sr < S; sr += by) {
    const int r = r0 + sr;
    const bool row_in = r >= 0 && r < H;
    for (int sc = tx; sc < S; sc += bx) {
      const int c = c0 + sc;
      const bool in = row_in && c >= 0 && c < W;
      const size_t g = (size_t)r * W + c;
      cur[sr * S + sc] = in ? __ldg(u + g) : T(0);
      prv[sr * S + sc] = in ? __ldg(up + g) : T(0);
    }
  }
  __syncthreads();

  T s[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) s[k] = T(st.c[k]);

  for (int step = 1; step <= n_steps; ++step) {
    const int hi = S - step;
    for (int sr = step + ty; sr < hi; sr += by) {
      const long long gr = row_offset + (long long)(r0 + sr);
      const T* rm = cur + (sr - 1) * S;
      const T* rc = cur + sr * S;
      const T* rp = cur + (sr + 1) * S;
      for (int sc = step + tx; sc < hi; sc += bx) {
        T v = T(0);
        if (!is_pinned(gr, c0 + sc, n_rows, W)) {
          T ku = s[4] * rc[sc];
          ku += s[0] * rm[sc - 1];
          ku += s[1] * rm[sc];
          ku += s[2] * rm[sc + 1];
          ku += s[3] * rc[sc - 1];
          ku += s[5] * rc[sc + 1];
          ku += s[6] * rp[sc - 1];
          ku += s[7] * rp[sc];
          ku += s[8] * rp[sc + 1];
          v = (T(2) * rc[sc] - prv[sr * S + sc]) - coef * ku;
        }
        prv[sr * S + sc] = v;
      }
    }
    __syncthreads();
    T* t = cur;
    cur = prv;
    prv = t;
  }

  // cur holds u after n_steps, prv holds it after n_steps - 1
  for (int sr = n_steps + ty; sr < n_steps + tile; sr += by) {
    const int r = r0 + sr;
    if (r < 0 || r >= H) continue;
    for (int sc = n_steps + tx; sc < n_steps + tile; sc += bx) {
      const int c = c0 + sc;
      if (c < 0 || c >= W) continue;
      const size_t g = (size_t)r * W + c;
      out_u[g] = cur[sr * S + sc];
      out_up[g] = prv[sr * S + sc];
    }
  }
}

template <typename T>
int launch_multistep(const void* u, const void* up, void* out_u, void* out_up,
                     int H, int W, const double* s, double coef, int n_steps,
                     int tile, long long row_offset, long long n_rows,
                     cudaStream_t stream) {
  const size_t side = (size_t)tile + 2 * (size_t)n_steps;
  const size_t smem = 2 * side * side * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        leapfrog_multistep_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(32, 16);
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile);
  leapfrog_multistep_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(up),
      static_cast<T*>(out_u), static_cast<T*>(out_up), H, W, load_stencil(s),
      (T)coef, n_steps, tile, row_offset, n_rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B6: n_steps DRIVEN leapfrog steps in one pass (temporal blocking with
// per-substep Dirichlet data).
//
// B2's tile and shrinking slab, with one change: where B2 writes 0 on a
// pinned node, B6 writes that substep's boundary value for the node's
// GLOBAL row or column,
//
//   row H - 1: gtb[s, 1, c]     row 0:     gtb[s, 0, c]
//   col W - 1: glr[s, r, 1]     col 0:     glr[s, r, 0]
//
// tested in that order (the rows win at the corners, as in tpuwave's
// overlay order left, right, bottom, top); nodes outside the array are 0.
// Because the value depends only on global coordinates, every tile whose
// slab holds a boundary row or column, its halo copies of a neighbour's
// boundary included, injects the same value at every substep: tiles stay
// independent, and no atomics are used (reruns are bitwise equal).
//
// gtb is (n_steps, 2, W) and glr (n_steps, H, 2), row-major in the state's
// dtype: 2 values per boundary node per substep, read straight from global
// memory with __ldg (tiny, L2-resident; not staged in shared memory).
//
// Bound on this card: as B2, shared-memory traffic and the halo's
// redundant work; device memory sees 2 reads + 2 writes per n_steps steps
// (16 B per node per pass in f32) plus the edge tables. The boundary
// tests are taken per slab row: a row outside the array or on row 0 or
// H - 1 takes its values from the table (or 0) without a stencil, and in
// every other row one unsigned compare per node separates the interior
// from the two boundary columns, so the stencil loop is as lean as B2's.
// (A first version tested all six cases per node: 48 registers and 1.6x
// B2's time at k = 8.)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void leapfrog_multistep_driven_kernel(
    const T* __restrict__ u, const T* __restrict__ up,
    const T* __restrict__ gtb, const T* __restrict__ glr,
    T* __restrict__ out_u, T* __restrict__ out_up, int H, int W, Stencil9 st,
    T coef, int n_steps, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = tile + 2 * n_steps;  // slab side
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* prv = cur + (size_t)S * S;
  const int r0 = blockIdx.y * tile - n_steps;  // array row of slab row 0
  const int c0 = blockIdx.x * tile - n_steps;  // array col of slab col 0
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bx = blockDim.x, by = blockDim.y;

  for (int sr = ty; sr < S; sr += by) {
    const int r = r0 + sr;
    const bool row_in = r >= 0 && r < H;
    for (int sc = tx; sc < S; sc += bx) {
      const int c = c0 + sc;
      const bool in = row_in && c >= 0 && c < W;
      const size_t g = (size_t)r * W + c;
      cur[sr * S + sc] = in ? __ldg(u + g) : T(0);
      prv[sr * S + sc] = in ? __ldg(up + g) : T(0);
    }
  }
  __syncthreads();

  T s[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) s[k] = T(st.c[k]);

  for (int step = 1; step <= n_steps; ++step) {
    const int hi = S - step;
    const T* g_bot = gtb + (size_t)(step - 1) * 2 * W;  // gtb[s, 0, :]
    const T* g_top = g_bot + W;                          // gtb[s, 1, :]
    const T* g_lr = glr + (size_t)(step - 1) * H * 2;    // glr[s, :, :]
    for (int sr = step + ty; sr < hi; sr += by) {
      const int r = r0 + sr;
      T* out = prv + sr * S;
      if (r <= 0 || r >= H - 1) {
        // outside the array (0) or a boundary row (its table; the rows
        // win at the corners, row H - 1 over row 0)
        const T* g_row = r == H - 1 ? g_top : (r == 0 ? g_bot : nullptr);
        for (int sc = step + tx; sc < hi; sc += bx) {
          const int c = c0 + sc;
          out[sc] = (g_row != nullptr && c >= 0 && c < W) ? __ldg(g_row + c)
                                                          : T(0);
        }
        continue;
      }
      const T* rm = cur + (sr - 1) * S;
      const T* rc = cur + sr * S;
      const T* rp = cur + (sr + 1) * S;
      for (int sc = step + tx; sc < hi; sc += bx) {
        const int c = c0 + sc;
        T v;
        if ((unsigned)(c - 1) < (unsigned)(W - 2)) {  // 0 < c < W - 1
          T ku = s[4] * rc[sc];
          ku += s[0] * rm[sc - 1];
          ku += s[1] * rm[sc];
          ku += s[2] * rm[sc + 1];
          ku += s[3] * rc[sc - 1];
          ku += s[5] * rc[sc + 1];
          ku += s[6] * rp[sc - 1];
          ku += s[7] * rp[sc];
          ku += s[8] * rp[sc + 1];
          v = (T(2) * rc[sc] - out[sc]) - coef * ku;
        } else if (c == W - 1) {
          v = __ldg(g_lr + (size_t)r * 2 + 1);
        } else if (c == 0) {
          v = __ldg(g_lr + (size_t)r * 2);
        } else {
          v = T(0);
        }
        out[sc] = v;
      }
    }
    __syncthreads();
    T* t = cur;
    cur = prv;
    prv = t;
  }

  // cur holds u after n_steps, prv holds it after n_steps - 1
  for (int sr = n_steps + ty; sr < n_steps + tile; sr += by) {
    const int r = r0 + sr;
    if (r < 0 || r >= H) continue;
    for (int sc = n_steps + tx; sc < n_steps + tile; sc += bx) {
      const int c = c0 + sc;
      if (c < 0 || c >= W) continue;
      const size_t g = (size_t)r * W + c;
      out_u[g] = cur[sr * S + sc];
      out_up[g] = prv[sr * S + sc];
    }
  }
}

template <typename T>
int launch_multistep_driven(const void* u, const void* up, const void* gtb,
                            const void* glr, void* out_u, void* out_up, int H,
                            int W, const double* s, double coef, int n_steps,
                            int tile, cudaStream_t stream) {
  const size_t side = (size_t)tile + 2 * (size_t)n_steps;
  const size_t smem = 2 * side * side * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        leapfrog_multistep_driven_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(32, 16);
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile);
  leapfrog_multistep_driven_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(up),
      static_cast<const T*>(gtb), static_cast<const T*>(glr),
      static_cast<T*>(out_u), static_cast<T*>(out_up), H, W, load_stencil(s),
      (T)coef, n_steps, tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. Pointers are device pointers; s points to
// 9 host doubles (row-major 3x3 stencil).

int tw_constrained_apply(int dtype, const void* x, void* out, int H, int W,
                         const double* s, double diag, int diff,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_constrained_apply<float>(x, out, H, W, s, diag, diff, st);
  }
  return launch_constrained_apply<double>(x, out, H, W, s, diag, diff, st);
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

int tw_leapfrog_multistep(int dtype, const void* u, const void* up,
                          void* out_u, void* out_up, int H, int W,
                          const double* s, double coef, int n_steps, int tile,
                          long long row_offset, long long n_rows,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_multistep<float>(u, up, out_u, out_up, H, W, s, coef,
                                   n_steps, tile, row_offset, n_rows, st);
  }
  return launch_multistep<double>(u, up, out_u, out_up, H, W, s, coef,
                                  n_steps, tile, row_offset, n_rows, st);
}

// gtb: (n_steps, 2, W) bottom / top edge values per substep; glr:
// (n_steps, H, 2) left / right edge values per substep.
int tw_leapfrog_multistep_driven(int dtype, const void* u, const void* up,
                                 const void* gtb, const void* glr,
                                 void* out_u, void* out_up, int H, int W,
                                 const double* s, double coef, int n_steps,
                                 int tile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_multistep_driven<float>(u, up, gtb, glr, out_u, out_up, H,
                                          W, s, coef, n_steps, tile, st);
  }
  return launch_multistep_driven<double>(u, up, gtb, glr, out_u, out_up, H, W,
                                         s, coef, n_steps, tile, st);
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
