// Helpers shared by the hand-written grid kernels (stencil_kernels.cu,
// solver_kernels.cu, fast_kernels.cu, ...): the run-time 3x3 stencil, the
// Dirichlet mask, staged slabs with a sliding register window, a
// deterministic reduction, and the size of a grid of one wave of resident
// blocks.
//
// A node is PINNED when its global row is <= 0 or >= n_rows - 1, or its
// column is <= 0 or >= n_cols - 1 (the Dirichlet walls); nodes outside the
// array count as pinned too.
//
// Reductions use no float atomics: every block reduces its values in a
// fixed order (warp shuffles, then the warps' sums in warp order) into one
// partial, and sum_partials_kernel (or the last block of the same launch,
// finish_norms) adds the partials in a fixed order. Reruns on the same
// inputs and launch shape are therefore bitwise equal.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Stencil9 {
  double c[9];  // row-major s[1 + dj][1 + di]
};

Stencil9 load_stencil(const double* s) {
  Stencil9 st;
  for (int k = 0; k < 9; ++k) st.c[k] = s[k];
  return st;
}

dim3 point_grid(int H, int W, dim3 block) {
  return dim3((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
}

__device__ __forceinline__ bool is_pinned(long long gr, long long gc,
                                          long long n_rows, long long n_cols) {
  return gr <= 0 || gr >= n_rows - 1 || gc <= 0 || gc >= n_cols - 1;
}

// The 3x3 stencil in the kernel's dtype.
template <typename T>
struct StencilT {
  T c[9];
  __device__ explicit StencilT(const Stencil9& s) {
#pragma unroll
    for (int k = 0; k < 9; ++k) c[k] = T(s.c[k]);
  }
};

// Staged slabs: a block stages a field over its tile plus a one-node halo,
// an SX-wide slab of SN nodes in row-major order starting at array node
// (r0, c0). slab_node gives the array offset of the node behind slab index
// i, or kNoNode when i lies outside the slab or the node lies outside the
// array or (`pinned`, the default) is pinned (its staged value is 0).
constexpr size_t kNoNode = ~(size_t)0;

template <int SX, int SN>
__device__ __forceinline__ size_t slab_node(int i, int r0, int c0, int H,
                                            int W, bool pinned = true) {
  const int sr = i / SX;
  const int gr = r0 + sr, gc = c0 + (i - sr * SX);
  const bool skip = pinned ? is_pinned(gr, gc, H, W)
                           : (unsigned)gr >= (unsigned)H ||
                                 (unsigned)gc >= (unsigned)W;
  return (i < SN && !skip) ? (size_t)gr * W + gc : kNoNode;
}

// Three neighbouring values of a slab row, centred on slab index i.
template <typename T>
struct Row3 {
  T v[3];
  __device__ __forceinline__ void load(const T* __restrict__ s, int i) {
    v[0] = s[i - 1];
    v[1] = s[i];
    v[2] = s[i + 1];
  }
};

// A thread's sliding 3x3 window over an SX-wide slab: it walks down its
// column, so each step loads one new row of three values and keeps the
// other two.
template <typename T, int SX>
struct Window {
  Row3<T> up, mid, down;
  __device__ __forceinline__ void start(const T* __restrict__ s, int i) {
    up.load(s, i - SX);
    mid.load(s, i);
  }
  __device__ __forceinline__ void next_row(const T* __restrict__ s, int i) {
    down.load(s, i + SX);
  }
  __device__ __forceinline__ void advance() {
    up = mid;
    mid = down;
  }
  // The 3x3 stencil on the window in the plain version's order
  // (ops/stencil.py apply_stencil): the centre first, then the neighbours
  // row by row.
  __device__ __forceinline__ T apply(const StencilT<T>& st) const {
    T acc = st.c[4] * mid.v[1];
    acc += st.c[0] * up.v[0];
    acc += st.c[1] * up.v[1];
    acc += st.c[2] * up.v[2];
    acc += st.c[3] * mid.v[0];
    acc += st.c[5] * mid.v[2];
    acc += st.c[6] * down.v[0];
    acc += st.c[7] * down.v[1];
    acc += st.c[8] * down.v[2];
    return acc;
  }
  // The difference form sum_{d != 0} s_d (x[n + d] - x[n]), in the same
  // order (apply_stencil_diff).
  __device__ __forceinline__ T apply_diff(const StencilT<T>& st) const {
    const T c = mid.v[1];
    T acc = st.c[0] * (up.v[0] - c);
    acc += st.c[1] * (up.v[1] - c);
    acc += st.c[2] * (up.v[2] - c);
    acc += st.c[3] * (mid.v[0] - c);
    acc += st.c[5] * (mid.v[2] - c);
    acc += st.c[6] * (down.v[0] - c);
    acc += st.c[7] * (down.v[1] - c);
    acc += st.c[8] * (down.v[2] - c);
    return acc;
  }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sum of one value per thread over the block, in a fixed order; valid in
// thread 0 only. Every thread of the block must call it. The block's
// thread count must be a multiple of 32 (at most 1024).
template <typename T>
__device__ T block_sum(T v) {
  __shared__ __align__(8) unsigned char raw[32 * sizeof(double)];
  T* warp_sums = reinterpret_cast<T*>(raw);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_warps = (blockDim.x * blockDim.y) >> 5;
  __syncthreads();  // an earlier call may still be reading warp_sums
  v = warp_sum(v);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
  __syncthreads();
  T s = T(0);
  if (tid == 0) {
    for (int w = 0; w < n_warps; ++w) s += warp_sums[w];
  }
  return s;
}

// N partials per block (value k of block b at partials[k nb + b], nb
// blocks), then the last block to finish sums each value's partials in
// block order into out[k] and resets the ticket; valid with every thread
// of the block calling it.
template <typename T, int N>
__device__ void finish_norms(const T (&part)[N], T* __restrict__ partials,
                             unsigned* __restrict__ ticket,
                             T* __restrict__ out) {
  __shared__ bool last;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nth = blockDim.x * blockDim.y;
  const unsigned nb = gridDim.x * gridDim.y;
  const unsigned b = blockIdx.y * gridDim.x + blockIdx.x;
  T sum[N];
#pragma unroll
  for (int k = 0; k < N; ++k) sum[k] = block_sum(part[k]);
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) partials[k * nb + b] = sum[k];
    __threadfence();
    last = atomicAdd(ticket, 1u) == nb - 1;
  }
  __syncthreads();
  if (!last) return;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    T v = T(0);
    for (unsigned i = tid; i < nb; i += nth) {
      v += __ldcg(partials + k * nb + i);
    }
    v = block_sum(v);
    if (tid == 0) out[k] = v;
  }
  if (tid == 0) *ticket = 0u;
}

// The blocks of `kernel` at `threads` threads that the card holds at once
// (its SMs times the blocks that fit on one): a grid of at most this many
// runs in one wave. Returns -cudaError when the card cannot be queried.
template <typename K>
int resident_blocks(K kernel, int threads) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  }
  return e == cudaSuccess ? n_sm * per_sm : -(int)e;
}

// out[b] = sum of partials[b * n .. (b + 1) * n - 1], one block per output.
constexpr int kSumThreads = 256;

template <typename T>
__global__ void sum_partials_kernel(const T* __restrict__ partials, int n,
                                    T* __restrict__ out) {
  const T* p = partials + (size_t)blockIdx.x * n;
  T v = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) v += p[i];
  v = block_sum(v);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

}  // namespace
