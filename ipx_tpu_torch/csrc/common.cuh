// Shared by the kernels of csrc/: block size, the layout of the CR loops'
// scalar state, deterministic block and per-lane reductions, and the layout
// of the batched passes.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ipxt {

constexpr int kThreads = 256;

// The CR loop keeps its scalars in one small device array of the working
// type (ops/device_cr.py:_cr_solve_cuda). `cdot` is double-buffered by the
// parity of the host's trip count, so a pass can read this trip's value
// while its block 0 writes the next one.
enum StateSlot {
  kCdot0 = 0,
  kCdot1 = 1,
  kRpn = 2,    // preconditioned residual norm of the last recheck
  kIt = 3,     // iterations taken
  kErr = 4,    // error code (ipx_tpu/ops/device_cr.py:52-57)
  kDone = 5,   // nonzero once the loop has stopped; every pass then returns
  kStateLen = 8,
};

// True when `state` is given and says the loop has stopped. Every thread of
// a block reads the same value, so an early return is uniform in the block.
template <typename T>
__device__ __forceinline__ bool loop_done(const T* state) {
  return state != nullptr && state[kDone] != T(0);
}

// Sum of one value per thread over the block, in a fixed order. Every
// thread gets the result. `red` holds kThreads values of shared memory.
template <typename T>
__device__ T block_sum(T v, T* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  T r = red[0];
  __syncthreads();  // `red` may be reused right after
  return r;
}

// |x|, keeping NaN; written out so that float and double take one path
template <typename T>
__device__ __forceinline__ T abs_val(T x) {
  return x < T(0) ? -x : x;
}

// max that propagates NaN, as jnp.max and torch.max do.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__device__ T block_max(T v, T* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w)
      red[threadIdx.x] = nan_max(red[threadIdx.x], red[threadIdx.x + w]);
    __syncthreads();
  }
  T r = red[0];
  __syncthreads();
  return r;
}

// Sum of n per-block partials, in the same fixed order in every block, so
// that every block of a pass derives bit-identical scalars from them.
template <typename T>
__device__ T sum_partials(const T* __restrict__ p, int64_t n, T* red) {
  T s = T(0);
  for (int64_t i = threadIdx.x; i < n; i += kThreads) s += p[i];
  return block_sum(s, red);
}

template <typename T>
__device__ T max_partials(const T* __restrict__ p, int64_t n, T* red) {
  T s = T(0);  // the partials are absolute values, so 0 is the identity
  for (int64_t i = threadIdx.x; i < n; i += kThreads) s = nan_max(s, p[i]);
  return block_max(s, red);
}

inline int64_t blocks_for(int64_t n, int64_t per_block) {
  return (n + per_block - 1) / per_block;
}

// -- batched passes over (rows, B) arrays, B contiguous ----------------------
//
// A block is blockDim.x threads across lanes (or across chunks of VW lanes)
// by blockDim.y threads across rows; blockIdx.y tiles the lanes past 256 and
// blockIdx.x strides over the rows. Capping the row blocks keeps the
// per-block, per-lane partials of a reduction short: (gx, B) values.
constexpr int64_t kMaxRowBlocks = 1024;

struct LaneGrid {
  int tx, ty;
  int64_t gx, gy;
};

inline LaneGrid lane_grid(int64_t rows, int64_t chunks) {
  LaneGrid g;
  g.tx = (int)(chunks < kThreads ? (chunks > 0 ? chunks : 1) : kThreads);
  g.ty = kThreads / g.tx;
  g.gy = blocks_for(chunks > 0 ? chunks : 1, g.tx);
  const int64_t gx = blocks_for(rows, g.ty);
  g.gx = gx < 1 ? 1 : (gx < kMaxRowBlocks ? gx : kMaxRowBlocks);
  return g;
}

struct AddOp {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct MaxOp {
  template <typename T>
  __device__ T operator()(T a, T b) const { return nan_max(a, b); }
};
struct MinOp {  // the candidates of a ratio test are never NaN
  template <typename T>
  __device__ T operator()(T a, T b) const { return b < a ? b : a; }
};

// Reduces each thread's VW values over the rows of the block (threadIdx.y),
// in a fixed order; the result is valid in the threads with threadIdx.y == 0.
// `red` holds blockDim.x * blockDim.y * VW values of shared memory. Every
// thread of the block must call it.
template <typename T, int VW, typename Op>
__device__ void lane_reduce(T (&v)[VW], T* red, Op op) {
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int j = 0; j < VW; ++j) red[t * VW + j] = v[j];
  __syncthreads();
  if (threadIdx.y == 0) {
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      T s = red[threadIdx.x * VW + j];
      for (int y = 1; y < (int)blockDim.y; ++y)
        s = op(s, red[(y * blockDim.x + threadIdx.x) * VW + j]);
      v[j] = s;
    }
  }
  __syncthreads();
}

// Lane b's reduction of n per-block partials laid out (n, B), in order.
template <typename T, typename Op>
__device__ T lane_partials(const T* __restrict__ p, int64_t n, int64_t B,
                           int64_t b, T init, Op op) {
  T s = init;
  for (int64_t k = 0; k < n; ++k) s = op(s, p[k * B + b]);
  return s;
}

// -- column reductions across blocks (K10, K13) -------------------------------
//
// A reducing pass over (rows, B) takes blocks of RedGrid::tx lanes (at most
// 32: one warp reads 256 contiguous bytes of a row) by kThreads / tx rows;
// blockIdx.y tiles the lanes and blockIdx.x strides over the rows, at most
// kRedRowBlocks of them. Each block reduces its rows in a fixed order
// (lane_reduce) and writes one partial per quantity and lane, laid out
// (Q, B, nblk), so that a lane's partials are contiguous. The finishing
// launch gives every lane one warp, which reduces them in a fixed order
// with shuffles (warp_partials). No atomics: two runs agree bit for bit.
constexpr int64_t kRedRowBlocks = 512;
constexpr int kWarpsPerBlock = kThreads / 32;

inline LaneGrid red_grid(int64_t rows, int64_t B) {
  LaneGrid g;
  g.tx = (int)(B < 32 ? (B > 0 ? B : 1) : 32);
  g.ty = kThreads / g.tx;
  g.gy = blocks_for(B > 0 ? B : 1, g.tx);
  const int64_t gx = blocks_for(rows, g.ty);
  g.gx = gx < 1 ? 1 : (gx < kRedRowBlocks ? gx : kRedRowBlocks);
  return g;
}

// Stores the block's reduced values v[0..Q) of lane b as partials of
// quantities q0 .. q0 + Q, at row block blockIdx.x; call after lane_reduce.
template <typename T, int Q>
__device__ __forceinline__ void store_partials(const T (&v)[Q], T* p,
                                               int q0, int64_t B, int64_t b,
                                               int64_t nblk) {
  if (threadIdx.y != 0 || b >= B) return;
#pragma unroll
  for (int q = 0; q < Q; ++q)
    p[((int64_t)(q0 + q) * B + b) * nblk + blockIdx.x] = v[q];
}

// The reduction of the nblk partials at p by the 32 threads of one warp:
// thread t takes p[t], p[t + 32], ... in order, then a shuffle tree; the
// result is valid in the warp's thread 0. Every thread of the warp calls it.
template <typename T, typename Op>
__device__ T warp_partials(const T* __restrict__ p, int64_t nblk, T init,
                           Op op) {
  T s = init;
  for (int64_t k = threadIdx.x & 31; k < nblk; k += 32) s = op(s, p[k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = op(s, __shfl_down_sync(0xffffffffu, s, off));
  return s;
}

// The lane of the warp that calls it, in a finishing launch of
// blocks_for(B, kWarpsPerBlock) blocks of kThreads threads.
__device__ __forceinline__ int64_t warp_lane() {
  return (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
}

// min and max that propagate NaN, as torch.minimum and torch.maximum do
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a < b || a != a) ? a : b;
}

// Products and sums rounded on their own, never contracted into an FMA, for
// the passes that must match their plain PyTorch versions bit for bit.
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}

}  // namespace ipxt
