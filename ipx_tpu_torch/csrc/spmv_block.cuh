// K1's row body, shared by csr_spmv (spmv.cu), the block products of a
// row-blocked apply (spmv.cu) and the K2 applies inside K3's cooperative
// solve (cr.cu), so that all of them round alike.
#pragma once

#include "common.cuh"

namespace ipxt {

// One CUDA block's rows of a product: local block `blk` of an operand of
// `rows` rows takes rows blk * (kThreads / VEC) + threadIdx.x / VEC, each
// summed by VEC lanes with a fixed shuffle tree, then
//   y[row] = sum * rowscale[row] + addw[row] * addv[row]
// (rowscale, addw / addv may be null). With `partial`, *partial is the
// block's fixed-order sum of addv[row] * y[row]. y, rowscale, addw and addv
// point at the operand's row 0. Every thread of the block calls it.
//
// kReadOnly: x is not written while the kernel runs, so its gathers take
// the read-only cache (__ldg). Inside one cooperative launch an earlier
// pass writes x (K3's sres and u), and the gathers are plain loads, which
// the grid barrier makes see those writes; x and addv are therefore not
// __restrict__.
template <typename T, int VEC, bool kReadOnly>
__device__ __forceinline__ void spmv_block(
    int64_t rows, int64_t blk, const int64_t* __restrict__ indptr,
    const int32_t* __restrict__ indices, const T* __restrict__ vals,
    const T* x, const T* __restrict__ rowscale, const T* __restrict__ addw,
    const T* addv, T* __restrict__ y, T* __restrict__ partial, T* red) {
  const int lane = threadIdx.x % VEC;
  const int64_t row = blk * (kThreads / VEC) + threadIdx.x / VEC;
  T sum = T(0);
  if (row < rows) {
    const int64_t end = indptr[row + 1];
    for (int64_t k = indptr[row] + lane; k < end; k += VEC)
      sum += vals[k] * (kReadOnly ? __ldg(x + indices[k]) : x[indices[k]]);
  }
  // every lane of the warp takes part in the shuffles, rows past the end
  // with a zero sum
#pragma unroll
  for (int off = VEC / 2; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, off, VEC);
  T dot = T(0);
  if (lane == 0 && row < rows) {
    T out = sum;
    if (rowscale != nullptr) out *= rowscale[row];
    if (addw != nullptr) out += addw[row] * addv[row];
    y[row] = out;
    if (partial != nullptr) dot = addv[row] * out;
  }
  if (partial != nullptr) {
    const T b = block_sum(dot, red);
    if (threadIdx.x == 0) *partial = b;
  }
}

}  // namespace ipxt
