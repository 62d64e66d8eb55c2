// The CSR row bodies shared by the kernels that take a vector:
//
//   spmv_block    K1's row body, run by csr_spmv and the block products of
//                 a row-blocked apply (spmv.cu), the K2 applies inside K3's
//                 cooperative solve (cr.cu) and the block products inside
//                 K15's (sharded.cu), so that all of them round alike;
//   split_rows    the split sums of K4 and K14v (nnt.cu), run inside K15's
//                 cooperative solve too;
//   block_rows    one CUDA block of the block products over P row blocks.
//
// and the operands they take: Rows (one CSR operand), Split (the interior
// bounds of a split operand) and BlockOps (the P row blocks of a
// row-blocked apply), each passed by value in a kernel's arguments.
#pragma once

#include "common.cuh"

namespace ipxt {

// One CSR operand, summed at vec lanes a row (a power of two in [2, 32]);
// vals are of the kernel's working type.
struct Rows {
  int64_t rows;
  const int64_t* indptr;
  const int32_t* indices;
  const void* vals;
  int vec;
};

inline Rows make_rows(int64_t rows, const void* indptr, const void* indices,
                      const void* vals, int vec) {
  Rows r;
  r.rows = rows;
  r.indptr = static_cast<const int64_t*>(indptr);
  r.indices = static_cast<const int32_t*>(indices);
  r.vals = vals;
  r.vec = vec;
  return r;
}

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
// pass writes x (K3's sres and u, K15's u), and the gathers are plain
// loads, which the grid barrier makes see those writes; x and addv are
// therefore not __restrict__.
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

// -- the split layout (ops/spmv.py CsrOperand with bounds) -------------------
//
// One CSR operand of the whole matrix and P - 1 column bounds c_1 <= ... <=
// c_{P-1} (c_0 = 0, c_P = cols). The entries of row i with column in
// [c_p, c_{p+1}) are block p's; the column indices of a row are sorted, so
// they form one segment. Each entry finds its block by comparing its column
// with the bounds, which sit in registers (P <= kMaxSplit), and adds into
// that block's register sum; each block's sum is then a fixed shuffle tree
// over the row's lanes, and the row's value is ((s_0 + s_1) + s_2) + ... +
// s_{P-1}, in block order, times the row's scale.

// the P - 1 interior bounds of a split, by value in the kernel's arguments
struct Split {
  int64_t bound[kMaxSplit - 1];
  int P;
};

// Fills s from P and the P - 1 host bounds; false when they are not a
// split the split sums take.
inline bool make_split(int P, const int64_t* bounds, Split* s) {
  if (P < 1 || P > kMaxSplit) return false;
  *s = Split{};
  s->P = P;
  for (int q = 0; q + 1 < P; ++q) {
    s->bound[q] = bounds[q];
    if (q > 0 && bounds[q] < bounds[q - 1]) return false;
  }
  return true;
}

// y[i] = scale[i] * (split sum of row i of op times x), float64, rows walked
// grid-stride, so the result does not depend on the grid. kReadOnly as for
// spmv_block: a cooperative kernel reads an x that it wrote with plain
// loads.
template <int VEC, bool kReadOnly>
__device__ __forceinline__ void split_rows(const Rows& op, const Split& s,
                                           const double* x,
                                           const double* scale, double* y) {
  constexpr int kRowsPerBlock = kThreads / VEC;
  const double* vals = static_cast<const double*>(op.vals);
  const int lane = threadIdx.x % VEC;
  const int64_t stride = (int64_t)gridDim.x * kRowsPerBlock;
  // the first row of this thread's warp: the loop's test is the warp's, so
  // every lane of a warp runs the shuffles together, rows past the end with
  // zero sums
  const int64_t warp_row = (int64_t)blockIdx.x * kRowsPerBlock +
                           (threadIdx.x / 32) * (32 / VEC);
  const int group = (threadIdx.x % 32) / VEC;
  for (int64_t base = warp_row; base < op.rows; base += stride) {
    const int64_t row = base + group;
    double acc[kMaxSplit];
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q) acc[q] = 0.0;
    if (row < op.rows) {
      const int64_t end = op.indptr[row + 1];
      for (int64_t k = op.indptr[row] + lane; k < end; k += VEC) {
        const int32_t c = op.indices[k];
        const double t = vals[k] * (kReadOnly ? __ldg(x + c) : x[c]);
        int p = 0;
#pragma unroll
        for (int q = 0; q < kMaxSplit - 1; ++q)
          p += (q < s.P - 1 && c >= s.bound[q]) ? 1 : 0;
#pragma unroll
        for (int q = 0; q < kMaxSplit; ++q)
          if (q == p) acc[q] += t;
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q) {
      if (q < s.P) {  // the same for every thread
#pragma unroll
        for (int off = VEC / 2; off > 0; off >>= 1)
          acc[q] += __shfl_down_sync(0xffffffffu, acc[q], off, VEC);
      }
    }
    if (lane == 0 && row < op.rows) {
      double total = acc[0];
#pragma unroll
      for (int q = 1; q < kMaxSplit; ++q)
        if (q < s.P) total += acc[q];
      if (scale != nullptr) total *= scale[row];
      y[row] = total;
    }
  }
}

template <bool kReadOnly>
__device__ __forceinline__ void split_rows_any(const Rows& op,
                                               const Split& s,
                                               const double* x,
                                               const double* scale,
                                               double* y) {
  switch (op.vec) {
    case 2: split_rows<2, kReadOnly>(op, s, x, scale, y); break;
    case 4: split_rows<4, kReadOnly>(op, s, x, scale, y); break;
    case 8: split_rows<8, kReadOnly>(op, s, x, scale, y); break;
    case 16: split_rows<16, kReadOnly>(op, s, x, scale, y); break;
    default: split_rows<32, kReadOnly>(op, s, x, scale, y); break;
  }
}

// -- the P row blocks of a row-blocked apply ----------------------------------
//
// Block p holds rows [row_off[p], row_off[p + 1]) of the output, the CUDA
// blocks (and partial slots) [blk_off[p], blk_off[p + 1]) of a launch over
// all of them, and its own CSR operand (A_p, its rows local), summed at
// vec[p] lanes a row by K1's row body. nblk = blk_off[P]. Taken by value.
struct BlockOps {
  int P;
  int64_t row_off[kMaxSplit + 1];
  int64_t blk_off[kMaxSplit + 1];
  int vec[kMaxSplit];
  const int64_t* indptr[kMaxSplit];
  const int32_t* indices[kMaxSplit];
  const double* vals[kMaxSplit];
  int64_t nblk;
};

// Fills o from the host arrays row_off and blk_off (P + 1 each), indptr,
// indices and vals (P each) and, where given, vec (P); false when they do
// not describe P <= kMaxSplit row blocks from row 0 and CUDA block 0.
inline bool make_block_ops(int P, const int64_t* row_off,
                           const int64_t* blk_off, const int* vec,
                           const void* const* indptr,
                           const void* const* indices,
                           const void* const* vals, BlockOps* o) {
  if (P < 1 || P > kMaxSplit || row_off[0] != 0 || blk_off[0] != 0)
    return false;
  *o = BlockOps{};
  o->P = P;
  for (int p = 0; p <= P; ++p) {
    if (p > 0 && (row_off[p] < row_off[p - 1] || blk_off[p] < blk_off[p - 1]))
      return false;
    o->row_off[p] = row_off[p];
    o->blk_off[p] = blk_off[p];
  }
  for (int p = 0; p < P; ++p) {
    o->vec[p] = vec != nullptr ? vec[p] : 0;
    o->indptr[p] = static_cast<const int64_t*>(indptr[p]);
    o->indices[p] = static_cast<const int32_t*>(indices[p]);
    o->vals[p] = static_cast<const double*>(vals[p]);
  }
  o->nblk = blk_off[P];
  return true;
}

// True when blk_off is the layout of P separate K1 launches, block p taking
// blocks_for(rows_p, kThreads / vec[p]) CUDA blocks at a valid vec[p].
inline bool k1_layout(const BlockOps& o) {
  for (int p = 0; p < o.P; ++p) {
    if (!valid_vec(o.vec[p])) return false;
    const int64_t rows = o.row_off[p + 1] - o.row_off[p];
    if (o.blk_off[p + 1] - o.blk_off[p] !=
        blocks_for(rows, kThreads / o.vec[p]))
      return false;
  }
  return true;
}

// The row block of CUDA block g of a launch over the blocks of o: the last
// p with blk_off[p] <= g (an empty row block of K1's layout has no CUDA
// block, so the last such p is the one holding g). Every index is a
// constant after unrolling, so the arguments stay in the parameter bank.
__device__ __forceinline__ int block_of_ops(const BlockOps& o, int64_t g) {
  int p = 0;
#pragma unroll
  for (int q = 1; q < kMaxSplit; ++q)
    if (q < o.P && o.blk_off[q] <= g) p = q;
  return p;
}

// CUDA block g of the block products over o: y[i] = (A_p x)[i - row_off[p]]
// + addw[i] addv[i] for the rows i of its row block p at vec[p] lanes a
// row, and partials[g] the block's sum of addv[i] y[i] (partials may be
// null). y, addw and addv point at row 0 of the whole output. The same
// rows, lane trees and partial slot as block g - blk_off[p] of a separate
// K1 launch on A_p.
template <bool kReadOnly>
__device__ __forceinline__ void block_rows(const BlockOps& o, int64_t g,
                                           const double* x,
                                           const double* addw,
                                           const double* addv, double* y,
                                           double* partials, double* red) {
  const int p = block_of_ops(o, g);
  // the fields of row block p, read with constant indices (see
  // block_of_ops)
  int64_t r0 = o.row_off[0], r1 = o.row_off[1], b0 = o.blk_off[0];
  int vec = o.vec[0];
  const int64_t* ip = o.indptr[0];
  const int32_t* ix = o.indices[0];
  const double* va = o.vals[0];
#pragma unroll
  for (int q = 1; q < kMaxSplit; ++q) {
    if (q == p) {
      r0 = o.row_off[q];
      r1 = o.row_off[q + 1];
      b0 = o.blk_off[q];
      vec = o.vec[q];
      ip = o.indptr[q];
      ix = o.indices[q];
      va = o.vals[q];
    }
  }
  double* part = partials != nullptr ? partials + g : nullptr;
  const int64_t rows = r1 - r0, blk = g - b0;
  switch (vec) {  // the same for every thread of the block
    case 2: spmv_block<double, 2, kReadOnly>(rows, blk, ip, ix, va, x, nullptr, addw + r0, addv + r0, y + r0, part, red); break;
    case 4: spmv_block<double, 4, kReadOnly>(rows, blk, ip, ix, va, x, nullptr, addw + r0, addv + r0, y + r0, part, red); break;
    case 8: spmv_block<double, 8, kReadOnly>(rows, blk, ip, ix, va, x, nullptr, addw + r0, addv + r0, y + r0, part, red); break;
    case 16: spmv_block<double, 16, kReadOnly>(rows, blk, ip, ix, va, x, nullptr, addw + r0, addv + r0, y + r0, part, red); break;
    default: spmv_block<double, 32, kReadOnly>(rows, blk, ip, ix, va, x, nullptr, addw + r0, addv + r0, y + r0, part, red); break;
  }
}

}  // namespace ipxt
