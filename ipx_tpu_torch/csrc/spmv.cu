// K1 csr_spmv and K2 normal_apply: sparse matrix-vector products over CSR
// rows, for Hopper (sm_90a).
//
// Replaces: ipx_tpu/ops/spmv.py apply_csr / apply_csr_tree (a gather, a
// lane-major cumsum and a boundary difference), NormalMatrixDevice.apply /
// normal_apply_tree, the segment-sum SpMV _apply_seg of
// ipx_tpu/ops/device_cr2.py, and the per-block products A_p u + W_slack_p
// v_p of the row-blocked vector apply (ipx_tpu/parallel/sharding.py
// _apply_block, one per mesh device there). The cumsum and the segment ids
// existed because the TPU lowered neither a scatter nor a per-row loop well;
// here each CSR row is summed by its own group of lanes and both disappear.
//
// What bounds it on the H100: memory, and at the main path's sizes the
// launch. Per nonzero it reads a 4-byte column index and an 8-byte (f64) or
// 4-byte (f32) value, and gathers one entry of x, which stays in the 50 MB
// L2 cache (x has at most ~100k entries). There is about one multiply-add
// per 12-16 bytes, far below the card's ratio of compute to bandwidth, so no
// tensor-core path applies (f64 goes through the plain FP64 units). At
// m = 20 000 a product moves about 2.3 MB (0.7 us at 3.35 TB/s), less than a
// launch and the host's share of a call cost: the host side is one ctypes
// call through a plan that checked the operand once (kernels.SpmvPlan), and
// the P block products of a row-blocked apply are one launch
// (kernels.BlockSpmvPlan), not P.
//
// Design: a group of VEC lanes of one warp per row, VEC a power of two
// near the operand's mean row length (rows of A have ~10 nonzeros, rows of
// A' have 2), so neighbouring lanes read neighbouring nonzeros and short
// rows do not leave 30 of 32 lanes idle: for K2 the one at or above the
// mean (ops/spmv.py lanes_per_row), for K1's plans the one at or below it
// (kernels.k1_lanes; on A of the 20k LP 8 lanes, not 16, take 18-20% less
// device time). The row sum is a fixed shuffle tree, so results repeat
// exactly from run to run. spmv_block (spmv_block.cuh) holds one CUDA
// block's rows; both kernels below run it, and so do the K2 applies inside
// K3's cooperative solve (cr.cu), so they all round alike.
//
// K2 is two launches of the same kernel with epilogues:
//   u   = W_s * (A' v)                 (rowscale)
//   out = A u + W_slack * v            (addw, addv)
// and the second launch writes each block's partial of v.out; those are
// summed in a fixed order by reduce_sum below, or by the CR passes of cr.cu,
// never with atomics, so a run is repeatable. On the solver's path both
// halves run inside K3's one cooperative launch per CR solve (cr.cu), at
// the same lanes per row and into the same partial slots. The stand-alone
// apply with its dot, which the tests and chip_smoke.py call, is one
// cooperative launch too (ipxt_normal_apply, cr.cu); these two launches
// and reduce_sum stay as its three-launch form, for comparison, and serve
// K3's host-issued comparison form.
//
// The block products (block_spmv_kernel): out_p = A_p u + W_slack_p v_p over
// the P <= kMaxSplit row blocks of a row-blocked apply, with the partials of
// v_p . out_p. It takes the P blocks' own CSR operands (each block keeps its
// rows, as each rank of the reference holds its block, and the batched
// apply's K5 reads the same operands), so no second copy of A is kept. The
// CUDA blocks are laid out block by block, block p taking as many as its
// own launch would (blocks_for(rows_p, kThreads / vec_p)), so no CUDA block
// straddles two row blocks and each runs its row block's own VEC. A CUDA
// block finds its row block from its index against the P + 1 offsets, which
// it takes by value. Rows, lane trees and partial slots are then those of P
// separate launches of csr_spmv_kernel, and the results equal theirs bit for
// bit.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include "spmv_block.cuh"

namespace ipxt {
namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(int64_t rows, const int64_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const T* __restrict__ vals, const T* __restrict__ x,
                const T* __restrict__ rowscale, const T* __restrict__ addw,
                const T* __restrict__ addv, T* __restrict__ y,
                T* __restrict__ partials, const T* __restrict__ state) {
  __shared__ T red[kThreads];
  if (loop_done(state)) return;
  spmv_block<T, VEC, true>(
      rows, blockIdx.x, indptr, indices, vals, x, rowscale, addw, addv, y,
      partials != nullptr ? partials + blockIdx.x : nullptr, red);
}

// The block products over the P row blocks of o, CUDA block g the block
// products' block g (block_rows).
__global__ void __launch_bounds__(kThreads)
block_spmv_kernel(BlockOps o, const double* __restrict__ x,
                  const double* __restrict__ addw,
                  const double* __restrict__ addv, double* __restrict__ y,
                  double* __restrict__ partials,
                  const double* __restrict__ state) {
  __shared__ double red[kThreads];
  if (loop_done(state)) return;
  block_rows<true>(o, blockIdx.x, x, addw, addv, y, partials, red);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_sum_kernel(int64_t n, const T* __restrict__ in, T* __restrict__ out) {
  __shared__ T red[kThreads];
  const T s = sum_partials(in, n, red);
  if (threadIdx.x == 0) out[0] = s;
}

template <typename T, int VEC>
void launch_vec(int64_t rows, const int64_t* indptr, const int32_t* indices,
                const T* vals, const T* x, const T* rowscale, const T* addw,
                const T* addv, T* y, T* partials, const T* state,
                cudaStream_t stream) {
  const int64_t grid = blocks_for(rows, kThreads / VEC);
  if (grid == 0) return;
  csr_spmv_kernel<T, VEC><<<(unsigned)grid, kThreads, 0, stream>>>(
      rows, indptr, indices, vals, x, rowscale, addw, addv, y, partials,
      state);
}

template <typename T>
int csr_spmv(int64_t rows, const void* indptr, const void* indices,
             const void* vals, const void* x, const void* rowscale,
             const void* addw, const void* addv, void* y, void* partials,
             const void* state, int vec, void* stream) {
  auto ip = static_cast<const int64_t*>(indptr);
  auto ix = static_cast<const int32_t*>(indices);
  auto v = static_cast<const T*>(vals);
  auto xx = static_cast<const T*>(x);
  auto rs = static_cast<const T*>(rowscale);
  auto aw = static_cast<const T*>(addw);
  auto av = static_cast<const T*>(addv);
  auto yy = static_cast<T*>(y);
  auto pp = static_cast<T*>(partials);
  auto st = static_cast<const T*>(state);
  auto s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 2: launch_vec<T, 2>(rows, ip, ix, v, xx, rs, aw, av, yy, pp, st, s); break;
    case 4: launch_vec<T, 4>(rows, ip, ix, v, xx, rs, aw, av, yy, pp, st, s); break;
    case 8: launch_vec<T, 8>(rows, ip, ix, v, xx, rs, aw, av, yy, pp, st, s); break;
    case 16: launch_vec<T, 16>(rows, ip, ix, v, xx, rs, aw, av, yy, pp, st, s); break;
    case 32: launch_vec<T, 32>(rows, ip, ix, v, xx, rs, aw, av, yy, pp, st, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int reduce_sum(int64_t n, const void* in, void* out, void* stream) {
  reduce_sum_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const T*>(in), static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ipxt

// Number of blocks a launch with `vec` lanes per row uses over `rows` rows,
// which is the length of its partials.
extern "C" int64_t ipxt_spmv_blocks(int64_t rows, int vec) {
  return ipxt::blocks_for(rows, ipxt::kThreads / vec);
}

// y[i] = (sum_k vals[k] x[indices[k]]) * rowscale[i] + addw[i] addv[i];
// rowscale, addw/addv, partials and state may each be null. With partials,
// partials[b] = sum over block b's rows of addv[i] y[i].
extern "C" int ipxt_csr_spmv_f64(int64_t rows, const void* indptr,
                                 const void* indices, const void* vals,
                                 const void* x, const void* rowscale,
                                 const void* addw, const void* addv, void* y,
                                 void* partials, const void* state, int vec,
                                 void* stream) {
  return ipxt::csr_spmv<double>(rows, indptr, indices, vals, x, rowscale,
                                addw, addv, y, partials, state, vec, stream);
}

extern "C" int ipxt_csr_spmv_f32(int64_t rows, const void* indptr,
                                 const void* indices, const void* vals,
                                 const void* x, const void* rowscale,
                                 const void* addw, const void* addv, void* y,
                                 void* partials, const void* state, int vec,
                                 void* stream) {
  return ipxt::csr_spmv<float>(rows, indptr, indices, vals, x, rowscale, addw,
                               addv, y, partials, state, vec, stream);
}

// The block products of a row-blocked apply in one launch, float64:
// y[i] = (A_p x)[i - row_off[p]] + addw[i] addv[i] for the rows i of block
// p, and partials[g] the sum of addv[i] y[i] over the rows of CUDA block g.
// The host arrays row_off and blk_off (P + 1 each), vec, indptr, indices
// and vals (P each) are read during the call; blk_off must be the layout
// of P separate launches (ipxt_spmv_blocks of each block). addw and addv
// are required; partials and state may be null.
extern "C" int ipxt_block_spmv_f64(int P, const int64_t* row_off,
                                   const int64_t* blk_off, const int* vec,
                                   const void* const* indptr,
                                   const void* const* indices,
                                   const void* const* vals, const void* x,
                                   const void* addw, const void* addv,
                                   void* y, void* partials, const void* state,
                                   void* stream) {
  using namespace ipxt;
  BlockOps o;
  if (!make_block_ops(P, row_off, blk_off, vec, indptr, indices, vals, &o) ||
      !k1_layout(o) || addw == nullptr || addv == nullptr)
    return (int)cudaErrorInvalidValue;
  const int64_t grid = blk_off[P];
  if (grid == 0) return 0;
  block_spmv_kernel<<<(unsigned)grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      o, static_cast<const double*>(x), static_cast<const double*>(addw),
      static_cast<const double*>(addv), static_cast<double*>(y),
      static_cast<double*>(partials), static_cast<const double*>(state));
  return (int)cudaGetLastError();
}

// out[0] = sum of in[0..n), in a fixed order (one block).
extern "C" int ipxt_reduce_sum_f64(int64_t n, const void* in, void* out,
                                   void* stream) {
  return ipxt::reduce_sum<double>(n, in, out, stream);
}

extern "C" int ipxt_reduce_sum_f32(int64_t n, const void* in, void* out,
                                   void* stream) {
  return ipxt::reduce_sum<float>(n, in, out, stream);
}

extern "C" const char* ipxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
