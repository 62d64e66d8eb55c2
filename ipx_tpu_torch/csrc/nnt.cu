// K4 nnt and K14v block_spmv_sum: sums over CSR rows split at block bounds,
// for Hopper (sm_90a), float64.
//
// Replaces: ipx_tpu/ops/device_cr2.py DeviceSplittedCR._build.nnt (z =
// N (N' w), one jitted program); with column blocks,
// ipx_tpu/parallel/sharding.py ShardedSplittedNNt._build.nnt_local and its
// psum (sharding.py:560-569); and the first half of the row-blocked normal
// apply, u = W_struct * psum_p(A_p' v_p) (sharding.py:122-136). In the
// reference each block's product lands on its own device and psum joins
// them; on one card the join needs neither a parts array nor a pass of its
// own.
//
// The split layout (ops/spmv.py CsrOperand with bounds, split_rows in
// spmv_block.cuh): one CSR operand of the whole matrix, each row's entries
// cut at P - 1 column bounds into the blocks' segments, each block's segment
// summed by its own lane tree, the blocks' sums added in block order, times
// the row's scale:
//
//   K4   z = sum_p N_p (N_p' w): first u = N' w over the rows of N' (the
//        column blocks' u_p lie end to end, so this half needs no sum over
//        blocks), then the split sum over the rows of N with x = u. P = 1 is
//        plain N (N' w). One C entry, two forms: one cooperative launch with
//        a grid-wide barrier between the halves (cooperative_groups; u, at
//        most n doubles, stays in the 50 MB L2), or two launches on the
//        stream.
//   K14v u = W_struct * split sum over the rows of A' (the CSC arrays of A)
//        with the row blocks' bounds and x = v: the P K1 launches into a
//        (P, n) parts array and K14's pass over it become one launch that
//        writes u alone. It honours a CR loop's done flag as K14 does.
//        On the solver's path split_rows runs inside K15's cooperative
//        solve (sharded.cu); this launch serves K15's host-issued
//        comparison form, the tests and chip_smoke.py.
//
// What bounds them on the H100: memory, as K1. Per nonzero a 4-byte index,
// an 8-byte value and a gather of x that stays in L2; per row the row
// pointer and one output. The block compares and register sums are a few
// integer and FP64 operations per nonzero, far below the card's ratio of
// operations to bytes. At the main path's sizes (m = 20 000) a launch moves
// about 2-3 MB, so launch latency and the host's share of a call weigh as
// much as the bytes: K4 is one C call per apply and, in its cooperative
// form, one launch.
//
// Rounding: each block's segment is summed by its own lane tree, so the
// results are not today's per-block K1 sums bit for bit (a block's segment
// starts at another lane than its own CSR row did). They repeat exactly from
// run to run: a fixed lane tree, a fixed block order, no atomics.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns the CUDA error of its launch; a refused cooperative launch is
// returned as such, never replaced by the two-launch form.

#include <cooperative_groups.h>

#include "spmv_block.cuh"

namespace cg = cooperative_groups;

namespace ipxt {
namespace {

template <int VEC>
__global__ void __launch_bounds__(kThreads)
split_kernel(Rows op, Split s, const double* __restrict__ x,
             const double* __restrict__ scale, double* __restrict__ y,
             const double* __restrict__ state) {
  if (loop_done(state)) return;
  split_rows<VEC, true>(op, s, x, scale, y);
}

struct NntArgs {
  Rows nt;      // N' (its rows are the columns of N)
  Rows n;       // N, split at the column blocks' bounds
  Split s;
  const double* w;
  double* u;
  double* z;
};

// Both halves of K4 in one cooperative launch.
__global__ void __launch_bounds__(kThreads) nnt_coop_kernel(NntArgs a) {
  Split whole = {};
  whole.P = 1;
  split_rows_any<true>(a.nt, whole, a.w, nullptr, a.u);
  cg::this_grid().sync();  // every u is written, and visible, past here
  split_rows_any<false>(a.n, a.s, a.u, nullptr, a.z);
}

int launch_split(const Rows& op, const Split& s, const double* x,
                 const double* scale, double* y, const double* state,
                 cudaStream_t stream) {
  const int64_t grid = blocks_for(op.rows, kThreads / op.vec);
  if (grid == 0) return 0;
  const unsigned g = (unsigned)grid;
  switch (op.vec) {
    case 2: split_kernel<2><<<g, kThreads, 0, stream>>>(op, s, x, scale, y, state); break;
    case 4: split_kernel<4><<<g, kThreads, 0, stream>>>(op, s, x, scale, y, state); break;
    case 8: split_kernel<8><<<g, kThreads, 0, stream>>>(op, s, x, scale, y, state); break;
    case 16: split_kernel<16><<<g, kThreads, 0, stream>>>(op, s, x, scale, y, state); break;
    default: split_kernel<32><<<g, kThreads, 0, stream>>>(op, s, x, scale, y, state); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ipxt

using namespace ipxt;

// K4: z = sum_p N_p (N_p' w) over the P column blocks of N whose P - 1
// interior bounds are the host array `bounds`; u (the rows of N') is
// scratch. cooperative != 0: one cooperative launch; else two launches.
extern "C" int ipxt_nnt_f64(int64_t rows_t, const void* indptr_t,
                            const void* indices_t, const void* vals_t,
                            int vec_t, int64_t rows_n, const void* indptr_n,
                            const void* indices_n, const void* vals_n,
                            int vec_n, int P, const int64_t* bounds,
                            const void* w, void* u, void* z, int cooperative,
                            void* stream) {
  NntArgs a;
  if (!valid_vec(vec_t) || !valid_vec(vec_n) || !make_split(P, bounds, &a.s))
    return (int)cudaErrorInvalidValue;
  a.nt = make_rows(rows_t, indptr_t, indices_t, vals_t, vec_t);
  a.n = make_rows(rows_n, indptr_n, indices_n, vals_n, vec_n);
  a.w = static_cast<const double*>(w);
  a.u = static_cast<double*>(u);
  a.z = static_cast<double*>(z);
  auto st = static_cast<cudaStream_t>(stream);
  if (!cooperative) {
    Split whole = {};
    whole.P = 1;
    const int err = launch_split(a.nt, whole, a.w, nullptr, a.u, nullptr, st);
    if (err != 0) return err;
    return launch_split(a.n, a.s, a.u, nullptr, a.z, nullptr, st);
  }
  const int64_t need_t = blocks_for(rows_t, kThreads / vec_t);
  const int64_t need_n = blocks_for(rows_n, kThreads / vec_n);
  int64_t grid = need_t > need_n ? need_t : need_n;
  if (grid == 0) return 0;
  int64_t cap = 0;
  const int err = coop_capacity<nnt_coop_kernel>(&cap);
  if (err != 0) return err;
  if (grid > cap) grid = cap;  // the rows are walked grid-stride
  void* args[] = {&a};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      (const void*)nnt_coop_kernel, dim3((unsigned)grid), dim3(kThreads),
      args, 0, st);
  // read and clear the last error too, so that a refusal is reported here
  // and not by the next launch of another entry point
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}

// K14v: y[i] = scale[i] * (((s_0 + s_1) + ...) + s_{P-1}), s_p the sum over
// row i's entries of block p (column in [bounds[p - 1], bounds[p])) of
// vals[k] x[indices[k]]; scale and state may be null.
extern "C" int ipxt_block_spmv_sum_f64(int64_t rows, const void* indptr,
                                       const void* indices, const void* vals,
                                       int vec, int P, const int64_t* bounds,
                                       const void* x, const void* scale,
                                       void* y, const void* state,
                                       void* stream) {
  Split s;
  if (!valid_vec(vec) || !make_split(P, bounds, &s))
    return (int)cudaErrorInvalidValue;
  return launch_split(make_rows(rows, indptr, indices, vals, vec), s,
                      static_cast<const double*>(x),
                      static_cast<const double*>(scale),
                      static_cast<double*>(y),
                      static_cast<const double*>(state),
                      static_cast<cudaStream_t>(stream));
}
