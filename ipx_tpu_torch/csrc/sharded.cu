// K14 block_sum, K15 sharded_cr_step and K16 sharded_batched_cr_step: the
// row-blocked ("sharded") KKT solves on one card, for Hopper (sm_90a).
//
// Replaces: ipx_tpu/parallel/sharding.py. There each of P mesh devices
// holds one contiguous row block of A (or, for phase 2's N N', one column
// block of N) and jax.lax.psum / pmax over the mesh axis join the blocks'
// results. Here the P blocks live on one card (parallel/sharding.py runs
// each block's products through K1 / K5 on the block's own CSR and CSC
// operands), and the collectives become reductions over the P block
// results in a fixed block order p = 0..P-1, so a solve gives the answers P
// ranks would, every sum in the same order, and two runs agree bit for bit.
// No atomics anywhere. Over a mesh of processes (parallel/mesh.py) each
// rank holds one row block and runs the host-issued passes of K15 and K16
// over it alone; the other blocks' partials come from the other ranks by a
// gather, and the sums over them keep the same order.
//
//   K14 block_sum   out = scale * (((part_0 + part_1) + part_2) + ...): the
//                   psum of A_p' v_p (scaled by W_struct), of A_p' V_p, and
//                   of N_p (N_p' w). Replaces the psum of
//                   sharding.py:122-136, 162-175 and 560-569.
//   K15 sharded_cr_step  one ShardedDiagCR or sharded_cr_solve loop
//                   (sharding.py:221-273, 348-385) in one cooperative launch
//                   (scr_solve_kernel), as K3's CR (cr.cu): the trips run in
//                   the kernel, each trip's normal apply inside it (K14v's
//                   split sum, split_rows, then the block products, K1's row
//                   body at each block's own lanes a row, block_rows; both
//                   spmv_block.cuh), with grid-wide barriers after kSPassA,
//                   kSPassB and each half of the apply, four a trip. Every
//                   dot is the ordered sum over the blocks of the block's
//                   partials, and the residual norm is the max over all of
//                   them (the pmax).
//   K16 sharded_batched_cr_step  the passes of sharded_batched_cr_solve
//                   (sharding.py:429-475): the lane-masked CR over (m, B)
//                   arrays, B contiguous. Its lane reductions run across
//                   blocks as K10's do (common.cuh): a reducing pass writes
//                   per-block, per-lane partials and a finishing launch
//                   gives every lane one warp. K7's one-thread-per-lane
//                   pass is not copied. Its normal apply is one fused launch
//                   a trip (block_normal_kernel) where the columns of A are
//                   short (kernels.BlockNormalBatchedPlan), as K6's (spmm.cu):
//                   each row block on its own K5 grid, each column's P
//                   first-pass products and K14's sum of them recomputed per
//                   nonzero, so the (P, n, B) parts and the (n, B) U are
//                   never written; elsewhere the three-stage form, P K5
//                   launches on the A_p', K14, P K5 launches on the A_p.
//
// Stopping, in K15's one launch. Every block derives each stop decision (the
// loop test, the iteration limit, the ladder of ShardedDiagCR) from the same
// partials summed in the same order and from scalars it holds itself (k,
// cdot, the error code of the trip before), so all blocks leave on the same
// trip; only block 0 writes the state, which the host reads once. A grid
// is what fits on the card (coop_capacity); each physical block walks the
// virtual blocks of a pass grid-stride and a virtual block writes the
// partial slot that the separate launch writes, so every sum keeps its
// order. An element falls to the same thread in every elementwise pass, so
// kSPassC needs no barrier before the next kSPassA. The host-issued form
// (scr_step_kernel, one pass a launch, the apply as a K14v and a K1 launch)
// stays for comparison only; both run the same pass bodies and row bodies
// and agree bit for bit.
//
// What bounds them on the H100. K14 reads P + 1 arrays and writes one, one
// add per value read: memory. K15's passes stream two to six m-vectors for
// a few flops per entry, and its apply reads A' and the A_p, about 6 MB at
// m = 20 000: a few microseconds of bytes a trip, so the four grid barriers
// and the loads' latency set its time, as for K3; the host-issued form paid
// five launches and ctypes calls a trip instead. K16's elementwise passes stream
// 4-9 (m, B) arrays, 41 MB each at m = 20 000, B = 256 in f64, and are
// memory bound, its lane passes read the partials once, and its fused apply
// is bound as K6's: the chain of dependent index loads before each gather
// of a row of V. A trip is about a millisecond of device time against
// about a dozen launches, so K16's loop stays host-issued. K14 is one pass
// over the parts.
//
// Blocks of rows. Row block p holds rows [row_off[p], row_off[p + 1]), and
// the CUDA blocks of a pass are laid out block by block (blk_off), so no
// CUDA block straddles two row blocks and the partials of row block p are
// the slice [blk_off[p], blk_off[p + 1]). The K1 / K5 partials of v.Cv are
// laid out the same way (pc_off). A row block may be empty.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include <cooperative_groups.h>

#include "spmm_row.cuh"
#include "spmv_block.cuh"

namespace cg = cooperative_groups;

namespace ipxt {
namespace {

// -- shared helpers ----------------------------------------------------------

// The row block that CUDA block g of a pass belongs to.
__device__ __forceinline__ int64_t block_of(const int64_t* __restrict__ off,
                                            int64_t P, int64_t g) {
  int64_t p = 0;
  while (p + 1 < P && off[p + 1] <= g) ++p;
  return p;
}

// The ordered sum over the row blocks of the block sums of their partials:
// ((s_0 + s_1) + s_2) + ..., s_p the fixed-order sum of part[off[p] ..
// off[p + 1]). Every block of a pass derives the same value.
// part is not __restrict__: K15's cooperative solve reads partials that
// other blocks wrote earlier in the same launch.
template <typename T>
__device__ T blocks_sum(const T* part, const int64_t* __restrict__ off,
                        int64_t P, T* red) {
  T total = T(0);
  for (int64_t p = 0; p < P; ++p) {
    const T s = sum_partials(part + off[p], off[p + 1] - off[p], red);
    total = p == 0 ? s : total + s;
  }
  return total;
}

// -- K14 ---------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_sum_kernel(int64_t P, int64_t L, const T* __restrict__ parts,
                 const T* __restrict__ scale, T* __restrict__ out,
                 const T* __restrict__ state) {
  if (loop_done(state)) return;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < L;
       j += (int64_t)gridDim.x * kThreads) {
    T s = parts[j];
    for (int64_t p = 1; p < P; ++p) s = add_rn(s, parts[p * L + j]);
    if (scale != nullptr) s = mul_rn(s, scale[j]);
    out[j] = s;
  }
}

// -- K15 ---------------------------------------------------------------------

enum ScrPhase { kSInit = 0, kSStart = 1, kSPassA = 2, kSPassB = 3,
                kSPassC = 4 };

// slots of the state beyond common.cuh's: the error code of the running
// trip in the host-issued form (kErr holds that of the trip before; K15 has
// no recheck, so it takes the slot of K3's rpn), and the residual norm the
// loop stopped at
enum ScrSlot { kErrTrip = kRpn, kResnorm = 7 };

template <typename T>
struct ScrArgs {
  int64_t m, P;
  int64_t k;          // the host's trip count (host-issued form only)
  int64_t maxiter;
  T tol;
  int ladder;         // ShardedDiagCR: scaled norm and the error ladder
  const int64_t* row_off;   // (P + 1)
  const int64_t* blk_off;   // (P + 1), CUDA blocks of an elementwise pass
  const int64_t* pc_off;    // (P + 1), K1 partials of v.Cv per row block
  const T* invd;      // 1 / diag
  const T* resscale;  // null for the unscaled norm
  T* y;
  T* r;
  T* s;
  T* cs;              // C s, written by the block products
  T* d;
  T* cd;
  T* pa;              // (2, nblk): sums of cd.(cd / diag), then maxima
  int64_t nblk;
  T* pc;
  T* state;
};

// -- the pass bodies, for virtual block vb of an elementwise pass -----------
// Element i of virtual block vb: row block p's blocks lie end to end
// (blk_off), so an element always falls to the same thread of the same
// virtual block, in every pass and in both forms.
template <typename T>
__device__ __forceinline__ int64_t scr_row(const ScrArgs<T>& a, int64_t vb,
                                           bool* in) {
  const int64_t p = block_of(a.blk_off, a.P, vb);
  const int64_t i =
      a.row_off[p] + (vb - a.blk_off[p]) * kThreads + threadIdx.x;
  *in = i < a.row_off[p + 1];
  return i;
}

// kSInit: s = r / diag, y = 0; r holds the right-hand side
template <typename T>
__device__ __forceinline__ void scr_init(const ScrArgs<T>& a, int64_t vb) {
  bool in;
  const int64_t i = scr_row(a, vb, &in);
  if (in) {
    a.s[i] = a.r[i] * a.invd[i];
    a.y[i] = T(0);
  }
}

// kSStart, after C s: d = s, cd = C s
template <typename T>
__device__ __forceinline__ void scr_start(const ScrArgs<T>& a, int64_t vb) {
  bool in;
  const int64_t i = scr_row(a, vb, &in);
  if (in) {
    a.d[i] = a.s[i];
    a.cd[i] = a.cs[i];
  }
}

// kSPassA: the partials of cd.(cd / diag) and of the residual norm
template <typename T>
__device__ __forceinline__ void scr_pass_a(const ScrArgs<T>& a, int64_t vb,
                                           T* red) {
  bool in;
  const int64_t i = scr_row(a, vb, &in);
  T dsum = T(0), rmax = T(0);
  if (in) {
    const T c = a.cd[i];
    dsum = c * (c * a.invd[i]);
    rmax = abs_val(a.resscale != nullptr ? a.resscale[i] * a.r[i] : a.r[i]);
  }
  const T bs = block_sum(dsum, red);
  const T bm = block_max(rmax, red);
  if (threadIdx.x == 0) {
    a.pa[vb] = bs;
    a.pa[a.nblk + vb] = bm;
  }
}

// kSPassB's test on trip k, with cdot and the error code `err` of the trip
// before: true when the loop stops (the reference's while_loop test: a NaN
// norm stops it), with the residual norm; else the step length and the
// trip's own error code (ShardedDiagCR's ladder: 202, 203, 205). Every
// thread of every block gets the same answer from the same partials.
template <typename T>
__device__ __forceinline__ bool scr_stop(const ScrArgs<T>& a, int64_t k,
                                         T cdot, T err, T* red, T* resnorm,
                                         T* alpha, T* err_trip) {
  const T pdot = blocks_sum(a.pa, a.blk_off, a.P, red);
  *resnorm = max_partials(a.pa + a.nblk, a.nblk, red);
  if (!(*resnorm > a.tol) || k >= a.maxiter || err != T(0)) return true;
  T al = cdot / pdot;
  int e = 0;
  if (a.ladder) {
    if (cdot <= T(0)) e = 202;
    if (pdot <= T(0)) e = 203;
    if (!isfinite(al)) e = 205;
    if (e != 0) al = T(0);
  }
  *alpha = al;
  *err_trip = T(e);
  return false;
}

// kSPassB's update: y += alpha d, r -= alpha cd, s -= alpha cd / diag
template <typename T>
__device__ __forceinline__ void scr_pass_b(const ScrArgs<T>& a, int64_t vb,
                                           T alpha) {
  bool in;
  const int64_t i = scr_row(a, vb, &in);
  if (in) {
    const T c = a.cd[i];
    a.y[i] += alpha * a.d[i];
    a.r[i] -= alpha * c;
    a.s[i] -= alpha * (c * a.invd[i]);
  }
}

// kSPassC's scalars, after C s: beta from cdot_new, and the trip's error
// code (*err): beta follows the trip's own error, as the reference's `ok`
// does, and a cdot_new that is not finite is 205
template <typename T>
__device__ __forceinline__ T scr_beta(const ScrArgs<T>& a, T cdot_n, T cdot,
                                      T err_trip, T* err) {
  T beta = cdot_n / cdot;
  T e = T(0);
  if (a.ladder) {
    e = err_trip;
    if (e != T(0)) beta = T(0);
    else if (!isfinite(cdot_n)) e = T(205);
  }
  *err = e;
  return beta;
}

// kSPassC's update: d = s + beta d, cd = C s + beta cd
template <typename T>
__device__ __forceinline__ void scr_pass_c(const ScrArgs<T>& a, int64_t vb,
                                           T beta) {
  bool in;
  const int64_t i = scr_row(a, vb, &in);
  if (in) {
    a.d[i] = a.s[i] + beta * a.d[i];
    a.cd[i] = a.cs[i] + beta * a.cd[i];
  }
}

// -- the host-issued form: one pass a launch --------------------------------
// The launch runs the virtual blocks vb0 .. vb0 + gridDim.x - 1 of the pass:
// all of them on one card (vb0 = 0), a mesh rank's own row block's on a
// mesh (parallel/mesh.py), whose partials of the other blocks come from the
// other ranks. The first CUDA block writes the state, so every rank keeps
// its own copy of it.
template <typename T>
__global__ void __launch_bounds__(kThreads) scr_step_kernel(int phase,
                                                            int64_t vb0,
                                                            ScrArgs<T> a) {
  __shared__ T red[kThreads];
  T* st = a.state;
  if (loop_done(st)) return;
  const int64_t g = vb0 + blockIdx.x;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const T cdot = st[kCdot0 + (a.k & 1)];
  switch (phase) {
    case kSInit:
      scr_init(a, g);
      break;
    case kSStart: {
      const T cdot0 = blocks_sum(a.pc, a.pc_off, a.P, red);
      scr_start(a, g);
      if (lead) st[kCdot0] = cdot0;
      break;
    }
    case kSPassA:
      scr_pass_a(a, g, red);
      break;
    case kSPassB: {
      T resnorm, alpha, err_trip;
      if (scr_stop(a, a.k, cdot, st[kErr], red, &resnorm, &alpha,
                   &err_trip)) {
        if (lead) {
          st[kResnorm] = resnorm;
          st[kDone] = T(1);
        }
        return;
      }
      if (lead) st[kErrTrip] = err_trip;
      scr_pass_b(a, g, alpha);
      break;
    }
    case kSPassC: {
      const T cdot_n = blocks_sum(a.pc, a.pc_off, a.P, red);
      T err;
      const T beta = scr_beta(a, cdot_n, cdot, st[kErrTrip], &err);
      scr_pass_c(a, g, beta);
      if (lead) {
        st[kCdot0 + ((a.k + 1) & 1)] = cdot_n;
        st[kIt] = T(a.k + 1);
        st[kErr] = err;
      }
      break;
    }
  }
}

// -- the cooperative form: a whole solve in one launch ----------------------
struct ScrSolveArgs {
  ScrArgs<double> a;
  Rows at;            // the whole A' (n rows), split at the row bounds
  Split split;
  BlockOps ops;       // the blocks' A_p, K1's layout of the block products
  const double* w_struct;
  const double* w_slack;
  double* u;          // (n,) scratch
};

// cs = C s and the block products' partials of s.cs in pc, K14v's half and
// the block products' half with a barrier after each; the caller has put a
// barrier after the pass that wrote s.
__device__ __forceinline__ void scr_apply(const ScrSolveArgs& s,
                                          cg::grid_group& grid, double* red) {
  const ScrArgs<double>& a = s.a;
  split_rows_any<false>(s.at, s.split, a.s, s.w_struct, s.u);
  grid.sync();
  for (int64_t vb = blockIdx.x; vb < s.ops.nblk; vb += gridDim.x)
    block_rows<false>(s.ops, vb, s.u, s.w_slack, a.s, a.cs, a.pc, red);
  grid.sync();
}

__global__ void __launch_bounds__(kThreads) scr_solve_kernel(ScrSolveArgs s) {
  __shared__ double red[kThreads];
  cg::grid_group grid = cg::this_grid();
  const ScrArgs<double>& a = s.a;
  double* st = a.state;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const int64_t g0 = blockIdx.x, gs = gridDim.x;
  for (int64_t vb = g0; vb < a.nblk; vb += gs) scr_init(a, vb);
  grid.sync();
  scr_apply(s, grid, red);
  double cdot = blocks_sum(a.pc, a.pc_off, a.P, red);
  for (int64_t vb = g0; vb < a.nblk; vb += gs) scr_start(a, vb);
  double err = 0.0;
  int64_t applies = 1;
  for (int64_t k = 0;; ++k) {
    for (int64_t vb = g0; vb < a.nblk; vb += gs) scr_pass_a(a, vb, red);
    grid.sync();
    double resnorm, alpha, err_trip;
    if (scr_stop(a, k, cdot, err, red, &resnorm, &alpha, &err_trip)) {
      if (lead) {
        st[kIt] = double(k);
        st[kErr] = err;
        st[kResnorm] = resnorm;
        st[kApplies] = double(applies);
        st[kDone] = 1.0;
      }
      return;  // every block, on this same trip
    }
    for (int64_t vb = g0; vb < a.nblk; vb += gs) scr_pass_b(a, vb, alpha);
    grid.sync();
    scr_apply(s, grid, red);
    ++applies;
    const double cdot_n = blocks_sum(a.pc, a.pc_off, a.P, red);
    const double beta = scr_beta(a, cdot_n, cdot, err_trip, &err);
    for (int64_t vb = g0; vb < a.nblk; vb += gs) scr_pass_c(a, vb, beta);
    cdot = cdot_n;
  }
}

// -- K16's fused block normal apply ----------------------------------------

// The row block that row c of A falls in: the interior bounds row_off[1 ..
// P - 1] at or below c, compared with constant indices.
__device__ __forceinline__ int row_block_of(const BlockOps& o, int64_t c) {
  int q = 0;
#pragma unroll
  for (int r = 1; r < kMaxSplit; ++r)
    q += (r < o.P && c >= o.row_off[r]) ? 1 : 0;
  return q;
}

// Folds row block q's sum t into s as K14 sums the parts, s = t at q = 0,
// else s = add_rn(s, t); then t = 0.
template <int VW>
__device__ __forceinline__ void fold_block(int q, double (&s)[VW],
                                           double (&t)[VW]) {
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    s[j] = q == 0 ? t[j] : add_rn(s[j], t[j]);
    t[j] = 0.0;
  }
}

// s = K14's sum over the row blocks q = 0..P-1 of (A_q' V_q)[col, lanes]
// for a column col of A whose entries are [begin, end) of the whole A'
// split at the row blocks' bounds (its CSR order, rows ascending, so block
// q's entries are one segment and in the order of row col of A_q'): each
// segment summed as K5's launch on A_q' sums its row col, an empty segment
// a zero, two gathers in flight (loaded, issued, then added in order, as
// K5's row_gather).
template <int VW>
__device__ __forceinline__ void column_sum(
    const BlockOps& o, int64_t begin, int64_t end,
    const int32_t* __restrict__ t_indices, const double* __restrict__ t_vals,
    const double* __restrict__ V, int64_t B, int64_t lane0, double (&s)[VW]) {
  double t[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) s[j] = t[j] = 0.0;
  int q = 0;
  int64_t k = begin;
  for (; k + 2 <= end; k += 2) {
    const int32_t c0 = t_indices[k], c1 = t_indices[k + 1];
    const double a0 = t_vals[k], a1 = t_vals[k + 1];
    double u0[VW], u1[VW];
    ldg_vec<double, VW>(V + (int64_t)c0 * B + lane0, u0);
    ldg_vec<double, VW>(V + (int64_t)c1 * B + lane0, u1);
    for (const int q0 = row_block_of(o, c0); q < q0; ++q) fold_block(q, s, t);
#pragma unroll
    for (int j = 0; j < VW; ++j) t[j] += a0 * u0[j];
    for (const int q1 = row_block_of(o, c1); q < q1; ++q) fold_block(q, s, t);
#pragma unroll
    for (int j = 0; j < VW; ++j) t[j] += a1 * u1[j];
  }
  if (k < end) {
    const int32_t c0 = t_indices[k];
    const double a0 = t_vals[k];
    double u0[VW];
    ldg_vec<double, VW>(V + (int64_t)c0 * B + lane0, u0);
    for (const int q0 = row_block_of(o, c0); q < q0; ++q) fold_block(q, s, t);
#pragma unroll
    for (int j = 0; j < VW; ++j) t[j] += a0 * u0[j];
  }
  for (; q < o.P; ++q) fold_block(q, s, t);
}

// out = C V over the row blocks of o, with the partials of V.out: CUDA
// block (g, y) runs block g - blk_off[p] of row block p's K5 launch on A_p,
// at its grid. For each nonzero (i, col) of A_p: t = W_s[col] * column_sum
// (K14's scaled sum of the P first-pass products), acc += a_icol t (K5's
// second launch); then K5's epilogue with W_slack and V. The (P, n, B) parts
// and the (n, B) U of the three-stage form are never written. At most 64
// registers a thread, four blocks an SM, as K6's fused kernel.
template <int VW>
__global__ void __launch_bounds__(kThreads, 4)
block_normal_kernel(BlockOps o, int64_t B,
                    const int64_t* __restrict__ t_indptr,
                    const int32_t* __restrict__ t_indices,
                    const double* __restrict__ t_vals,
                    const double* __restrict__ V,
                    const double* __restrict__ w_struct,
                    const double* __restrict__ w_slack,
                    double* __restrict__ out, double* __restrict__ partials,
                    const double* __restrict__ state) {
  __shared__ double red[kThreads * VW];
  if (loop_done(state)) return;
  const int64_t g = blockIdx.x;
  const int p = block_of_ops(o, g);
  int64_t r0 = o.row_off[0], r1 = o.row_off[1], b0 = o.blk_off[0],
          b1 = o.blk_off[1];
  const int64_t* ip = o.indptr[0];
  const int32_t* ix = o.indices[0];
  const double* va = o.vals[0];
#pragma unroll
  for (int q = 1; q < kMaxSplit; ++q) {
    if (q == p) {
      r0 = o.row_off[q];
      r1 = o.row_off[q + 1];
      b0 = o.blk_off[q];
      b1 = o.blk_off[q + 1];
      ip = o.indptr[q];
      ix = o.indices[q];
      va = o.vals[q];
    }
  }
  const int64_t lane0 = ((int64_t)blockIdx.y * blockDim.x + threadIdx.x) * VW;
  const bool lane_ok = lane0 < B;
  double dot[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) dot[j] = 0.0;
  if (lane_ok) {
    const int64_t rows = r1 - r0, gx = b1 - b0;
    for (int64_t row = (g - b0) * blockDim.y + threadIdx.y; row < rows;
         row += gx * blockDim.y) {
      double acc[VW];
#pragma unroll
      for (int j = 0; j < VW; ++j) acc[j] = 0.0;
      const int64_t end = ip[row + 1];
      for (int64_t k = ip[row]; k < end; ++k) {
        const int32_t col = ix[k];
        const double a_ik = va[k];
        double ws[VW], t[VW];
        ldcs_vec<double, VW>(w_struct + (int64_t)col * B + lane0, ws);
        column_sum<VW>(o, t_indptr[col], t_indptr[col + 1], t_indices,
                       t_vals, V, B, lane0, t);
#pragma unroll
        for (int j = 0; j < VW; ++j) t[j] = mul_rn(t[j], ws[j]);
#pragma unroll
        for (int j = 0; j < VW; ++j) acc[j] += a_ik * t[j];
      }
      row_epilogue<double, VW, true>((r0 + row) * B + lane0, acc, nullptr,
                                     w_slack, V, out, dot);
    }
  }
  if (partials != nullptr)
    store_dots<double, VW>(dot, red, lane_ok, B, lane0, partials);
}

// -- K16 ---------------------------------------------------------------------

enum SbcrPhase { kBInit = 0, kBStart = 1, kBPassA = 2, kBLane = 3,
                 kBPassB = 4, kBBeta = 5 };

// per-lane slots after the kStateLen scalars: kLaneSlots rows of B values
// (the same length as K7's state, which K5 checks); kAllDone is a scalar
// slot
enum SbcrLane { kLCdot = 0, kLAlpha = 1, kLBeta = 2, kLDone = 3,
                kLResnorm = 4, kLaneSlots = 5 };
enum SbcrSlot { kAllDone = 6 };

template <typename T>
struct SbcrArgs {
  int64_t m, B, P;
  int64_t k, maxiter;
  T tol;
  const int64_t* row_off;   // (P + 1)
  const int64_t* blk_off;   // (P + 1), row blocks of the reducing pass
  const int64_t* pc_off;    // (P + 1), rows of K5 partials per row block
  const T* invd;      // (m, B) 1 / diag
  T* Y;
  T* R;
  T* S;
  const T* CS;        // C S, written by the block products
  T* D;
  T* CD;
  T* pa;              // (2, B, nblk): sums of CD.(CD / diag), maxima of |R|
  int64_t nblk;
  const T* pc;        // (npc, B) K5 partials of S.CS
  T* state;
};

template <typename T>
__device__ __forceinline__ T* lane_of(T* st, int slot, int64_t B) {
  return st + kStateLen + slot * B;
}

// kBInit and kBPassB: flat over the m B entries
template <typename T>
__global__ void __launch_bounds__(kThreads) sbcr_flat_kernel(int phase,
                                                             SbcrArgs<T> a) {
  T* st = a.state;
  if (loop_done(st)) return;
  const T* alpha = lane_of(st, kLAlpha, a.B);
  const int64_t n = a.m * a.B;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * kThreads) {
    if (phase == kBInit) {  // S = R / diag, Y = 0; R holds the rhs
      a.S[j] = a.R[j] * a.invd[j];
      a.Y[j] = T(0);
    } else {                // Y += alpha D, R -= alpha CD, S -= alpha PCD
      const T al = alpha[j % a.B];
      const T c = a.CD[j];
      a.Y[j] += al * a.D[j];
      a.R[j] -= al * c;
      a.S[j] -= al * (c * a.invd[j]);
    }
  }
}

// kBPassA: the D / CD update of the trip before (D = S, CD = C S at k = 0),
// then per-block, per-lane partials of CD.(CD / diag) and of max |R|. Block
// (0, 0) also records whether every lane was done after the trip before.
template <typename T>
__global__ void __launch_bounds__(kThreads) sbcr_reduce_kernel(SbcrArgs<T> a) {
  __shared__ T red[kThreads];
  T* st = a.state;
  if (loop_done(st)) return;
  const int64_t B = a.B;
  const int64_t g = blockIdx.x;
  const int64_t p = block_of(a.blk_off, a.P, g);
  const int64_t gx = a.blk_off[p + 1] - a.blk_off[p];
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  const T* done = lane_of(st, kLDone, B);
  const T* beta = lane_of(st, kLBeta, B);
  T v[1] = {T(0)}, w[1] = {T(0)};
  if (b < B) {
    const bool keep = a.k > 0 && done[b] != T(0);
    const T be = beta[b];
    for (int64_t i = a.row_off[p] + (g - a.blk_off[p]) * blockDim.y +
                     threadIdx.y;
         i < a.row_off[p + 1]; i += gx * blockDim.y) {
      const int64_t o = i * B + b;
      T dd, cd;
      if (a.k == 0) {
        dd = a.S[o];
        cd = a.CS[o];
      } else if (keep) {
        dd = a.D[o];
        cd = a.CD[o];
      } else {
        dd = a.S[o] + be * a.D[o];
        cd = a.CS[o] + be * a.CD[o];
      }
      a.D[o] = dd;
      a.CD[o] = cd;
      v[0] += cd * (cd * a.invd[o]);
      w[0] = nan_max(w[0], abs_val(a.R[o]));
    }
  }
  lane_reduce<T, 1>(v, red, AddOp());
  lane_reduce<T, 1>(w, red, MaxOp());
  if (threadIdx.y == 0 && b < B) {
    a.pa[b * a.nblk + g] = v[0];
    a.pa[(B + b) * a.nblk + g] = w[0];
  }
  if (g == 0 && blockIdx.y == 0) {
    const int t = threadIdx.y * blockDim.x + threadIdx.x;
    const int nt = blockDim.x * blockDim.y;
    T all = T(1);
    for (int64_t l = t; l < B; l += nt)
      if (done[l] == T(0)) all = T(0);
    red[t] = all;
    __syncthreads();
    if (t == 0) {
      for (int u = 1; u < nt; ++u)
        if (red[u] == T(0)) all = T(0);
      st[kAllDone] = all;
    }
  }
}

// The lane passes: one warp per lane.
template <typename T>
__global__ void __launch_bounds__(kThreads) sbcr_lane_kernel(int phase,
                                                             SbcrArgs<T> a) {
  T* st = a.state;
  if (loop_done(st)) return;
  const int64_t B = a.B;
  const int64_t b = warp_lane();
  const bool lead0 = blockIdx.x == 0 && threadIdx.x == 0;
  T* cdot = lane_of(st, kLCdot, B);
  T* done = lane_of(st, kLDone, B);
  if (phase == kBLane && (st[kAllDone] != T(0) || a.k >= a.maxiter)) {
    // the reference's loop test: every lane done, or the trip limit
    if (lead0) st[kDone] = T(1);
    return;
  }
  if (b >= B) return;
  const bool first = (threadIdx.x & 31) == 0;
  if (phase == kBStart || phase == kBBeta) {  // the ordered sum of S.CS
    T total = T(0);
    for (int64_t q = 0; q < a.P; ++q) {
      T s = T(0);
      for (int64_t r = a.pc_off[q] + (threadIdx.x & 31); r < a.pc_off[q + 1];
           r += 32)
        s += a.pc[r * B + b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      total = q == 0 ? s : total + s;
    }
    if (!first) return;
    if (phase == kBStart) {
      cdot[b] = total;
      done[b] = T(0);
    } else {
      const bool dn = done[b] != T(0);
      const T c = cdot[b];
      lane_of(st, kLBeta, B)[b] =
          dn ? T(0) : total / (c == T(0) ? T(1) : c);
      if (!dn) cdot[b] = total;
      if (b == 0) st[kIt] = T(a.k + 1);
    }
    return;
  }
  // kBLane: done |= |R| <= tol, alpha from the ordered sum of CD.(CD/diag)
  const T* sums = a.pa + b * a.nblk;
  const T* maxs = a.pa + (B + b) * a.nblk;
  T total = T(0);
  for (int64_t q = 0; q < a.P; ++q) {
    const T s = warp_partials(sums + a.blk_off[q],
                              a.blk_off[q + 1] - a.blk_off[q], T(0), AddOp());
    total = q == 0 ? s : total + s;
  }
  const T resnorm = warp_partials(maxs, a.nblk, T(0), MaxOp());
  if (!first) return;
  const bool dn = done[b] != T(0) || resnorm <= a.tol;
  done[b] = dn ? T(1) : T(0);
  lane_of(st, kLResnorm, B)[b] = resnorm;
  lane_of(st, kLAlpha, B)[b] =
      dn ? T(0) : cdot[b] / (total == T(0) ? T(1) : total);
}

}  // namespace
}  // namespace ipxt

using namespace ipxt;

// out[j] = scale[j] * sum over p of parts[p * L + j], summed p = 0..P-1 in
// order; scale and state may be null.
extern "C" int ipxt_block_sum_f64(int64_t P, int64_t L, const void* parts,
                                  const void* scale, void* out,
                                  const void* state, void* stream) {
  const int64_t want = blocks_for(L, kThreads);
  const int64_t grid = want < 65535 * 4 ? want : 65535 * 4;
  if (grid == 0) return 0;
  block_sum_kernel<double><<<(unsigned)grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      P, L, static_cast<const double*>(parts),
      static_cast<const double*>(scale), static_cast<double*>(out),
      static_cast<const double*>(state));
  return (int)cudaGetLastError();
}

// CUDA blocks of a K15 elementwise pass over `rows` rows of one row block.
extern "C" int64_t ipxt_scr_blocks(int64_t rows) {
  return blocks_for(rows, kThreads);
}

// The arguments of a K15 pass; cs and pc are written by the block products.
static ScrArgs<double> scr_args(int64_t m, int64_t P, int64_t k,
                                int64_t maxiter, double tol, int ladder,
                                const void* row_off, const void* blk_off,
                                const void* pc_off, const void* invd,
                                const void* resscale, void* y, void* r,
                                void* s, void* cs, void* d, void* cd,
                                void* pa, int64_t nblk, void* pc,
                                void* state) {
  ScrArgs<double> a;
  a.m = m;
  a.P = P;
  a.k = k;
  a.maxiter = maxiter;
  a.tol = tol;
  a.ladder = ladder;
  a.row_off = static_cast<const int64_t*>(row_off);
  a.blk_off = static_cast<const int64_t*>(blk_off);
  a.pc_off = static_cast<const int64_t*>(pc_off);
  a.invd = static_cast<const double*>(invd);
  a.resscale = static_cast<const double*>(resscale);
  a.y = static_cast<double*>(y);
  a.r = static_cast<double*>(r);
  a.s = static_cast<double*>(s);
  a.cs = static_cast<double*>(cs);
  a.d = static_cast<double*>(d);
  a.cd = static_cast<double*>(cd);
  a.pa = static_cast<double*>(pa);
  a.nblk = nblk;
  a.pc = static_cast<double*>(pc);
  a.state = static_cast<double*>(state);
  return a;
}

// The host-issued form: one pass (`phase`) of trip k over the virtual
// blocks [vb0, vb1) of the elementwise passes (0 and nblk on one card). On
// one card the solvers never ask for it; the card tests and chip_smoke.py
// hold the cooperative form against it. A mesh rank runs it over its own
// row block's blocks (parallel/mesh.py).
extern "C" int ipxt_scr_step_f64(int phase, int64_t vb0, int64_t vb1,
                                 int64_t m, int64_t P, int64_t k,
                                 int64_t maxiter, double tol, int ladder,
                                 const void* row_off, const void* blk_off,
                                 const void* pc_off, const void* invd,
                                 const void* resscale, void* y, void* r,
                                 void* s, void* cs, void* d, void* cd,
                                 void* pa, int64_t nblk, void* pc,
                                 void* state, void* stream) {
  if (phase < kSInit || phase > kSPassC || nblk < 1 || vb0 < 0 ||
      vb1 <= vb0 || vb1 > nblk)
    return (int)cudaErrorInvalidValue;
  const ScrArgs<double> a =
      scr_args(m, P, k, maxiter, tol, ladder, row_off, blk_off, pc_off, invd,
               resscale, y, r, s, cs, d, cd, pa, nblk, pc, state);
  scr_step_kernel<double><<<(unsigned)(vb1 - vb0), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(phase, vb0,
                                                                 a);
  return (int)cudaGetLastError();
}

// A whole K15 solve in one cooperative launch: the buffers of the passes
// (the device offsets row_off, blk_off and pc_off), then K14v's operand,
// the whole A' (rows_t = n rows) split at the P - 1 interior row bounds
// `bounds` (host) and summed at vec_t lanes a row, then the block products'
// operands as ipxt_block_spmv_f64 takes them (host arrays: h_row_off and
// h_pc_off, P + 1 each, the layout of P K1 launches; vec, indptr, indices,
// vals, P each), W_struct (n), W_slack (m) and the (n,) scratch u. nblk must
// be the elementwise passes' blocks over the row blocks (ipxt_scr_blocks of
// each). The state must hold zeros; on return (asynchronously) it holds the
// iterations, the error code, the residual norm, done and the applies the
// launch ran, each one K14v half and one block products half. A refused
// launch is returned as such.
extern "C" int ipxt_scr_solve_f64(
    int64_t m, int P, int64_t maxiter, double tol, int ladder,
    const void* row_off, const void* blk_off, const void* pc_off,
    const void* invd, const void* resscale, void* y, void* r, void* s,
    void* cs, void* d, void* cd, void* pa, int64_t nblk, void* pc,
    void* state, int64_t rows_t, const void* indptr_t, const void* indices_t,
    const void* vals_t, int vec_t, const int64_t* bounds,
    const int64_t* h_row_off, const int64_t* h_pc_off, const int* vec,
    const void* const* indptr, const void* const* indices,
    const void* const* vals, const void* w_struct, const void* w_slack,
    void* u, void* stream) {
  ScrSolveArgs sa;
  if (!valid_vec(vec_t) || !make_split(P, bounds, &sa.split) ||
      !make_block_ops(P, h_row_off, h_pc_off, vec, indptr, indices, vals,
                      &sa.ops) ||
      !k1_layout(sa.ops) || h_row_off[P] != m)
    return (int)cudaErrorInvalidValue;
  int64_t want = 0;
  for (int p = 0; p < P; ++p)
    want += blocks_for(h_row_off[p + 1] - h_row_off[p], kThreads);
  if (nblk < 1 || nblk != want) return (int)cudaErrorInvalidValue;
  sa.a = scr_args(m, P, 0, maxiter, tol, ladder, row_off, blk_off, pc_off,
                  invd, resscale, y, r, s, cs, d, cd, pa, nblk, pc, state);
  sa.at = make_rows(rows_t, indptr_t, indices_t, vals_t, vec_t);
  sa.w_struct = static_cast<const double*>(w_struct);
  sa.w_slack = static_cast<const double*>(w_slack);
  sa.u = static_cast<double*>(u);
  int64_t grid = nblk;
  const int64_t nt = blocks_for(rows_t, kThreads / vec_t);
  if (nt > grid) grid = nt;
  if (sa.ops.nblk > grid) grid = sa.ops.nblk;
  int64_t cap = 0;
  const int err = coop_capacity<scr_solve_kernel>(&cap);
  if (err != 0) return err;
  if (grid > cap) grid = cap;  // the virtual blocks are walked grid-stride
  void* args[] = {&sa};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      (const void*)scr_solve_kernel, dim3((unsigned)grid), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream));
  // read and clear the last error too, so that a refusal is reported here
  // and not by the next launch of another entry point
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}

// K16's fused block normal apply: out[i, :] = (A_p (W_s * sum_q A_q' V_q))
// [i - row_off[p]] + W_slack[i, :] V[i, :] for the rows i of each row block
// p, the sum over the blocks q as K14 takes it, with partials[g, :] the
// sum of V[i, :] out[i, :] over the rows of K5 row block g. The blocks'
// A_p are given as ipxt_block_spmv_f64 takes them (host arrays row_off and
// blk_off, P + 1 each; indptr, indices and vals, P each), blk_off being the
// layout of P K5 launches at lane width vw (ipxt_lane_blocks(rows_p,
// B / vw) each); the whole A' (n rows) split at the row bounds by t_indptr,
// t_indices and t_vals. V, W_slack and out (m, B), W_struct (n, B),
// row-major. partials and state may be null.
extern "C" int ipxt_block_normal_batched_f64(
    int P, const int64_t* row_off, const int64_t* blk_off,
    const void* const* indptr, const void* const* indices,
    const void* const* vals, int64_t B, const void* t_indptr,
    const void* t_indices, const void* t_vals, const void* V,
    const void* w_struct, const void* w_slack, void* out, void* partials,
    const void* state, int vw, void* stream) {
  BlockOps o;
  if (!make_block_ops(P, row_off, blk_off, nullptr, indptr, indices, vals,
                      &o) ||
      !width_ok<double>(B, vw, {V, w_struct, w_slack, out, partials}))
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < P; ++p)
    if (blk_off[p + 1] - blk_off[p] !=
        lane_grid(row_off[p + 1] - row_off[p], B / vw).gx)
      return (int)cudaErrorInvalidValue;
  const LaneGrid g = lane_grid(1, B / vw);  // tx, ty and gy: B's alone
  const dim3 grid((unsigned)o.nblk, (unsigned)g.gy);
  const dim3 block((unsigned)g.tx, (unsigned)g.ty);
  auto st = static_cast<cudaStream_t>(stream);
  auto tip = static_cast<const int64_t*>(t_indptr);
  auto tix = static_cast<const int32_t*>(t_indices);
  auto tva = static_cast<const double*>(t_vals);
  auto v = static_cast<const double*>(V);
  auto ws = static_cast<const double*>(w_struct);
  auto wl = static_cast<const double*>(w_slack);
  auto y = static_cast<double*>(out);
  auto pp = static_cast<double*>(partials);
  auto sp = static_cast<const double*>(state);
  if (vw == 1)
    block_normal_kernel<1><<<grid, block, 0, st>>>(o, B, tip, tix, tva, v, ws,
                                                   wl, y, pp, sp);
  else
    block_normal_kernel<2><<<grid, block, 0, st>>>(o, B, tip, tix, tva, v, ws,
                                                   wl, y, pp, sp);
  return (int)cudaGetLastError();
}

// Length of K16's state for B lanes.
extern "C" int64_t ipxt_sbcr_state_len(int64_t B) {
  return kStateLen + kLaneSlots * B;
}

extern "C" int ipxt_sbcr_step_f64(int phase, int64_t m, int64_t B, int64_t P,
                                  int64_t k, int64_t maxiter, double tol,
                                  const void* row_off, const void* blk_off,
                                  const void* pc_off, const void* invd,
                                  void* Y, void* R, void* S, const void* CS,
                                  void* D, void* CD, void* pa, int64_t nblk,
                                  const void* pc, void* state, void* stream) {
  if (phase < kBInit || phase > kBBeta || B < 1 || nblk < 1)
    return (int)cudaErrorInvalidValue;
  SbcrArgs<double> a;
  a.m = m;
  a.B = B;
  a.P = P;
  a.k = k;
  a.maxiter = maxiter;
  a.tol = tol;
  a.row_off = static_cast<const int64_t*>(row_off);
  a.blk_off = static_cast<const int64_t*>(blk_off);
  a.pc_off = static_cast<const int64_t*>(pc_off);
  a.invd = static_cast<const double*>(invd);
  a.Y = static_cast<double*>(Y);
  a.R = static_cast<double*>(R);
  a.S = static_cast<double*>(S);
  a.CS = static_cast<const double*>(CS);
  a.D = static_cast<double*>(D);
  a.CD = static_cast<double*>(CD);
  a.pa = static_cast<double*>(pa);
  a.nblk = nblk;
  a.pc = static_cast<const double*>(pc);
  a.state = static_cast<double*>(state);
  auto s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case kBInit:
    case kBPassB: {
      const int64_t want = blocks_for(m * B, kThreads);
      const int64_t grid = want < 65535 * 4 ? want : 65535 * 4;
      if (grid > 0)
        sbcr_flat_kernel<double><<<(unsigned)grid, kThreads, 0, s>>>(phase,
                                                                     a);
      break;
    }
    case kBPassA: {
      const LaneGrid g = red_grid(1, B);   // tx, ty and gy; x from blk_off
      const dim3 grid((unsigned)nblk, (unsigned)g.gy);
      const dim3 block((unsigned)g.tx, (unsigned)g.ty);
      sbcr_reduce_kernel<double><<<grid, block, 0, s>>>(a);
      break;
    }
    default: {  // the lane passes
      const int64_t grid = blocks_for(B, kWarpsPerBlock);
      sbcr_lane_kernel<double><<<(unsigned)grid, kThreads, 0, s>>>(phase, a);
      break;
    }
  }
  return (int)cudaGetLastError();
}
