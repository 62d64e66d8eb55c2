// K5 csr_spmm and K6 normal_apply_batched: sparse matrix times a batch of
// vectors over CSR rows, Y = A U with U of shape (cols, B), row-major (B
// contiguous), for Hopper (sm_90a).
//
// Replaces: ipx_tpu/ops/spmv.py apply_csr_batched / apply_csr_batched_tree
// (a `take` of the rows of U into an (nnz, B) array and a sorted
// segment_sum over it) and NormalMatrixDevice.apply_batched /
// normal_apply_batched_tree, with the column dots jnp.sum(V * out, axis=0)
// of ipx_tpu/parallel/batch.py _cr_solve.C.
//
// What bounds it on the H100: memory. Every nonzero gathers one row of U
// (B values) and there is one multiply-add per value gathered; there is no
// reuse that a tensor core could exploit. The gathered rows come from L2
// when U fits (V of the batched path is 20.5 MB in f32, 41 MB in f64, under
// the 50 MB L2), else from memory once per nonzero unless the gathers of a
// column come close together; what then limits a thread is how many
// gathers it has in flight, which in the row body wait on the load of
// their column index.
//
// K5 has two forms, bit for bit the same Y (acc = 0, then one multiply-add
// a value in CSR order, contracted to an FMA), and kernels.k5_form picks one
// per launch on the host:
//   tiled (csr_spmm_tile_kernel), the plain product Y = A U with no
//     epilogue, partials or loop state, where a row of U holds at least
//     256 bytes (kernels.k5_form): every K5 launch of the batched stage
//     (A X, A WR, A DX, A.^2 W and A' Y, A' DY at B = 256). A block takes a
//     tile of rows and a tile of lanes (256 bytes of a row of U); it stages
//     the tile's indptr, indices and values in shared memory with coalesced
//     loads, and each group of threads streams over its rows' nonzeros,
//     across row ends, with kTileUnroll gathers issued together into
//     registers, so no gather waits on an index load. Blocks run lane tile
//     by lane tile: one lane tile of U at n = 96 002, f64 is 24.6 MB, which
//     stays in L2 between the two gathers of a column of A, where the row
//     body reads the 197 MB U from memory twice. Y goes out with streaming
//     stores. A ring of gathered segments in shared memory (cp.async, or a
//     TMA bulk copy a segment) was measured in its place and capped near
//     3.7 TB/s of gathered bytes, under the row body's plain loads (PERF.md
//     §6).
//   row body (csr_spmm_kernel), for the launches with epilogues (rowscale,
//     addw and addv, partials) or a loop state: the two-launch K6 and the
//     three-stage K16 and their partial slots, per lane_grid row block,
//     which the fused K6 and K16 reproduce. A group of threads per output
//     row walks the row's nonzeros; the threads of the group split the B
//     lanes, each taking VW adjacent lanes with one 16-byte load (float4 /
//     double2) where B is a multiple of VW and the pointers are aligned, one
//     lane otherwise. Blocks stride over the rows (at most kMaxRowBlocks of
//     them), so the per-lane partials of a reduction stay short. Its row
//     loop (row_gather) takes UNROLL nonzeros at a time, their indices and
//     values loaded, then their gathers issued, then added in CSR order;
//     kernels.k5_unroll picks 2 on operands with short rows and 1 elsewhere
//     (PERF.md §6, tools/torch_profile.py --what k5).
// The forms with epilogues keep the row body, whose partial slots the fused
// K6 and K16 reproduce, rather than take a second layout; below 256 bytes a
// row (B < 32 in f64, B < 64 in f32: the entry step's B = 8, phase 7's
// B = 4) the row body's launches were the faster ones on the card.
// In both, a gather of row `col` of U is contiguous across a group, and
// the (nnz, B) intermediate of the reference and of the plain version never
// exists.
//
// K6, C V = A (W_s * (A' V)) + W_slack * V with the column dots V.CV, has two
// forms, and kernels.NormalBatchedPlan picks one per operand pair:
//   fused (normal_batched_kernel), one launch over the rows of A on K5's
//     grid: for each nonzero (i, k) of row i, t = sum_j a_jk V[j, :] over
//     column k of A (row k of A', in its CSR order, as K5's first launch
//     sums it), t *= W_s[k, :], acc += a_ik t; then K5's epilogue. The
//     (n, B) array U = W_s * (A' V) is never written: at m = 20 000,
//     n = 96 002, B = 256 it is 98 MB in f32 (197 in f64) each way. The
//     price is that column k's sum is recomputed once per nonzero of the
//     column, sum_k len_k^2 gathers against 2 nnz(A) for the two launches,
//     which is why the plan takes it only where that sum is small. A thread
//     walks its row's nonzeros one at a time and each column's gathers
//     kInner at a time (row_gather: the indices and values loaded, then the
//     gathers issued, then added in CSR order, the same multiply-adds in
//     the same order as one at a time), with four blocks an SM. W_s and
//     W_slack are read with streaming loads (__ldcs), so they do not push V
//     out of L2; V is read through the read-only cache (__ldg).
//   two launches of K5 with epilogues, as K2 is to K1:
//     U   = W_s * (A' V)                 (rowscale, an (n, B) array)
//     out = A U + W_slack * V            (addw, addv)
// The arithmetic of t and acc is the two launches' own, expression for
// expression, so the two forms give the same out and partials bit for bit.
// The partials are per row block and lane, shape (blocks, B), at the blocks
// of K5's grid over the m rows; they are summed in a fixed order (lane_sum
// below, a warp a lane, or the K7 passes of batch_cr.cu), never with
// atomics, so a stage repeats bit for bit.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (cudaErrorInvalidValue for arguments it does
// not take).

#include "spmm_row.cuh"

namespace ipxt {
namespace {

constexpr int kInner = 2;  // the fused K6's gathers in flight a thread

// acc[0..VW) += sum over k in [begin, end) of vals[k] X[indices[k], lanes],
// in CSR order, one multiply-add a value: UNROLL indices and values loaded,
// then their UNROLL gathers issued, then added; the rest one at a time.
// UNROLL = 1 is the loop of one nonzero at a time.
template <typename T, int VW, int UNROLL>
__device__ __forceinline__ void row_gather(int64_t begin, int64_t end,
                                           const int32_t* __restrict__ indices,
                                           const T* __restrict__ vals,
                                           const T* __restrict__ X, int64_t B,
                                           int64_t lane0, T (&acc)[VW]) {
  int64_t k = begin;
  if constexpr (UNROLL > 1) {
    for (; k + UNROLL <= end; k += UNROLL) {
      int32_t c[UNROLL];
      T a[UNROLL], u[UNROLL][VW];
#pragma unroll
      for (int q = 0; q < UNROLL; ++q) {
        c[q] = indices[k + q];
        a[q] = vals[k + q];
      }
#pragma unroll
      for (int q = 0; q < UNROLL; ++q)
        ldg_vec<T, VW>(X + (int64_t)c[q] * B + lane0, u[q]);
#pragma unroll
      for (int q = 0; q < UNROLL; ++q)
#pragma unroll
        for (int j = 0; j < VW; ++j) acc[j] += a[q] * u[q][j];
    }
  }
  for (; k < end; ++k) {
    const T a = vals[k];
    T u[VW];
    ldg_vec<T, VW>(X + (int64_t)indices[k] * B + lane0, u);
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[j] += a * u[j];
  }
}

template <typename T, int VW, int UNROLL>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(int64_t rows, int64_t B, const int64_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const T* __restrict__ vals, const T* __restrict__ U,
                const T* __restrict__ rowscale, const T* __restrict__ addw,
                const T* __restrict__ addv, T* __restrict__ Y,
                T* __restrict__ partials, const T* __restrict__ state) {
  __shared__ T red[kThreads * VW];
  if (loop_done(state)) return;
  const int64_t lane0 = ((int64_t)blockIdx.y * blockDim.x + threadIdx.x) * VW;
  const bool lane_ok = lane0 < B;
  T dot[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) dot[j] = T(0);
  if (lane_ok) {
    for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
         row < rows; row += (int64_t)gridDim.x * blockDim.y) {
      T acc[VW];
#pragma unroll
      for (int j = 0; j < VW; ++j) acc[j] = T(0);
      row_gather<T, VW, UNROLL>(indptr[row], indptr[row + 1], indices, vals,
                                U, B, lane0, acc);
      row_epilogue<T, VW, false>(row * B + lane0, acc, rowscale, addw, addv,
                                 Y, dot);
    }
  }
  if (partials != nullptr) store_dots<T, VW>(dot, red, lane_ok, B, lane0,
                                             partials);
}

// -- K5's tiled form: the plain product Y = A U -------------------------------

constexpr int kTileRows = 256;   // rows a block's tile may have
constexpr int kStageNz = 2048;   // nonzeros a tile stages in shared memory
constexpr int kTileUnroll = 4;   // gathers a thread issues together

// Y = A U over a tile of rows (blockIdx.x) and a tile of lanes (blockIdx.y).
// blockDim = (tpr threads a group, G groups); each thread takes VW lanes, so
// a group gathers a segment of tpr VW lanes of one row of U a nonzero, and
// each group walks `rpg` consecutive rows of the tile. The tile's indptr,
// indices and values are staged into shared memory with coalesced loads
// (where its nonzeros fit, else read in place). Each group then streams
// over its rows' nonzeros kTileUnroll at a time, across row ends: their
// gathers issued together into registers, no gather waiting on an index
// load, then added in CSR order with the row ends between them, one FMA a
// value from acc = 0 as the row body adds. Blocks run lane tile by lane
// tile, so the rows of U that one lane tile gathers (n x 256 bytes at the
// widths k5_tile picks) stay in L2 between a column's two gathers; Y goes
// out with streaming stores, so it does not push them out.
template <typename T, int VW>
__global__ void __launch_bounds__(kThreads)
csr_spmm_tile_kernel(int64_t rows, int64_t B, int rpg,
                     const int64_t* __restrict__ indptr,
                     const int32_t* __restrict__ indices,
                     const T* __restrict__ vals, const T* __restrict__ U,
                     T* __restrict__ Y) {
  __shared__ int64_t s_ip[kTileRows + 1];
  __shared__ int32_t s_ix[kStageNz];
  __shared__ T s_va[kStageNz];
  const int tpr = blockDim.x, tid = threadIdx.y * tpr + threadIdx.x;
  const int nthr = tpr * blockDim.y;
  const int64_t r0 = (int64_t)blockIdx.x * blockDim.y * rpg;
  const int nr = (int)min((int64_t)blockDim.y * rpg, rows - r0);
  for (int i = tid; i <= nr; i += nthr) s_ip[i] = indptr[r0 + i];
  __syncthreads();
  const int64_t p0 = s_ip[0], nz = s_ip[nr] - p0;
  const bool staged = nz <= kStageNz;   // the same in the whole block
  if (staged)
    for (int k = tid; k < nz; k += nthr) {
      s_ix[k] = indices[p0 + k];
      s_va[k] = vals[p0 + k];
    }
  __syncthreads();
  const int32_t* ix = staged ? s_ix : indices + p0;
  const T* va = staged ? s_va : vals + p0;
  const int64_t tile0 = (int64_t)blockIdx.y * tpr * VW;
  const int valid = (int)min((int64_t)tpr, (B - tile0) / VW);
  const int ra = threadIdx.y * rpg, rb = min(ra + rpg, nr);
  if (threadIdx.x >= valid || ra >= rb) return;
  const int64_t lane0 = tile0 + (int64_t)threadIdx.x * VW;
  const T* Ub = U + lane0;
  const int64_t q1 = s_ip[rb] - p0;
  int r = ra;
  int64_t e = s_ip[r + 1] - p0;
  T acc[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) acc[j] = T(0);
  for (int64_t q = s_ip[ra] - p0; q < q1; q += kTileUnroll) {
    T u[kTileUnroll][VW];
#pragma unroll
    for (int k = 0; k < kTileUnroll; ++k)
      if (q + k < q1) ldg_vec<T, VW>(Ub + (int64_t)ix[q + k] * B, u[k]);
#pragma unroll
    for (int k = 0; k < kTileUnroll; ++k)
      if (q + k < q1) {
        while (q + k == e) {  // the rows that end before nonzero q + k
          stcs_vec<T, VW>(Y + (r0 + r) * B + lane0, acc);
#pragma unroll
          for (int j = 0; j < VW; ++j) acc[j] = T(0);
          e = s_ip[++r + 1] - p0;
        }
#pragma unroll
        for (int j = 0; j < VW; ++j)
          acc[j] = fma_rn(va[q + k], u[k][j], acc[j]);
      }
  }
  for (; r < rb; ++r) {  // the last row with nonzeros, then empty ones
    stcs_vec<T, VW>(Y + (r0 + r) * B + lane0, acc);
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[j] = T(0);
  }
}

// The fused K6: out = A (W_s * (A' V)) + W_slack * V over the rows of A
// (A: rows, indptr, indices, vals; A': t_indptr, t_indices, t_vals), with
// the partials of V.out, on K5's grid over the rows of A. At most 64
// registers a thread, so that four blocks fit on an SM: the gathers wait on
// a chain of dependent index loads, and more warps in flight hide it better
// than deeper unrolling in fewer of them.
template <typename T, int VW>
__global__ void __launch_bounds__(kThreads, 4)
normal_batched_kernel(int64_t rows, int64_t B,
                      const int64_t* __restrict__ indptr,
                      const int32_t* __restrict__ indices,
                      const T* __restrict__ vals,
                      const int64_t* __restrict__ t_indptr,
                      const int32_t* __restrict__ t_indices,
                      const T* __restrict__ t_vals, const T* __restrict__ V,
                      const T* __restrict__ w_struct,
                      const T* __restrict__ w_slack, T* __restrict__ out,
                      T* __restrict__ partials, const T* __restrict__ state) {
  __shared__ T red[kThreads * VW];
  if (loop_done(state)) return;
  const int64_t lane0 = ((int64_t)blockIdx.y * blockDim.x + threadIdx.x) * VW;
  const bool lane_ok = lane0 < B;
  T dot[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) dot[j] = T(0);
  if (lane_ok) {
    for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
         row < rows; row += (int64_t)gridDim.x * blockDim.y) {
      T acc[VW];
#pragma unroll
      for (int j = 0; j < VW; ++j) acc[j] = T(0);
      const int64_t end = indptr[row + 1];
      for (int64_t p = indptr[row]; p < end; ++p) {
        const int32_t col = indices[p];
        const T a_ik = vals[p];
        // t = W_s[col] * (row col of A') . V, as K5's first launch sums it
        T t[VW], ws[VW];
        ldcs_vec<T, VW>(w_struct + (int64_t)col * B + lane0, ws);
#pragma unroll
        for (int j = 0; j < VW; ++j) t[j] = T(0);
        row_gather<T, VW, kInner>(t_indptr[col], t_indptr[col + 1],
                                  t_indices, t_vals, V, B, lane0, t);
#pragma unroll
        for (int j = 0; j < VW; ++j) t[j] *= ws[j];
        // as K5's second launch adds a_ik U[col]
#pragma unroll
        for (int j = 0; j < VW; ++j) acc[j] += a_ik * t[j];
      }
      row_epilogue<T, VW, true>(row * B + lane0, acc, nullptr, w_slack, V,
                                out, dot);
    }
  }
  if (partials != nullptr) store_dots<T, VW>(dot, red, lane_ok, B, lane0,
                                             partials);
}

// out[b] = the sum of the n partials p[k, b]: a warp a lane, thread t of
// the warp taking k = t, t + 32, ... in order, then a shuffle tree
// (warp_partials).
template <typename T>
__global__ void __launch_bounds__(kThreads)
lane_sum_kernel(int64_t n, int64_t B, const T* __restrict__ p,
                T* __restrict__ out) {
  const int64_t b = warp_lane();
  if (b >= B) return;  // the same for the whole warp
  const T s = warp_partials(p + b, n, T(0), AddOp(), B);
  if ((threadIdx.x & 31) == 0) out[b] = s;
}

// csr_spmm_kernel<T, VW, unroll> for unroll 1 or 2
template <typename T, int VW>
void launch_spmm(int unroll, dim3 grid, dim3 block, cudaStream_t s,
                 int64_t rows, int64_t B, const int64_t* ip, const int32_t* ix,
                 const T* v, const T* u, const T* rs, const T* aw,
                 const T* av, T* y, T* pp, const T* st) {
  if (unroll == 2)
    csr_spmm_kernel<T, VW, 2><<<grid, block, 0, s>>>(rows, B, ip, ix, v, u,
                                                     rs, aw, av, y, pp, st);
  else
    csr_spmm_kernel<T, VW, 1><<<grid, block, 0, s>>>(rows, B, ip, ix, v, u,
                                                     rs, aw, av, y, pp, st);
}

template <typename T>
int csr_spmm(int64_t rows, int64_t B, const void* indptr, const void* indices,
             const void* vals, const void* U, const void* rowscale,
             const void* addw, const void* addv, void* Y, void* partials,
             const void* state, int vw, int unroll, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (!width_ok<T>(B, vw, {U, rowscale, addw, addv, Y, partials}) ||
      (unroll != 1 && unroll != 2))
    return (int)cudaErrorInvalidValue;
  // an empty operand's arrays may be null (a row block with no rows); its
  // launch writes zero partials
  if (rows > 0 && ((addw == nullptr) != (addv == nullptr) ||
                   (partials != nullptr && addv == nullptr)))
    return (int)cudaErrorInvalidValue;
  const LaneGrid g = lane_grid(rows, B / vw);
  const dim3 grid((unsigned)g.gx, (unsigned)g.gy);
  const dim3 block((unsigned)g.tx, (unsigned)g.ty);
  auto s = static_cast<cudaStream_t>(stream);
  auto ip = static_cast<const int64_t*>(indptr);
  auto ix = static_cast<const int32_t*>(indices);
  auto v = static_cast<const T*>(vals);
  auto u = static_cast<const T*>(U);
  auto rs = static_cast<const T*>(rowscale);
  auto aw = static_cast<const T*>(addw);
  auto av = static_cast<const T*>(addv);
  auto y = static_cast<T*>(Y);
  auto pp = static_cast<T*>(partials);
  auto st = static_cast<const T*>(state);
  if (vw == 1)
    launch_spmm<T, 1>(unroll, grid, block, s, rows, B, ip, ix, v, u, rs, aw,
                      av, y, pp, st);
  else
    launch_spmm<T, V>(unroll, grid, block, s, rows, B, ip, ix, v, u, rs, aw,
                      av, y, pp, st);
  return (int)cudaGetLastError();
}

// The tiled form's launch: tpr threads a group (at most B / vw),
// 256 / tpr groups a block, rpg rows a group.
template <typename T>
int csr_spmm_tile(int64_t rows, int64_t B, const void* indptr,
                  const void* indices, const void* vals, const void* U,
                  void* Y, int vw, int tpr, int rpg, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (!width_ok<T>(B, vw, {U, Y}) || tpr < 1 || tpr > kThreads ||
      tpr > B / vw || rpg < 1 || (kThreads / tpr) * rpg > kTileRows)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();  // an empty operand's null arrays
  const int g = kThreads / tpr;
  const dim3 grid((unsigned)blocks_for(rows, (int64_t)g * rpg),
                  (unsigned)blocks_for(B / vw, tpr));
  const dim3 block((unsigned)tpr, (unsigned)g);
  auto s = static_cast<cudaStream_t>(stream);
  auto ip = static_cast<const int64_t*>(indptr);
  auto ix = static_cast<const int32_t*>(indices);
  auto v = static_cast<const T*>(vals);
  auto u = static_cast<const T*>(U);
  auto y = static_cast<T*>(Y);
  if (vw == 1)
    csr_spmm_tile_kernel<T, 1><<<grid, block, 0, s>>>(rows, B, rpg, ip, ix, v,
                                                     u, y);
  else
    csr_spmm_tile_kernel<T, V><<<grid, block, 0, s>>>(rows, B, rpg, ip, ix, v,
                                                     u, y);
  return (int)cudaGetLastError();
}

template <typename T>
int normal_batched(int64_t rows, int64_t B, const void* indptr,
                   const void* indices, const void* vals,
                   const void* t_indptr, const void* t_indices,
                   const void* t_vals, const void* V, const void* w_struct,
                   const void* w_slack, void* out, void* partials,
                   const void* state, int vw, void* stream) {
  constexpr int W = 16 / sizeof(T);
  if (!width_ok<T>(B, vw, {V, w_struct, w_slack, out, partials}))
    return (int)cudaErrorInvalidValue;
  const LaneGrid g = lane_grid(rows, B / vw);
  const dim3 grid((unsigned)g.gx, (unsigned)g.gy);
  const dim3 block((unsigned)g.tx, (unsigned)g.ty);
  auto s = static_cast<cudaStream_t>(stream);
  auto ip = static_cast<const int64_t*>(indptr);
  auto ix = static_cast<const int32_t*>(indices);
  auto va = static_cast<const T*>(vals);
  auto tip = static_cast<const int64_t*>(t_indptr);
  auto tix = static_cast<const int32_t*>(t_indices);
  auto tva = static_cast<const T*>(t_vals);
  auto v = static_cast<const T*>(V);
  auto ws = static_cast<const T*>(w_struct);
  auto wl = static_cast<const T*>(w_slack);
  auto o = static_cast<T*>(out);
  auto pp = static_cast<T*>(partials);
  auto st = static_cast<const T*>(state);
  if (vw == 1)
    normal_batched_kernel<T, 1><<<grid, block, 0, s>>>(
        rows, B, ip, ix, va, tip, tix, tva, v, ws, wl, o, pp, st);
  else
    normal_batched_kernel<T, W><<<grid, block, 0, s>>>(
        rows, B, ip, ix, va, tip, tix, tva, v, ws, wl, o, pp, st);
  return (int)cudaGetLastError();
}

template <typename T>
int lane_sum(int64_t n, int64_t B, const void* p, void* out, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  lane_sum_kernel<T><<<(unsigned)blocks_for(B, kWarpsPerBlock), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      n, B, static_cast<const T*>(p), static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ipxt

// Row blocks of a batched pass over `rows` rows and `chunks` lane chunks (B
// lanes, or B / VW for K5 and K6): the number of per-lane partials it
// writes.
extern "C" int64_t ipxt_lane_blocks(int64_t rows, int64_t chunks) {
  return ipxt::lane_grid(rows, chunks).gx;
}

// Y[i, :] = (sum_k vals[k] U[indices[k], :]) * rowscale[i, :]
//           + addw[i, :] addv[i, :];
// rowscale, addw/addv, partials and state may each be null; all arrays are
// row-major with B columns. With partials, partials[blk, :] = sum over the
// rows of row block blk of addv[i, :] Y[i, :]. vw is 1 or 16 / sizeof(T);
// unroll (1 or 2) is the gathers a thread issues together, the same Y bit
// for bit either way.
extern "C" int ipxt_csr_spmm_f64(int64_t rows, int64_t B, const void* indptr,
                                 const void* indices, const void* vals,
                                 const void* U, const void* rowscale,
                                 const void* addw, const void* addv, void* Y,
                                 void* partials, const void* state, int vw,
                                 int unroll, void* stream) {
  return ipxt::csr_spmm<double>(rows, B, indptr, indices, vals, U, rowscale,
                                addw, addv, Y, partials, state, vw, unroll,
                                stream);
}

extern "C" int ipxt_csr_spmm_f32(int64_t rows, int64_t B, const void* indptr,
                                 const void* indices, const void* vals,
                                 const void* U, const void* rowscale,
                                 const void* addw, const void* addv, void* Y,
                                 void* partials, const void* state, int vw,
                                 int unroll, void* stream) {
  return ipxt::csr_spmm<float>(rows, B, indptr, indices, vals, U, rowscale,
                               addw, addv, Y, partials, state, vw, unroll,
                               stream);
}

// Y = A U, K5's plain product in its tiled form (csr_spmm_tile_kernel):
// Y bit for bit the same as ipxt_csr_spmm's without epilogues, at any
// unroll. tpr threads a group take vw lanes each, rpg rows a group. rows
// may be 0, and the arrays of an empty operand null.
extern "C" int ipxt_csr_spmm_tile_f64(int64_t rows, int64_t B,
                                      const void* indptr, const void* indices,
                                      const void* vals, const void* U,
                                      void* Y, int vw, int tpr, int rpg,
                                      void* stream) {
  return ipxt::csr_spmm_tile<double>(rows, B, indptr, indices, vals, U, Y,
                                     vw, tpr, rpg, stream);
}

extern "C" int ipxt_csr_spmm_tile_f32(int64_t rows, int64_t B,
                                      const void* indptr, const void* indices,
                                      const void* vals, const void* U,
                                      void* Y, int vw, int tpr, int rpg,
                                      void* stream) {
  return ipxt::csr_spmm_tile<float>(rows, B, indptr, indices, vals, U, Y, vw,
                                    tpr, rpg, stream);
}

// The fused K6: out[i, :] = sum over the nonzeros (i, k) of A of
// vals[k] W_s[k, :] (sum over the nonzeros (k, j) of A' of t_vals V[j, :])
// + W_slack[i, :] V[i, :], A given by (rows = m, indptr, indices, vals) and
// A' by (t_indptr, t_indices, t_vals); V, W_slack and out (m, B), W_s
// (n, B), all row-major. With partials, partials[blk, :] = sum over the rows
// of row block blk of V[i, :] out[i, :], the layout of the second K5 launch
// of the two-launch form at the same vw. partials and state may be null.
extern "C" int ipxt_normal_batched_f64(
    int64_t rows, int64_t B, const void* indptr, const void* indices,
    const void* vals, const void* t_indptr, const void* t_indices,
    const void* t_vals, const void* V, const void* w_struct,
    const void* w_slack, void* out, void* partials, const void* state,
    int vw, void* stream) {
  return ipxt::normal_batched<double>(rows, B, indptr, indices, vals,
                                      t_indptr, t_indices, t_vals, V,
                                      w_struct, w_slack, out, partials, state,
                                      vw, stream);
}

extern "C" int ipxt_normal_batched_f32(
    int64_t rows, int64_t B, const void* indptr, const void* indices,
    const void* vals, const void* t_indptr, const void* t_indices,
    const void* t_vals, const void* V, const void* w_struct,
    const void* w_slack, void* out, void* partials, const void* state,
    int vw, void* stream) {
  return ipxt::normal_batched<float>(rows, B, indptr, indices, vals,
                                     t_indptr, t_indices, t_vals, V, w_struct,
                                     w_slack, out, partials, state, vw,
                                     stream);
}

// out[b] = the sum of p[0..n, b], a warp a lane, for the n x B partials of
// a launch.
extern "C" int ipxt_lane_sum_f64(int64_t n, int64_t B, const void* p,
                                 void* out, void* stream) {
  return ipxt::lane_sum<double>(n, B, p, out, stream);
}

extern "C" int ipxt_lane_sum_f32(int64_t n, int64_t B, const void* p,
                                 void* out, void* stream) {
  return ipxt::lane_sum<float>(n, B, p, out, stream);
}
