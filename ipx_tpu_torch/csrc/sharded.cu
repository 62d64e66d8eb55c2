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
// No atomics anywhere.
//
//   K14 block_sum   out = scale * (((part_0 + part_1) + part_2) + ...): the
//                   psum of A_p' v_p (scaled by W_struct), of A_p' V_p, and
//                   of N_p (N_p' w). Replaces the psum of
//                   sharding.py:122-136, 162-175 and 560-569.
//   K15 sharded_cr_step  the passes of one ShardedDiagCR or
//                   sharded_cr_solve loop (sharding.py:221-273, 348-385):
//                   the host issues them, the loop's scalars stay on the
//                   card, every dot is the ordered sum over the blocks of
//                   the block's partials, and the residual norm is the max
//                   over all of them (the pmax).
//   K16 sharded_batched_cr_step  the passes of sharded_batched_cr_solve
//                   (sharding.py:429-475): the lane-masked CR over (m, B)
//                   arrays, B contiguous. Its lane reductions run across
//                   blocks as K10's do (common.cuh): a reducing pass writes
//                   per-block, per-lane partials and a finishing launch
//                   gives every lane one warp. K7's one-thread-per-lane
//                   pass is not copied.
//
// What bounds them on the H100: memory and launch latency. K14 reads P + 1
// arrays and writes one, one add per value read. K15's passes stream two to
// six m-vectors for a few flops per entry; at m = 20 000 a pass moves well
// under a megabyte, so launch latency sets a trip's time, as for K3. K16's
// elementwise passes stream 4-9 (m, B) arrays, 41 MB each at m = 20 000,
// B = 256 in f64, and are memory bound; its lane passes read the partials
// once. What the designs do about it: K15 fuses a trip's vector work into
// three passes as K3 does, K16 folds the D / CD update of a trip into the
// reducing pass of the next, and K14 is one pass over the parts.
//
// Blocks of rows. Row block p holds rows [row_off[p], row_off[p + 1]), and
// the CUDA blocks of a pass are laid out block by block (blk_off), so no
// CUDA block straddles two row blocks and the partials of row block p are
// the slice [blk_off[p], blk_off[p + 1]). The K1 / K5 partials of v.Cv are
// laid out the same way (pc_off). A row block may be empty.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include "common.cuh"

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
template <typename T>
__device__ T blocks_sum(const T* __restrict__ part,
                        const int64_t* __restrict__ off, int64_t P, T* red) {
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
// trip (kErr holds that of the trip before), and the residual norm the
// loop stopped at
enum ScrSlot { kErrTrip = 6, kResnorm = 7 };

template <typename T>
struct ScrArgs {
  int64_t m, P;
  int64_t k;          // the host's trip count; equals `it` while it runs
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
  const T* cs;        // C s, written by the block products
  T* d;
  T* cd;
  T* pa;              // (2, nblk): sums of cd.(cd / diag), then maxima
  int64_t nblk;
  const T* pc;
  T* state;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) scr_step_kernel(int phase,
                                                            ScrArgs<T> a) {
  __shared__ T red[kThreads];
  T* st = a.state;
  if (loop_done(st)) return;
  const int64_t g = blockIdx.x;
  const int64_t p = block_of(a.blk_off, a.P, g);
  const int64_t i = a.row_off[p] + (g - a.blk_off[p]) * kThreads + threadIdx.x;
  const bool in = i < a.row_off[p + 1];
  const bool lead = g == 0 && threadIdx.x == 0;
  switch (phase) {
    case kSInit: {  // s = r / diag, y = 0; r holds the right-hand side
      if (in) {
        a.s[i] = a.r[i] * a.invd[i];
        a.y[i] = T(0);
      }
      break;
    }
    case kSStart: {  // after C s: cdot, d = s, cd = C s
      const T cdot = blocks_sum(a.pc, a.pc_off, a.P, red);
      if (in) {
        a.d[i] = a.s[i];
        a.cd[i] = a.cs[i];
      }
      if (lead) st[kCdot0] = cdot;
      break;
    }
    case kSPassA: {  // partials of cd.(cd / diag) and of the residual norm
      T dsum = T(0), rmax = T(0);
      if (in) {
        const T c = a.cd[i];
        dsum = c * (c * a.invd[i]);
        rmax = abs_val(a.resscale != nullptr ? a.resscale[i] * a.r[i]
                                             : a.r[i]);
      }
      const T bs = block_sum(dsum, red);
      const T bm = block_max(rmax, red);
      if (threadIdx.x == 0) {
        a.pa[g] = bs;
        a.pa[a.nblk + g] = bm;
      }
      break;
    }
    case kSPassB: {  // the loop test, the ladder, the y / r / s update
      const T pdot = blocks_sum(a.pa, a.blk_off, a.P, red);
      const T resnorm = max_partials(a.pa + a.nblk, a.nblk, red);
      const T cdot = st[kCdot0 + (a.k & 1)];
      // the reference's while_loop test: a NaN norm stops it
      if (!(resnorm > a.tol) || a.k >= a.maxiter || st[kErr] != T(0)) {
        if (lead) {
          st[kResnorm] = resnorm;
          st[kDone] = T(1);
        }
        return;
      }
      T alpha = cdot / pdot;
      if (a.ladder) {
        int err = 0;
        if (cdot <= T(0)) err = 202;
        if (pdot <= T(0)) err = 203;
        if (!isfinite(alpha)) err = 205;
        if (err != 0) alpha = T(0);
        if (lead) st[kErrTrip] = T(err);
      }
      if (in) {
        const T c = a.cd[i];
        a.y[i] += alpha * a.d[i];
        a.r[i] -= alpha * c;
        a.s[i] -= alpha * (c * a.invd[i]);
      }
      break;
    }
    case kSPassC: {  // after C s: cdot_new, beta, the d / cd update
      const T cdot_n = blocks_sum(a.pc, a.pc_off, a.P, red);
      const T cdot = st[kCdot0 + (a.k & 1)];
      T beta = cdot_n / cdot;
      T err = T(0);
      if (a.ladder) {  // beta follows the trip's own error, as ok does
        err = st[kErrTrip];
        if (err != T(0)) beta = T(0);
        else if (!isfinite(cdot_n)) err = T(205);
      }
      if (in) {
        a.d[i] = a.s[i] + beta * a.d[i];
        a.cd[i] = a.cs[i] + beta * a.cd[i];
      }
      if (lead) {
        st[kCdot0 + ((a.k + 1) & 1)] = cdot_n;
        st[kIt] = T(a.k + 1);
        st[kErr] = err;
      }
      break;
    }
  }
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

extern "C" int ipxt_scr_step_f64(int phase, int64_t m, int64_t P, int64_t k,
                                 int64_t maxiter, double tol, int ladder,
                                 const void* row_off, const void* blk_off,
                                 const void* pc_off, const void* invd,
                                 const void* resscale, void* y, void* r,
                                 void* s, const void* cs, void* d, void* cd,
                                 void* pa, int64_t nblk, const void* pc,
                                 void* state, void* stream) {
  if (phase < kSInit || phase > kSPassC || nblk < 1)
    return (int)cudaErrorInvalidValue;
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
  a.cs = static_cast<const double*>(cs);
  a.d = static_cast<double*>(d);
  a.cd = static_cast<double*>(cd);
  a.pa = static_cast<double*>(pa);
  a.nblk = nblk;
  a.pc = static_cast<const double*>(pc);
  a.state = static_cast<double*>(state);
  scr_step_kernel<double><<<(unsigned)nblk, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(phase, a);
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
