// K7 batched_cr_step: one trip of the lane-masked batched Conjugate
// Residuals loop on the normal equations, for Hopper (sm_90a).
//
// Replaces: ipx_tpu/parallel/batch.py BatchedPhase1Solver._cr_loop, where
// the whole loop over B scenario lanes is one lax.while_loop with a
// per-lane freeze: a lane whose scaled residual meets its tolerance gets
// alpha = beta = 0 and keeps its solution. As with K3 (cr.cu), the host
// issues the passes of each trip, and the loop's scalars stay on the card:
//
//   kInit     S = R / diag, Y = 0                               (elementwise)
//   kStart    cdot[b] = sum of the K6 partials of S.CS          (lane pass)
//   per trip k:
//   kPassCA   D = S + beta D, CD = CS + beta CD (D = S, CD = CS at k = 0);
//             partials of CD.(CD / diag) and of max |resscale R|, per block
//             and lane                                          (elementwise)
//   kCheck    resnorm, active = resnorm > tol, alpha = (pdot > 0 & active)
//             ? cdot / pdot : 0                                 (lane pass)
//   kPassB    the loop test k < maxiter & any(active), then Y += alpha D,
//             R -= alpha CD, S -= alpha (CD / diag)             (elementwise)
//   (K6 on S: CS and the partials of S.CS)
//   kBeta     beta = active ? (cdot > 0 ? cdot_new / cdot : 0) : 0,
//             cdot = cdot_new, it = k + 1                       (lane pass)
//
// The lane passes give every lane one warp, and the lanes spread over
// blocks of eight warps (blocks_for(B, 8) blocks), as K10, K13 and K16 do
// (common.cuh). A warp reduces its lane's per-block partials in a fixed
// order: thread t takes partials t, t + 32, ..., then a shuffle tree.
// kPassCA writes its partials lane-major, (2, B, npa), so that kCheck's
// warps read contiguous values; K6's partials stay (npc, B), the layout K5
// writes for K6, K14 and K16, and kStart's and kBeta's warps read them with
// stride B, as K16's do.
//
// The loop test. It needs every lane's residual norm before the trip's
// update, and a lane pass that spans blocks cannot know "any lane active"
// without a sum across blocks. So kCheck writes each lane's `active`, and
// every block of kPassB reads the B flags (1-2 KB from L2) and ORs them with
// __syncthreads_or, an integer reduction whose result does not depend on
// order: no atomics, and every block reaches the same answer. When the test
// fails, kPassB returns before any update and its first block sets `done`;
// K6 and kBeta then return at once, so the trip count is exact, and the
// host polls `done` every few trips. The ratios are computed only where the
// reference's jnp.where keeps them, so a frozen lane never makes a 0/0 NaN;
// it still takes the update with alpha = beta = 0, so D becomes S and CD
// becomes CS, as in the reference. A stage repeats bit for bit.
//
// What bounds it on the H100: memory. The elementwise passes stream 3-8
// arrays of (m, B) values each (m = 20 000, B = 256: 20 MB an array in
// f32), about as much as the trip's K6; kPassCA carries the D / CD update of
// the trip before, so a trip has three of them. The lane passes read each
// partial once: kCheck 2 npa B values (2 MB in f32 at npa = 1024, B = 256,
// 0.6 us at 3.35 TB/s), kStart and kBeta npc B (1 MB). A warp's sum over
// npa = kMaxRowBlocks partials is 32 loads a thread; the loads of one warp
// are independent, so the pass is bound by L2 latency and its bytes, not by
// one thread walking all npa partials of its lane.
//
// The state array (type T): the slots of common.cuh, then kLaneSlots rows
// of B per-lane values.

#include "common.cuh"

namespace ipxt {
namespace {

enum Phase { kInit = 0, kStart = 1, kPassCA = 2, kCheck = 3, kPassB = 4,
             kBeta = 5 };

enum LaneSlot { kLCdot = 0, kLAlpha = 1, kLBeta = 2, kLActive = 3,
                kLResnorm = 4, kLaneSlots = 5 };

template <typename T>
struct BcrArgs {
  int64_t m, B;
  int64_t k;        // the host's trip count; equals `it` while the loop runs
  int64_t maxiter;
  const T* invd;      // (m, B) 1 / diag
  const T* resscale;  // (m, B)
  const T* tol;       // (B,)
  T* Y;
  T* R;
  T* S;
  const T* CS;        // written by K6
  T* D;
  T* CD;
  T* pa;              // (2, B, npa): sums of CD.(CD / diag), then maxima
  int64_t npa;
  const T* pc;        // (npc, B): K6 partials of S.CS
  int64_t npc;
  T* state;
};

template <typename T>
__device__ __forceinline__ T* lane_slot(T* st, int slot, int64_t B) {
  return st + kStateLen + slot * B;
}

template <typename T, int PHASE>
__global__ void __launch_bounds__(kThreads) bcr_elem_kernel(BcrArgs<T> a) {
  __shared__ T red[kThreads];
  // kPassB does not read `done`: its first block may set it during this
  // pass, and a block whose warps read it apart would leave some of them
  // at the barrier below. Its own test stops it instead, as it stopped the
  // trip that set `done` (kCheck leaves the flags, and k only grows).
  if (PHASE != kPassB && loop_done(a.state)) return;
  const int64_t B = a.B;
  if (PHASE == kPassB) {
    // the loop's test, on the residual before the trip's update: every
    // block reads the B flags kCheck wrote and ORs them, the same in all
    const int t = threadIdx.y * blockDim.x + threadIdx.x;
    const T* active = lane_slot(a.state, kLActive, B);
    int any = 0;
    for (int64_t l = t; l < B; l += (int64_t)blockDim.x * blockDim.y)
      any |= active[l] != T(0);
    any = __syncthreads_or(any);
    if (a.k >= a.maxiter || !any) {
      if (blockIdx.x == 0 && blockIdx.y == 0 && t == 0) a.state[kDone] = T(1);
      return;
    }
  }
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  const bool lane_ok = b < B;
  T sum[1] = {T(0)}, mx[1] = {T(0)};
  T alpha = T(0), beta = T(0);
  if (lane_ok) {
    alpha = lane_slot(a.state, kLAlpha, B)[b];
    beta = lane_slot(a.state, kLBeta, B)[b];
  }
  if (lane_ok) {
    for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
         row < a.m; row += (int64_t)gridDim.x * blockDim.y) {
      const int64_t i = row * B + b;
      if (PHASE == kInit) {
        a.S[i] = a.R[i] * a.invd[i];
        a.Y[i] = T(0);
      } else if (PHASE == kPassCA) {
        T d, cd;
        if (a.k == 0) {
          d = a.S[i];
          cd = a.CS[i];
        } else {
          d = a.S[i] + beta * a.D[i];
          cd = a.CS[i] + beta * a.CD[i];
        }
        a.D[i] = d;
        a.CD[i] = cd;
        sum[0] += cd * (cd * a.invd[i]);
        mx[0] = nan_max(mx[0], abs_val(a.resscale[i] * a.R[i]));
      } else {  // kPassB
        const T d = a.D[i], cd = a.CD[i];
        a.Y[i] += alpha * d;
        a.R[i] -= alpha * cd;
        a.S[i] -= alpha * (cd * a.invd[i]);
      }
    }
  }
  if (PHASE == kPassCA) {
    lane_reduce<T, 1>(sum, red, AddOp());
    lane_reduce<T, 1>(mx, red, MaxOp());
    if (threadIdx.y == 0 && lane_ok) {  // lane-major: (2, B, npa)
      a.pa[b * a.npa + blockIdx.x] = sum[0];
      a.pa[(B + b) * a.npa + blockIdx.x] = mx[0];
    }
  }
}

// The passes over the B lanes: one warp per lane, eight lanes a block.
template <typename T, int PHASE>
__global__ void __launch_bounds__(kThreads) bcr_lane_kernel(BcrArgs<T> a) {
  T* st = a.state;
  if (loop_done(st)) return;
  const int64_t B = a.B;
  const int64_t b = warp_lane();
  if (b >= B) return;  // whole warps: b is the warp's
  const bool first = (threadIdx.x & 31) == 0;
  T* cdot = lane_slot(st, kLCdot, B);
  if (PHASE == kCheck) {
    const T pdot = warp_partials(a.pa + b * a.npa, a.npa, T(0), AddOp());
    const T res = warp_partials(a.pa + (B + b) * a.npa, a.npa, T(0),
                                MaxOp());
    if (!first) return;
    const bool act = res > a.tol[b];
    lane_slot(st, kLResnorm, B)[b] = res;
    lane_slot(st, kLActive, B)[b] = act ? T(1) : T(0);
    lane_slot(st, kLAlpha, B)[b] =
        (pdot > T(0) && act) ? cdot[b] / pdot : T(0);
    return;
  }
  // kStart and kBeta: the lane's sum of K6's partials of S.CS, (npc, B)
  T s = T(0);
  for (int64_t r = threadIdx.x & 31; r < a.npc; r += 32) s += a.pc[r * B + b];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (!first) return;
  if (PHASE == kStart) {
    cdot[b] = s;
  } else {  // kBeta
    const T c = cdot[b];
    lane_slot(st, kLBeta, B)[b] =
        (lane_slot(st, kLActive, B)[b] != T(0) && c > T(0)) ? s / c : T(0);
    cdot[b] = s;
    if (b == 0) st[kIt] = T(a.k + 1);
  }
}

template <typename T>
int bcr_step(int phase, int64_t m, int64_t B, int64_t k, int64_t maxiter,
             const void* invd, const void* resscale, const void* tol, void* Y,
             void* R, void* S, const void* CS, void* D, void* CD, void* pa,
             int64_t npa, const void* pc, int64_t npc, void* state,
             void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  const LaneGrid g = lane_grid(m, B);
  if (npa != g.gx) return (int)cudaErrorInvalidValue;
  BcrArgs<T> a;
  a.m = m;
  a.B = B;
  a.k = k;
  a.maxiter = maxiter;
  a.invd = static_cast<const T*>(invd);
  a.resscale = static_cast<const T*>(resscale);
  a.tol = static_cast<const T*>(tol);
  a.Y = static_cast<T*>(Y);
  a.R = static_cast<T*>(R);
  a.S = static_cast<T*>(S);
  a.CS = static_cast<const T*>(CS);
  a.D = static_cast<T*>(D);
  a.CD = static_cast<T*>(CD);
  a.pa = static_cast<T*>(pa);
  a.npa = npa;
  a.pc = static_cast<const T*>(pc);
  a.npc = npc;
  a.state = static_cast<T*>(state);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)g.gx, (unsigned)g.gy);
  const dim3 block((unsigned)g.tx, (unsigned)g.ty);
  const unsigned lanes = (unsigned)blocks_for(B, kWarpsPerBlock);
  switch (phase) {
    case kInit: bcr_elem_kernel<T, kInit><<<grid, block, 0, s>>>(a); break;
    case kPassCA: bcr_elem_kernel<T, kPassCA><<<grid, block, 0, s>>>(a); break;
    case kPassB: bcr_elem_kernel<T, kPassB><<<grid, block, 0, s>>>(a); break;
    case kStart: bcr_lane_kernel<T, kStart><<<lanes, kThreads, 0, s>>>(a); break;
    case kCheck: bcr_lane_kernel<T, kCheck><<<lanes, kThreads, 0, s>>>(a); break;
    case kBeta: bcr_lane_kernel<T, kBeta><<<lanes, kThreads, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ipxt

// Length of the state array of a batched CR over B lanes.
extern "C" int64_t ipxt_bcr_state_len(int64_t B) {
  return ipxt::kStateLen + ipxt::kLaneSlots * B;
}

extern "C" int ipxt_bcr_step_f64(int phase, int64_t m, int64_t B, int64_t k,
                                 int64_t maxiter, const void* invd,
                                 const void* resscale, const void* tol,
                                 void* Y, void* R, void* S, const void* CS,
                                 void* D, void* CD, void* pa, int64_t npa,
                                 const void* pc, int64_t npc, void* state,
                                 void* stream) {
  return ipxt::bcr_step<double>(phase, m, B, k, maxiter, invd, resscale, tol,
                                Y, R, S, CS, D, CD, pa, npa, pc, npc, state,
                                stream);
}

extern "C" int ipxt_bcr_step_f32(int phase, int64_t m, int64_t B, int64_t k,
                                 int64_t maxiter, const void* invd,
                                 const void* resscale, const void* tol,
                                 void* Y, void* R, void* S, const void* CS,
                                 void* D, void* CD, void* pa, int64_t npa,
                                 const void* pc, int64_t npc, void* state,
                                 void* stream) {
  return ipxt::bcr_step<float>(phase, m, B, k, maxiter, invd, resscale, tol,
                               Y, R, S, CS, D, CD, pa, npa, pc, npc, state,
                               stream);
}
