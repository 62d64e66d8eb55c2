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
//   kStart    cdot[b] = sum of the K6 partials of S.CS          (one block)
//   per trip k:
//   kPassCA   D = S + beta D, CD = CS + beta CD (D = S, CD = CS at k = 0);
//             partials of CD.(CD / diag) and of max |resscale R|, per lane
//   kCheck    resnorm, active = resnorm > tol, the loop test
//             k < maxiter & any(active), alpha = (pdot > 0 & active) ?
//             cdot / pdot : 0                                   (one block)
//   kPassB    Y += alpha D, R -= alpha CD, S -= alpha (CD / diag)
//   (K6 on S: CS and the partials of S.CS)
//   kBeta     beta = active ? (cdot > 0 ? cdot_new / cdot : 0) : 0,
//             cdot = cdot_new, it = k + 1                       (one block)
//
// The loop test needs the column maximum over all m rows before the trip's
// update, so it is a cross-block reduction: per-block, per-lane partials
// that the one-block kCheck pass sums in a fixed order (no atomics, so a
// stage repeats bit for bit). When kCheck stops the loop it sets `done`,
// and every later pass and K6 launch returns at once: the host polls `done`
// every few trips and the trip count is exact. The ratios are computed only
// where the reference's jnp.where keeps them, so a frozen lane never makes
// a 0/0 NaN; it still takes the update with alpha = beta = 0, so D becomes
// S and CD becomes CS, as in the reference.
//
// What bounds it on the H100: memory in the elementwise passes, latency in
// the one-block passes. The three elementwise passes stream 3-8 arrays of
// (m, B) values each (m = 20 000, B = 256: 20 MB an array in f32), about as
// much as the K6 of the trip; fusing the D/CD update into the next trip's
// first pass saves one pass a trip. The one-block passes sum up to
// kMaxRowBlocks partials per lane in sequence, one thread per lane: at
// B = 256 on an H100 kCheck takes about 300 us (f32) and 450 us (f64) and
// kBeta about 100 us, more than the trip's K6. Spreading those sums over
// blocks is the next step for this kernel (PERF.md).
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
  T* pa;              // (2, npa, B): sums of CD.(CD / diag), then maxima
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
  if (loop_done(a.state)) return;
  const int64_t B = a.B;
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
    if (threadIdx.y == 0 && lane_ok) {
      a.pa[(int64_t)blockIdx.x * B + b] = sum[0];
      a.pa[(a.npa + blockIdx.x) * B + b] = mx[0];
    }
  }
}

// The passes over the B lanes: one block, thread t takes lanes t, t + 256...
template <typename T, int PHASE>
__global__ void __launch_bounds__(kThreads) bcr_lane_kernel(BcrArgs<T> a) {
  __shared__ T red[kThreads];
  T* st = a.state;
  if (loop_done(st)) return;
  const int64_t B = a.B;
  T* cdot = lane_slot(st, kLCdot, B);
  T* active = lane_slot(st, kLActive, B);
  if (PHASE == kStart) {
    for (int64_t b = threadIdx.x; b < B; b += kThreads)
      cdot[b] = lane_partials(a.pc, a.npc, B, b, T(0), AddOp());
  } else if (PHASE == kCheck) {
    T any = T(0);
    for (int64_t b = threadIdx.x; b < B; b += kThreads) {
      const T pdot = lane_partials(a.pa, a.npa, B, b, T(0), AddOp());
      const T res = lane_partials(a.pa + a.npa * B, a.npa, B, b, T(0),
                                  MaxOp());
      const bool act = res > a.tol[b];
      lane_slot(st, kLResnorm, B)[b] = res;
      active[b] = act ? T(1) : T(0);
      lane_slot(st, kLAlpha, B)[b] =
          (pdot > T(0) && act) ? cdot[b] / pdot : T(0);
      if (act) any = T(1);
    }
    any = block_max(any, red);
    // the loop's test, on the residual before the trip's update
    if (threadIdx.x == 0 && (a.k >= a.maxiter || any == T(0)))
      st[kDone] = T(1);
  } else {  // kBeta
    for (int64_t b = threadIdx.x; b < B; b += kThreads) {
      const T cn = lane_partials(a.pc, a.npc, B, b, T(0), AddOp());
      const T c = cdot[b];
      lane_slot(st, kLBeta, B)[b] =
          (active[b] != T(0) && c > T(0)) ? cn / c : T(0);
      cdot[b] = cn;
    }
    if (threadIdx.x == 0) st[kIt] = T(a.k + 1);
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
  switch (phase) {
    case kInit: bcr_elem_kernel<T, kInit><<<grid, block, 0, s>>>(a); break;
    case kPassCA: bcr_elem_kernel<T, kPassCA><<<grid, block, 0, s>>>(a); break;
    case kPassB: bcr_elem_kernel<T, kPassB><<<grid, block, 0, s>>>(a); break;
    case kStart: bcr_lane_kernel<T, kStart><<<1, kThreads, 0, s>>>(a); break;
    case kCheck: bcr_lane_kernel<T, kCheck><<<1, kThreads, 0, s>>>(a); break;
    case kBeta: bcr_lane_kernel<T, kBeta><<<1, kThreads, 0, s>>>(a); break;
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
