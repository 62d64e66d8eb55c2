// K3 cr_step: the Jacobi-preconditioned Conjugate Residuals loop on the
// normal equations, for Hopper (sm_90a).
//
// Replaces: ipx_tpu/ops/device_cr.py _build_cr_fn.cr, where the whole loop
// is one lax.while_loop. Its counterpart here is one cooperative launch per
// CR solve (cr_solve_kernel): the kernel runs the trips itself, with its K2
// applies (C sres, spmv_block.cuh) inside, and grid-wide barriers between
// the passes that read what an earlier pass wrote:
//
//   kPrecond  sres = r / diag and partials of r.sres         (P(residual))
//   K2        u = W_s (A' sres); Csres = A u + W_slack sres and partials
//             of sres.Csres (two halves, a barrier between them)
//   kInit     step = sres, Cstep = Csres, lhs = 0; rpn and cdot
//   per trip k:
//   kPassA    partials of Cstep.(Cstep/diag) and of max|resscale r|
//   kPassB    the stop test, then lhs/residual/sres axpys with alpha
//   K2        on sres
//   kPassC    step/Cstep update with beta
//   every 5th trip: kPrecond, K2 and kRecheck, the monotonicity test of the
//   preconditioned residual norm
//
// Stopping. Every block derives each stop decision (kPassB's tests, the
// iteration limit, kRecheck's stagnation) from the same partials, summed in
// the same fixed order (sum_partials), and from scalars it holds itself: the
// trip counter k, cdot and rpn are loop variables of every block, never read
// back from memory that another block writes. So all blocks leave the loop
// on the same trip and no block waits at a barrier that another has left.
// Only block 0's thread 0 writes the scalar state, for the host to read once
// after the launch.
//
// Sizing. The grid is what fits on the card at once (the occupancy API), as
// K4's (nnt.cu). Each physical block walks the virtual blocks of a pass,
// grid-stride: ipxt_cr_blocks(m) for the elementwise passes, the K2 plans'
// blocks for K2's halves. A virtual block does what the block of that index
// of a separate launch does and writes the partial slot that launch writes,
// so every sum keeps its order. An element of the m-vectors always falls to
// the same thread in the elementwise passes, so kPassC needs no barrier
// before the next kPassA or kPrecond; the barriers are those after kPassA,
// kPassB and each of K2's halves (4 a trip, 3 more every 5th trip).
//
// The old form stays as the C entry's second form, for comparison only:
// cr_step_kernel runs one pass per launch (`phase`), the host issues the
// passes and two K2 launches a trip and polls the stop flag every few trips
// (kernels.CrStep.solve with cooperative False). Both forms run the same
// pass bodies and K2's row body and give the same lhs, iterations and error
// code bit for bit.
//
// The stand-alone K2 (normal_apply_kernel, ipxt_normal_apply): one apply
// and its dot in one cooperative launch, the same k2_half bodies with a
// grid barrier after each and block 0 summing the partials, bit for bit
// with the three launches of spmv.cu. At m = 20 000 an apply moves about
// 2.3 MB (0.7 us at 3.35 TB/s); its time is the two barriers and two
// chains of dependent loads.
//
// What bounds it on the H100: memory and latency. Each pass streams two to
// six m-vectors (8 bytes per entry in f64, 4 in f32) for one or two flops
// per entry; at the main path's m = 20 000 a pass moves well under a
// megabyte, so the barriers and the loads' latency, not bandwidth, set the
// time of a trip. The host-issued form paid five launches and ctypes calls a
// trip instead.

#include <cooperative_groups.h>

#include "spmv_block.cuh"

namespace cg = cooperative_groups;

namespace ipxt {
namespace {

// error codes of the loop (ipx_tpu/ops/device_cr.py:52-57)
enum { kOk = 0, kIterLimit = 1, kNotPosdef = 2, kPrecondNotPosdef = 3,
       kNoProgress = 4, kInfNan = 5 };

enum Phase { kPrecond = 0, kInit = 1, kPassA = 2, kPassB = 3, kPassC = 4,
             kRecheck = 5 };

constexpr int64_t kRecheckEvery = 5;  // kernels.CrStep.RECHECK_EVERY

template <typename T>
struct CrArgs {
  int64_t m;
  int64_t k;        // the host's trip count (host-issued form only)
  int64_t maxiter;
  T tol;
  const T* invd;    // 1 / diag
  const T* resscale;
  T* lhs;
  T* residual;
  T* sres;
  T* csres;         // written by K2
  T* step;
  T* cstep;
  T* pa;            // kPassA partials: sums in [0, nblk), maxima after
  T* pr;            // kPrecond partials
  T* pc;            // K2 partials of sres.Csres
  int64_t nblk;     // blocks of an elementwise pass = length of pa/2, pr
  int64_t npc;      // length of pc
  T* state;
};

// -- the pass bodies, for virtual block vb ----------------------------------
template <typename T>
__device__ __forceinline__ void precond_pass(const CrArgs<T>& a, int64_t vb,
                                             T* red) {
  const int64_t i = vb * kThreads + threadIdx.x;
  T d = T(0);
  if (i < a.m) {
    const T r = a.residual[i];
    const T s = r * a.invd[i];
    a.sres[i] = s;
    d = r * s;
  }
  const T b = block_sum(d, red);
  if (threadIdx.x == 0) a.pr[vb] = b;
}

template <typename T>
__device__ __forceinline__ void init_pass(const CrArgs<T>& a, int64_t vb) {
  const int64_t i = vb * kThreads + threadIdx.x;
  if (i < a.m) {
    a.step[i] = a.sres[i];
    a.cstep[i] = a.csres[i];
    a.lhs[i] = T(0);
  }
}

template <typename T>
__device__ __forceinline__ void pass_a(const CrArgs<T>& a, int64_t vb,
                                       T* red) {
  const int64_t i = vb * kThreads + threadIdx.x;
  T d = T(0), r = T(0);
  if (i < a.m) {
    const T c = a.cstep[i];
    d = c * (c * a.invd[i]);
    r = abs_val(a.resscale[i] * a.residual[i]);
  }
  const T bs = block_sum(d, red);
  const T bm = block_max(r, red);
  if (threadIdx.x == 0) {
    a.pa[vb] = bs;
    a.pa[a.nblk + vb] = bm;
  }
}

// kPassB's stop test on trip k: the loop's error code, or -1 to go on with
// step length *alpha. Every thread of every block gets the same answer.
template <typename T>
__device__ __forceinline__ int stop_test(const CrArgs<T>& a, int64_t k,
                                         T cdot, T* red, T* alpha) {
  const T pdot = sum_partials(a.pa, a.nblk, red);
  const T resnorm = max_partials(a.pa + a.nblk, a.nblk, red);
  const bool converged = resnorm <= a.tol;
  const bool hit_limit = k >= a.maxiter;
  const bool not_posdef = cdot <= T(0);
  const bool precond_bad = pdot <= T(0);
  *alpha = cdot / pdot;
  const bool bad_alpha = !isfinite(*alpha);
  // a stop comes before the update and keeps the previous state
  return converged     ? kOk
         : hit_limit   ? kIterLimit
         : not_posdef  ? kNotPosdef
         : precond_bad ? kPrecondNotPosdef
         : bad_alpha   ? kInfNan
                       : -1;
}

template <typename T>
__device__ __forceinline__ void pass_b(const CrArgs<T>& a, int64_t vb,
                                       T alpha) {
  const int64_t i = vb * kThreads + threadIdx.x;
  if (i < a.m) {
    const T c = a.cstep[i];
    a.lhs[i] += alpha * a.step[i];
    a.residual[i] -= alpha * c;
    a.sres[i] -= alpha * (c * a.invd[i]);
  }
}

template <typename T>
__device__ __forceinline__ void pass_c(const CrArgs<T>& a, int64_t vb,
                                       T beta) {
  const int64_t i = vb * kThreads + threadIdx.x;
  if (i < a.m) {
    a.step[i] = a.sres[i] + beta * a.step[i];
    a.cstep[i] = a.csres[i] + beta * a.cstep[i];
  }
}

// -- the host-issued form: one pass a launch --------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) cr_step_kernel(int phase,
                                                           CrArgs<T> a) {
  __shared__ T red[kThreads];
  T* st = a.state;
  if (loop_done(st)) return;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const T cdot = st[kCdot0 + (a.k & 1)];
  switch (phase) {
    case kPrecond:
      precond_pass(a, blockIdx.x, red);
      break;
    case kInit: {
      const T rpn = sum_partials(a.pr, a.nblk, red);
      const T cdot0 = sum_partials(a.pc, a.npc, red);
      init_pass(a, blockIdx.x);
      if (lead) {
        st[kRpn] = rpn;
        st[kCdot0] = cdot0;
      }
      break;
    }
    case kPassA:
      pass_a(a, blockIdx.x, red);
      break;
    case kPassB: {
      T alpha;
      const int code = stop_test(a, a.k, cdot, red, &alpha);
      if (code >= 0) {
        // set only when every block of this launch does no vector work
        if (lead) {
          st[kErr] = T(code);
          st[kDone] = T(1);
        }
        return;
      }
      pass_b(a, blockIdx.x, alpha);
      break;
    }
    case kPassC: {
      const T cdot_n = sum_partials(a.pc, a.npc, red);
      pass_c(a, blockIdx.x, cdot_n / cdot);
      if (lead) {
        st[kCdot0 + ((a.k + 1) & 1)] = cdot_n;
        st[kIt] = T(a.k + 1);
      }
      break;
    }
    case kRecheck: {  // launched with one block
      const T rsdot = sum_partials(a.pr, a.nblk, red);
      const T cdot_re = sum_partials(a.pc, a.npc, red);
      if (lead) {
        const bool stagnated = rsdot >= st[kRpn];
        st[kRpn] = rsdot;
        st[kCdot0 + ((a.k + 1) & 1)] = cdot_re;
        if (stagnated) {  // the update of this trip stands
          st[kErr] = T(kNoProgress);
          st[kDone] = T(1);
        }
      }
      break;
    }
  }
}

// -- the cooperative form: a whole solve in one launch ----------------------
template <typename T>
struct SolveArgs {
  CrArgs<T> cr;
  Rows at, a;          // A' (n rows) and A (m rows), K2's: at op.vec
  const T* w_struct;   // W[:n]
  const T* w_slack;    // W[n:]
  T* u;                // K2's (n,) scratch
};

// K2's half over the virtual blocks of operand `op`, through K1's row body
// with plain loads of x (written earlier in this launch)
template <typename T, int VEC>
__device__ __forceinline__ void k2_rows(const Rows& op, const T* x,
                                        const T* rowscale, const T* addw,
                                        const T* addv, T* y, T* partials,
                                        T* red) {
  const int64_t nb = blocks_for(op.rows, kThreads / VEC);
  for (int64_t vb = blockIdx.x; vb < nb; vb += gridDim.x)
    spmv_block<T, VEC, false>(op.rows, vb, op.indptr, op.indices,
                              static_cast<const T*>(op.vals), x, rowscale,
                              addw, addv, y,
                              partials != nullptr ? partials + vb : nullptr,
                              red);
}

template <typename T>
__device__ void k2_half(const Rows& op, const T* x, const T* rowscale,
                        const T* addw, const T* addv, T* y, T* partials,
                        T* red) {
  switch (op.vec) {  // the same for every thread
    case 2: k2_rows<T, 2>(op, x, rowscale, addw, addv, y, partials, red); break;
    case 4: k2_rows<T, 4>(op, x, rowscale, addw, addv, y, partials, red); break;
    case 8: k2_rows<T, 8>(op, x, rowscale, addw, addv, y, partials, red); break;
    case 16: k2_rows<T, 16>(op, x, rowscale, addw, addv, y, partials, red); break;
    default: k2_rows<T, 32>(op, x, rowscale, addw, addv, y, partials, red); break;
  }
}

// Csres = C sres and the partials of sres.Csres in pc; the caller has put a
// barrier after the pass that wrote sres. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void k2_apply(const SolveArgs<T>& s,
                                         cg::grid_group& grid, T* red) {
  const CrArgs<T>& a = s.cr;
  k2_half<T>(s.at, a.sres, s.w_struct, nullptr, nullptr, s.u, nullptr, red);
  grid.sync();
  k2_half<T>(s.a, s.u, nullptr, s.w_slack, a.sres, a.csres, a.pc, red);
  grid.sync();
}

// -- the stand-alone K2: one apply and its dot in one launch -----------------
template <typename T>
struct ApplyArgs {
  Rows at, a;          // A' (n rows) and A (m rows), at their op.vec
  const T* v;
  const T* w_struct;   // W[:n]
  const T* w_slack;    // W[n:]
  T* u;                // (n,) scratch
  T* out;
  T* pc;               // the partials of v.out, npc of them
  int64_t npc;
  T* dot;
};

// out = A (W_s (A' v)) + W_slack v and dot = v.out: K2's halves, each over
// the virtual blocks and into the partial slots of its launch in the
// three-launch form, then block 0 sums the partials as reduce_sum's one
// block does. So out, the partials and dot equal that form's bit for bit.
template <typename T>
__global__ void __launch_bounds__(kThreads) normal_apply_kernel(
    ApplyArgs<T> s) {
  __shared__ T red[kThreads];
  cg::grid_group grid = cg::this_grid();
  k2_half<T>(s.at, s.v, s.w_struct, nullptr, nullptr, s.u, nullptr, red);
  grid.sync();
  k2_half<T>(s.a, s.u, nullptr, s.w_slack, s.v, s.out, s.pc, red);
  grid.sync();
  if (blockIdx.x == 0) {
    const T d = sum_partials(s.pc, s.npc, red);
    if (threadIdx.x == 0) s.dot[0] = d;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cr_solve_kernel(SolveArgs<T> s) {
  __shared__ T red[kThreads];
  cg::grid_group grid = cg::this_grid();
  const CrArgs<T>& a = s.cr;
  T* st = a.state;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const int64_t g0 = blockIdx.x, gs = gridDim.x;
  for (int64_t vb = g0; vb < a.nblk; vb += gs) precond_pass(a, vb, red);
  grid.sync();
  k2_apply(s, grid, red);
  T rpn = sum_partials(a.pr, a.nblk, red);
  T cdot = sum_partials(a.pc, a.npc, red);
  for (int64_t vb = g0; vb < a.nblk; vb += gs) init_pass(a, vb);
  if (lead) {
    st[kRpn] = rpn;
    st[kCdot0] = cdot;
  }
  int64_t applies = 1;
  for (int64_t k = 0;; ++k) {
    for (int64_t vb = g0; vb < a.nblk; vb += gs) pass_a(a, vb, red);
    grid.sync();
    T alpha;
    const int code = stop_test(a, k, cdot, red, &alpha);
    if (code >= 0) {
      if (lead) {
        st[kErr] = T(code);
        st[kDone] = T(1);
        st[kApplies] = T(applies);
      }
      return;  // every block, on this same trip
    }
    for (int64_t vb = g0; vb < a.nblk; vb += gs) pass_b(a, vb, alpha);
    grid.sync();
    k2_apply(s, grid, red);
    ++applies;
    const T cdot_n = sum_partials(a.pc, a.npc, red);
    const T beta = cdot_n / cdot;
    for (int64_t vb = g0; vb < a.nblk; vb += gs) pass_c(a, vb, beta);
    cdot = cdot_n;
    if (lead) {
      st[kCdot0 + ((k + 1) & 1)] = cdot_n;
      st[kIt] = T(k + 1);
    }
    if ((k + 1) % kRecheckEvery == 0) {
      for (int64_t vb = g0; vb < a.nblk; vb += gs) precond_pass(a, vb, red);
      grid.sync();
      k2_apply(s, grid, red);
      ++applies;
      const T rsdot = sum_partials(a.pr, a.nblk, red);
      cdot = sum_partials(a.pc, a.npc, red);
      const bool stagnated = rsdot >= rpn;
      rpn = rsdot;
      if (lead) {
        st[kRpn] = rsdot;
        st[kCdot0 + ((k + 1) & 1)] = cdot;
      }
      if (stagnated) {  // the update of this trip stands
        if (lead) {
          st[kErr] = T(kNoProgress);
          st[kDone] = T(1);
          st[kApplies] = T(applies);
        }
        return;
      }
    }
  }
}

template <typename T>
CrArgs<T> make_args(int64_t m, int64_t k, int64_t maxiter, double tol,
                    const void* invd, const void* resscale, void* lhs,
                    void* residual, void* sres, const void* csres, void* step,
                    void* cstep, void* pa, void* pr, const void* pc,
                    int64_t npc, void* state) {
  CrArgs<T> a;
  a.m = m;
  a.k = k;
  a.maxiter = maxiter;
  a.tol = static_cast<T>(tol);
  a.invd = static_cast<const T*>(invd);
  a.resscale = static_cast<const T*>(resscale);
  a.lhs = static_cast<T*>(lhs);
  a.residual = static_cast<T*>(residual);
  a.sres = static_cast<T*>(sres);
  a.csres = static_cast<T*>(const_cast<void*>(csres));
  a.step = static_cast<T*>(step);
  a.cstep = static_cast<T*>(cstep);
  a.pa = static_cast<T*>(pa);
  a.pr = static_cast<T*>(pr);
  a.pc = static_cast<T*>(const_cast<void*>(pc));
  a.nblk = blocks_for(m, kThreads) > 0 ? blocks_for(m, kThreads) : 1;
  a.npc = npc;
  a.state = static_cast<T*>(state);
  return a;
}

template <typename T>
int cr_step(int phase, int64_t m, int64_t k, int64_t maxiter, double tol,
            const void* invd, const void* resscale, void* lhs,
            void* residual, void* sres, const void* csres, void* step,
            void* cstep, void* pa, void* pr, const void* pc, int64_t npc,
            void* state, void* stream) {
  if (phase < kPrecond || phase > kRecheck) return (int)cudaErrorInvalidValue;
  const CrArgs<T> a = make_args<T>(m, k, maxiter, tol, invd, resscale, lhs,
                                   residual, sres, csres, step, cstep, pa, pr,
                                   pc, npc, state);
  const int64_t grid = phase == kRecheck ? 1 : a.nblk;
  cr_step_kernel<T><<<(unsigned)grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(phase, a);
  return (int)cudaGetLastError();
}

template <typename T>
int cr_solve(int64_t m, int64_t maxiter, double tol, const void* invd,
             const void* resscale, void* lhs, void* residual, void* sres,
             void* csres, void* step, void* cstep, void* pa, void* pr,
             void* pc, int64_t npc, void* state, int64_t rows_t,
             const void* indptr_t, const void* indices_t, const void* vals_t,
             int vec_t, const void* indptr_a, const void* indices_a,
             const void* vals_a, int vec_a, const void* W, void* u,
             void* stream) {
  if (m < 1 || rows_t < 0 || !valid_vec(vec_t) || !valid_vec(vec_a) ||
      npc != blocks_for(m, kThreads / vec_a))
    return (int)cudaErrorInvalidValue;
  SolveArgs<T> s;
  s.cr = make_args<T>(m, 0, maxiter, tol, invd, resscale, lhs, residual,
                      sres, csres, step, cstep, pa, pr, pc, npc, state);
  s.at = make_rows(rows_t, indptr_t, indices_t, vals_t, vec_t);
  s.a = make_rows(m, indptr_a, indices_a, vals_a, vec_a);
  s.w_struct = static_cast<const T*>(W);
  s.w_slack = static_cast<const T*>(W) + rows_t;
  s.u = static_cast<T*>(u);
  const int64_t nt = blocks_for(rows_t, kThreads / vec_t);
  int64_t grid = s.cr.nblk;
  if (nt > grid) grid = nt;
  if (npc > grid) grid = npc;
  int64_t cap = 0;
  const int err = coop_capacity<cr_solve_kernel<T>>(&cap);
  if (err != 0) return err;
  if (grid > cap) grid = cap;  // the virtual blocks are walked grid-stride
  void* args[] = {&s};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      (const void*)cr_solve_kernel<T>, dim3((unsigned)grid), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream));
  // read and clear the last error too, so that a refusal is reported here
  // and not by the next launch of another entry point
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}

template <typename T>
int normal_apply(int64_t rows_t, const void* indptr_t, const void* indices_t,
                 const void* vals_t, int vec_t, int64_t rows_a,
                 const void* indptr_a, const void* indices_a,
                 const void* vals_a, int vec_a, const void* W, const void* v,
                 void* u, void* out, void* pc, int64_t npc, void* dot,
                 void* stream) {
  if (rows_t < 0 || rows_a < 1 || !valid_vec(vec_t) || !valid_vec(vec_a) ||
      npc != blocks_for(rows_a, kThreads / vec_a))
    return (int)cudaErrorInvalidValue;
  ApplyArgs<T> s;
  s.at = make_rows(rows_t, indptr_t, indices_t, vals_t, vec_t);
  s.a = make_rows(rows_a, indptr_a, indices_a, vals_a, vec_a);
  s.v = static_cast<const T*>(v);
  s.w_struct = static_cast<const T*>(W);
  s.w_slack = static_cast<const T*>(W) + rows_t;
  s.u = static_cast<T*>(u);
  s.out = static_cast<T*>(out);
  s.pc = static_cast<T*>(pc);
  s.npc = npc;
  s.dot = static_cast<T*>(dot);
  int64_t cap = 0;
  const int err = coop_capacity<normal_apply_kernel<T>>(&cap);
  if (err != 0) return err;
  // the virtual blocks of the larger half, at most what the card holds at
  // once (fewer blocks were slower: PERF.md §6)
  int64_t g = blocks_for(rows_t, kThreads / vec_t);
  if (npc > g) g = npc;
  if (g > cap) g = cap;
  void* args[] = {&s};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      (const void*)normal_apply_kernel<T>, dim3((unsigned)g), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}

}  // namespace
}  // namespace ipxt

// Blocks of an elementwise pass over m entries: the length of the pr
// partials and of each half of the pa partials.
extern "C" int64_t ipxt_cr_blocks(int64_t m) {
  const int64_t b = ipxt::blocks_for(m, ipxt::kThreads);
  return b > 0 ? b : 1;
}

extern "C" int64_t ipxt_cr_state_len() { return ipxt::kStateLen; }

// The host-issued form: one pass (`phase`) of trip k. The solvers never ask
// for it; the card tests and chip_smoke.py hold the cooperative form
// against it.
extern "C" int ipxt_cr_step_f64(int phase, int64_t m, int64_t k,
                                int64_t maxiter, double tol, const void* invd,
                                const void* resscale, void* lhs,
                                void* residual, void* sres, const void* csres,
                                void* step, void* cstep, void* pa, void* pr,
                                const void* pc, int64_t npc, void* state,
                                void* stream) {
  return ipxt::cr_step<double>(phase, m, k, maxiter, tol, invd, resscale, lhs,
                               residual, sres, csres, step, cstep, pa, pr, pc,
                               npc, state, stream);
}

extern "C" int ipxt_cr_step_f32(int phase, int64_t m, int64_t k,
                                int64_t maxiter, double tol, const void* invd,
                                const void* resscale, void* lhs,
                                void* residual, void* sres, const void* csres,
                                void* step, void* cstep, void* pa, void* pr,
                                const void* pc, int64_t npc, void* state,
                                void* stream) {
  return ipxt::cr_step<float>(phase, m, k, maxiter, tol, invd, resscale, lhs,
                              residual, sres, csres, step, cstep, pa, pr, pc,
                              npc, state, stream);
}

// A whole CR solve in one cooperative launch: the buffers of cr_step, A'
// (rows_t = n rows) and A (m rows) as CSR operands summed at vec_t and
// vec_a lanes per row (npc must be A's blocks at vec_a), W (n + m) and the
// (n,) scratch u. The state must hold zeros; on return (asynchronously) it
// holds the iterations, the error code, done and the K2 applies the launch
// ran (common.cuh). A refused launch is returned as such.
extern "C" int ipxt_cr_solve_f64(
    int64_t m, int64_t maxiter, double tol, const void* invd,
    const void* resscale, void* lhs, void* residual, void* sres, void* csres,
    void* step, void* cstep, void* pa, void* pr, void* pc, int64_t npc,
    void* state, int64_t rows_t, const void* indptr_t, const void* indices_t,
    const void* vals_t, int vec_t, const void* indptr_a,
    const void* indices_a, const void* vals_a, int vec_a, const void* W,
    void* u, void* stream) {
  return ipxt::cr_solve<double>(
      m, maxiter, tol, invd, resscale, lhs, residual, sres, csres, step,
      cstep, pa, pr, pc, npc, state, rows_t, indptr_t, indices_t, vals_t,
      vec_t, indptr_a, indices_a, vals_a, vec_a, W, u, stream);
}

extern "C" int ipxt_cr_solve_f32(
    int64_t m, int64_t maxiter, double tol, const void* invd,
    const void* resscale, void* lhs, void* residual, void* sres, void* csres,
    void* step, void* cstep, void* pa, void* pr, void* pc, int64_t npc,
    void* state, int64_t rows_t, const void* indptr_t, const void* indices_t,
    const void* vals_t, int vec_t, const void* indptr_a,
    const void* indices_a, const void* vals_a, int vec_a, const void* W,
    void* u, void* stream) {
  return ipxt::cr_solve<float>(
      m, maxiter, tol, invd, resscale, lhs, residual, sres, csres, step,
      cstep, pa, pr, pc, npc, state, rows_t, indptr_t, indices_t, vals_t,
      vec_t, indptr_a, indices_a, vals_a, vec_a, W, u, stream);
}

// The stand-alone K2 in one cooperative launch: out = A (W[:n] (A' v)) +
// W[n:] v, the block partials of v.out in pc (npc = A's blocks at vec_a)
// and their sum in dot[0], bit for bit with two ipxt_csr_spmv launches and
// ipxt_reduce_sum. A' has rows_t = n rows, A rows_a = m; u is (n,) scratch.
// The grid is the larger half's virtual blocks, capped by the card's
// occupancy; the blocks walk the virtual blocks grid-stride. A refused
// launch is returned as such.
extern "C" int ipxt_normal_apply_f64(
    int64_t rows_t, const void* indptr_t, const void* indices_t,
    const void* vals_t, int vec_t, int64_t rows_a, const void* indptr_a,
    const void* indices_a, const void* vals_a, int vec_a, const void* W,
    const void* v, void* u, void* out, void* pc, int64_t npc, void* dot,
    void* stream) {
  return ipxt::normal_apply<double>(rows_t, indptr_t, indices_t, vals_t,
                                    vec_t, rows_a, indptr_a, indices_a,
                                    vals_a, vec_a, W, v, u, out, pc, npc,
                                    dot, stream);
}

extern "C" int ipxt_normal_apply_f32(
    int64_t rows_t, const void* indptr_t, const void* indices_t,
    const void* vals_t, int vec_t, int64_t rows_a, const void* indptr_a,
    const void* indices_a, const void* vals_a, int vec_a, const void* W,
    const void* v, void* u, void* out, void* pc, int64_t npc, void* dot,
    void* stream) {
  return ipxt::normal_apply<float>(rows_t, indptr_t, indices_t, vals_t,
                                   vec_t, rows_a, indptr_a, indices_a,
                                   vals_a, vec_a, W, v, u, out, pc, npc, dot,
                                   stream);
}
