// K11 newton_rhs and K12 newton_recover: the Newton right-hand side and the
// direction recovery around the normal-equations solve of one batched IPM
// step, for Hopper (sm_90a), in float64.
//
// Replaces: ipx_tpu/parallel/batch.py _ipm_step.newton, its right-hand side
// (SL/SU at 502-503 and 519-520, RHS1 and the reduction to the normal
// equations at 466-471) and its recovery after the CR (473-498). XLA fuses
// them into elementwise passes over (n + m, B) f64 arrays around the
// batched products.
//
// What bounds it on the H100: memory; a few flops per value. At n + m =
// 116 002, B = 256 each (n + m, B) array is 238 MB. K11's pass reads 8 of
// them (11 in the corrector) and writes 4; K12's passes read 13 and write 5.
//
// Design: elementwise passes on the layout of common.cuh, with the batched
// products between them left to K5 (the wrappers in kernels.py launch it):
//   K11  newton_rhs_kernel  SL, SU (predictor -XL ZL, or corrector
//                           -XL ZL + sigma mu - DXL DZL), RHS1 and W RHS1;
//        K5                 A (W RHS1)[:n];
//        normal_rhs_kernel  rhs = A (W RHS1)[:n] + (W RHS1)[n:] - RB.
//   K12  newton_dx_kernel   DX[:n] = W (RHS1 - A'DY) on the structural rows;
//        K5                 A DX[:n];
//        recover_kernel     the slack rows DX[n:] = RB - A DX[:n], then DXL,
//                           DZL, DXU, DZU, the use_l / use_u override, the
//                           clean-up of non-finite values, and DY = -DY.
// The reference's second product _AIt_mul(-DY) is the exact negation of
// _AIt_mul(DY): rounding to nearest is symmetric, so each of its sums is the
// negated sum of the same terms in the same order. K12 reuses A'DY negated.
// Every product, sum and quotient is rounded on its own (mul_rn, add_rn,
// div_rn, no FMA) in the order of the reference's expressions, a - b taken
// as a + (-b) (the same IEEE operation), and the quotients are taken only
// where the reference's jnp.where keeps them, so every output equals the
// plain version bit for bit.

#include "common.cuh"

namespace ipxt {
namespace {

struct NewtonArgs {
  int64_t n, m, B;
  const double* RC;    // (n + m, B)
  const double* RL;
  const double* RU;
  const double* XL;
  const double* XU;
  const double* ZL;
  const double* ZU;
  const double* W;
  const uint8_t* finl;  // (n + m,)
  const uint8_t* finu;
  const double* sigma;  // (B,), corrector only
  const double* mu;
  const double* DXL;    // the predictor's directions, corrector only
  const double* DZL;
  const double* DXU;
  const double* DZU;
  double* SL;
  double* SU;
  double* RHS1;
  double* WR;           // W RHS1
  const double* AWR;    // (m, B)  A (W RHS1)[:n]
  const double* RB;     // (m, B)
  double* rhs;          // (m, B)
  const double* ATDY;   // (n, B)  A' DY
  const double* DY;     // (m, B)
  const double* ADX;    // (m, B)  A DX[:n]
  double* DX;           // (n + m, B)
  double* DXLo;
  double* DXUo;
  double* DYn;          // (m, B)
  double* DZLo;
  double* DZUo;
};

__device__ __forceinline__ double finite_or_zero(double v) {
  return isfinite(v) ? v : 0.0;
}

template <bool kCorr>
__global__ void __launch_bounds__(kThreads) newton_rhs_kernel(NewtonArgs a) {
  const int64_t B = a.B, nm = a.n + a.m;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const double smu = kCorr ? mul_rn(a.sigma[b], a.mu[b]) : 0.0;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
       row < nm; row += (int64_t)gridDim.x * blockDim.y) {
    const int64_t i = row * B + b;
    const bool fl = a.finl[row] != 0, fu = a.finu[row] != 0;
    double sl = 0.0, su = 0.0, tl = 0.0, tu = 0.0;
    if (fl) {
      const double xl = a.XL[i], zl = a.ZL[i];
      sl = -mul_rn(xl, zl);
      if (kCorr) sl = add_rn(add_rn(sl, smu), -mul_rn(a.DXL[i], a.DZL[i]));
      tl = div_rn(add_rn(sl, mul_rn(zl, a.RL[i])), xl);   // (SL + ZL RL)/XL
    }
    if (fu) {
      const double xu = a.XU[i], zu = a.ZU[i];
      su = -mul_rn(xu, zu);
      if (kCorr) su = add_rn(add_rn(su, smu), -mul_rn(a.DXU[i], a.DZU[i]));
      tu = div_rn(add_rn(su, -mul_rn(zu, a.RU[i])), xu);  // (SU - ZU RU)/XU
    }
    const double r = add_rn(add_rn(-a.RC[i], tl), -tu);
    a.SL[i] = sl;
    a.SU[i] = su;
    a.RHS1[i] = r;
    a.WR[i] = mul_rn(a.W[i], r);
  }
}

// rhs = (A (W RHS1)[:n] + (W RHS1)[n:]) - RB over the m rows
__global__ void __launch_bounds__(kThreads) normal_rhs_kernel(NewtonArgs a) {
  const int64_t B = a.B, n = a.n;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B) return;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
       row < a.m; row += (int64_t)gridDim.x * blockDim.y) {
    const int64_t i = row * B + b;
    a.rhs[i] = add_rn(add_rn(a.AWR[i], a.WR[i + n * B]), -a.RB[i]);
  }
}

// DX = W (RHS1 - AI'DY) on the n structural rows
__global__ void __launch_bounds__(kThreads) newton_dx_kernel(NewtonArgs a) {
  const int64_t B = a.B;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B) return;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
       row < a.n; row += (int64_t)gridDim.x * blockDim.y) {
    const int64_t i = row * B + b;
    a.DX[i] = mul_rn(a.W[i], add_rn(a.RHS1[i], -a.ATDY[i]));
  }
}

__global__ void __launch_bounds__(kThreads) recover_kernel(NewtonArgs a) {
  const int64_t B = a.B, n = a.n, m = a.m, nm = a.n + a.m;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B) return;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
       row < nm; row += (int64_t)gridDim.x * blockDim.y) {
    const int64_t i = row * B + b;
    double dx;
    if (row < n) {
      dx = a.DX[i];
    } else {   // the slack rows: RB - A DX[:n]
      dx = add_rn(a.RB[i - n * B], -a.ADX[i - n * B]);
      a.DX[i] = dx;
    }
    if (row < m) a.DYn[i] = -a.DY[i];
    const bool fl = a.finl[row] != 0, fu = a.finu[row] != 0, fin = fl || fu;
    double dxl = 0.0, dzl = 0.0, dxu = 0.0, dzu = 0.0;
    if (fin) {
      const double xl = a.XL[i], xu = a.XU[i], zl = a.ZL[i], zu = a.ZU[i];
      const double rc = a.RC[i];
      dxl = add_rn(dx, -a.RL[i]);
      dzl = div_rn(add_rn(a.SL[i], -mul_rn(zl, dxl)), xl);
      dxu = add_rn(a.RU[i], -dx);
      dzu = div_rn(add_rn(a.SU[i], -mul_rn(zu, dxu)), xu);
      // AI'(-DY): the negated K5 product, and -DY on the slack rows
      const double atdyn = row < n ? -a.ATDY[i] : -a.DY[i - n * B];
      const bool lower = mul_rn(zl, xu) >= mul_rn(zu, xl);
      const bool use_l = isfinite(xl) && (!isfinite(xu) || lower);
      const bool use_u = isfinite(xu) && !use_l;
      if (use_l) dzl = add_rn(add_rn(rc, dzu), -atdyn);
      if (use_u) dzu = add_rn(add_rn(-rc, dzl), atdyn);
    }
    a.DXLo[i] = finite_or_zero(dxl);
    a.DXUo[i] = finite_or_zero(dxu);
    a.DZLo[i] = finite_or_zero(dzl);
    a.DZUo[i] = finite_or_zero(dzu);
  }
}

template <typename Kernel>
int launch_rows(Kernel k, const NewtonArgs& a, int64_t rows, void* stream) {
  if (a.B < 1 || a.n < 0 || a.m < 1) return (int)cudaErrorInvalidValue;
  const LaneGrid g = lane_grid(rows, a.B);
  k<<<dim3((unsigned)g.gx, (unsigned)g.gy), dim3((unsigned)g.tx,
                                                 (unsigned)g.ty), 0,
      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

NewtonArgs newton_args(int64_t n, int64_t m, int64_t B) {
  NewtonArgs a = {};
  a.n = n;
  a.m = m;
  a.B = B;
  return a;
}

}  // namespace
}  // namespace ipxt

#define D_(p) static_cast<const double*>(p)
#define O_(p) static_cast<double*>(p)

// K11, first pass: over the n + m rows, where finl (finu)
//   SL = -XL ZL [+ sigma mu - DXL DZL],  SU = -XU ZU [+ sigma mu - DXU DZU]
// (the bracket when sigma is not null: the corrector), else 0;
//   RHS1 = -RC + (finl ? (SL + ZL RL)/XL : 0) - (finu ? (SU - ZU RU)/XU : 0),
//   WR = W RHS1.
extern "C" int ipxt_newton_rhs_f64(
    int64_t n, int64_t m, int64_t B, const void* RC, const void* RL,
    const void* RU, const void* XL, const void* XU, const void* ZL,
    const void* ZU, const void* W, const void* finl, const void* finu,
    const void* sigma, const void* mu, const void* DXL, const void* DZL,
    const void* DXU, const void* DZU, void* SL, void* SU, void* RHS1,
    void* WR, void* stream) {
  ipxt::NewtonArgs a = ipxt::newton_args(n, m, B);
  a.RC = D_(RC);
  a.RL = D_(RL);
  a.RU = D_(RU);
  a.XL = D_(XL);
  a.XU = D_(XU);
  a.ZL = D_(ZL);
  a.ZU = D_(ZU);
  a.W = D_(W);
  a.finl = static_cast<const uint8_t*>(finl);
  a.finu = static_cast<const uint8_t*>(finu);
  a.sigma = D_(sigma);
  a.mu = D_(mu);
  a.DXL = D_(DXL);
  a.DZL = D_(DZL);
  a.DXU = D_(DXU);
  a.DZU = D_(DZU);
  a.SL = O_(SL);
  a.SU = O_(SU);
  a.RHS1 = O_(RHS1);
  a.WR = O_(WR);
  const bool corr = sigma != nullptr;
  if (corr && (mu == nullptr || DXL == nullptr || DZL == nullptr ||
               DXU == nullptr || DZU == nullptr))
    return (int)cudaErrorInvalidValue;
  return corr ? ipxt::launch_rows(ipxt::newton_rhs_kernel<true>, a, n + m,
                                  stream)
              : ipxt::launch_rows(ipxt::newton_rhs_kernel<false>, a, n + m,
                                  stream);
}

// K11, second pass: rhs = (AWR + WR[n:]) - RB over the m rows.
extern "C" int ipxt_normal_rhs_f64(int64_t n, int64_t m, int64_t B,
                                   const void* AWR, const void* WR,
                                   const void* RB, void* rhs, void* stream) {
  ipxt::NewtonArgs a = ipxt::newton_args(n, m, B);
  a.AWR = D_(AWR);
  a.WR = O_(const_cast<void*>(WR));
  a.RB = D_(RB);
  a.rhs = O_(rhs);
  return ipxt::launch_rows(ipxt::normal_rhs_kernel, a, m, stream);
}

// K12, first pass: DX[:n] = W[:n] (RHS1[:n] - ATDY) with ATDY = A' DY.
extern "C" int ipxt_newton_dx_f64(int64_t n, int64_t m, int64_t B,
                                  const void* ATDY, const void* RHS1,
                                  const void* W, void* DX, void* stream) {
  ipxt::NewtonArgs a = ipxt::newton_args(n, m, B);
  a.ATDY = D_(ATDY);
  a.RHS1 = O_(const_cast<void*>(RHS1));
  a.W = D_(W);
  a.DX = O_(DX);
  return ipxt::launch_rows(ipxt::newton_dx_kernel, a, n, stream);
}

// K12, second pass, over the n + m rows: DX[n:] = RB - ADX (ADX = A DX[:n]);
// DYn = -DY; where finl | finu: DXL = DX - RL, DZL = (SL - ZL DXL)/XL, DXU =
// RU - DX, DZU = (SU - ZU DXU)/XU, then DZL = RC + DZU - AI'(-DY) where
// use_l and DZU = -RC + DZL + AI'(-DY) where use_u; non-finite values of
// the four become 0.
extern "C" int ipxt_newton_recover_f64(
    int64_t n, int64_t m, int64_t B, const void* ATDY, const void* DY,
    const void* RB, const void* RC, const void* RL, const void* RU,
    const void* SL, const void* SU, const void* XL, const void* XU,
    const void* ZL, const void* ZU, const void* finl, const void* finu,
    const void* ADX, void* DX, void* DXL, void* DXU, void* DYn, void* DZL,
    void* DZU, void* stream) {
  ipxt::NewtonArgs a = ipxt::newton_args(n, m, B);
  a.ATDY = D_(ATDY);
  a.DY = D_(DY);
  a.RB = D_(RB);
  a.RC = D_(RC);
  a.RL = D_(RL);
  a.RU = D_(RU);
  a.SL = O_(const_cast<void*>(SL));
  a.SU = O_(const_cast<void*>(SU));
  a.XL = D_(XL);
  a.XU = D_(XU);
  a.ZL = D_(ZL);
  a.ZU = D_(ZU);
  a.finl = static_cast<const uint8_t*>(finl);
  a.finu = static_cast<const uint8_t*>(finu);
  a.ADX = D_(ADX);
  a.DX = O_(DX);
  a.DXLo = O_(DXL);
  a.DXUo = O_(DXU);
  a.DYn = O_(DYn);
  a.DZLo = O_(DZL);
  a.DZUo = O_(DZU);
  return ipxt::launch_rows(ipxt::recover_kernel, a, n + m, stream);
}
