// K10 ipm_prologue: the residuals, the convergence test and the KKT weights
// at the start of one batched IPM step, for Hopper (sm_90a), in float64.
//
// Replaces: ipx_tpu/parallel/batch.py _residuals (411-420), _mu_of
// (422-429), and in _ipm_step the convergence test (443-455) and the KKT
// weights (457-463). XLA fuses those into elementwise passes and eleven
// column reductions over (n + m, B) f64 arrays.
//
// What bounds it on the H100: memory. The reducing pass reads X, XL, XU, ZL,
// ZU and cT over n + m rows, the two K5 products A X[:n] and A' Y, bT, Y and
// the slack rows of X, and writes RB, RC, RL, RU and G: at n + m = 116 002,
// m = 20 000, B = 256 about 1.8 GB read and 1.0 GB written, 0.84 ms at
// 3.35 TB/s. The weights pass reads G and writes W and resscale (0.5 GB).
//
// Design: three launches.
//  1. prologue_reduce_kernel: the elementwise residuals and G = ZL/XL + ZU/XU
//     (kept in W's buffer), and per block and lane the 11 reductions: max
//     |RB|, |RL|, |RU|, |RC|; the sums c.X, b.Y, lb.ZL (finl), ub.ZU (finu),
//     XL.ZL (finl), XU.ZU (finu); the minimum of G over G > 0. A block is up
//     to 32 lanes by 8 or more rows (red_grid in common.cuh), so that the
//     pass is a reduction across blocks; the partials are (11, B, blocks).
//  2. prologue_lane_kernel: one warp per lane reduces the partials in a
//     fixed order with shuffles, then computes mu, pobj, dobj, gap, pres,
//     dres, done, regval = min(mu, min G) and tol, as _ipm_step does.
//  3. prologue_weights_kernel: W = G > 0 ? 1/G : 1/regval, resscale =
//     1/sqrt(W[n:]), elementwise.
// No atomics, so two runs agree bit for bit. The elementwise results use
// add_rn / mul_rn / div_rn / __dsqrt_rn (no FMA contraction) and take the
// quotients only where the reference's jnp.where keeps them, so they equal
// the plain version bit for bit; the maxima and the minimum are exact; the
// sums differ from torch.sum by their order of rounding.
//
// ipxt_lane_mu_f64 is the complementarity part alone (_mu_of), for the
// callers that need mu of a state outside a step.

#include "common.cuh"

namespace ipxt {
namespace {

// rows of the (kLaneLen, B) per-lane output
enum LaneRow { kMu = 0, kPobj, kDobj, kGap, kPres, kDres, kRegval, kTol,
               kLaneLen };
// the quantities of the partials: 4 maxima of |.|, 6 sums, 1 minimum
enum Quantity { kMaxRB = 0, kSumCX = 4, kMinG = 10, kNumQ = 11 };

struct ProArgs {
  int64_t n, m, B;
  const double* AX;    // (m, B)  A X[:n]
  const double* ATY;   // (n, B)  A' Y
  const double* X;     // (n + m, B)
  const double* XL;
  const double* XU;
  const double* Y;     // (m, B)
  const double* ZL;
  const double* ZU;
  const double* bT;    // (m, B)
  const double* cT;    // (n + m, B)
  const double* lb;    // (n + m,)
  const double* ub;
  const uint8_t* finl;  // (n + m,) 0 or 1
  const uint8_t* finu;
  const uint8_t* done_in;  // (B,)
  double* RB;          // (m, B)
  double* RC;          // (n + m, B)
  double* RL;
  double* RU;
  double* W;           // (n + m, B); holds G between launches 1 and 3
  double* resscale;    // (m, B)
  double* partials;    // (kNumQ, B, nblk)
  int64_t nblk;
  double* lane;        // (kLaneLen, B)
  uint8_t* done_out;   // (B,)
  double feas_b, feas_c, opt_tol, kkt_tol;
  double num_fin;      // max(sum(finl) + sum(finu), 1)
};

__global__ void __launch_bounds__(kThreads)
prologue_reduce_kernel(ProArgs a) {
  __shared__ double red[kThreads * 6];
  const int64_t B = a.B, n = a.n, m = a.m, nm = a.n + a.m;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  double mx[4] = {0.0, 0.0, 0.0, 0.0};   // |RB|, |RL|, |RU|, |RC|
  // c.X, b.Y, lb.ZL, ub.ZU, XL.ZL, XU.ZU
  double sm[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  double mn[1] = {INFINITY};
  if (b < B) {
    for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
         row < nm; row += (int64_t)gridDim.x * blockDim.y) {
      const int64_t i = row * B + b;
      const bool fl = a.finl[row] != 0, fu = a.finu[row] != 0;
      const double x = a.X[i], xl = a.XL[i], xu = a.XU[i], zl = a.ZL[i],
                   zu = a.ZU[i], c = a.cT[i];
      const double aity = row < n ? a.ATY[i] : a.Y[i - n * B];
      // RC = cT - AI'Y - ZL + ZU, left to right
      const double rc = add_rn(add_rn(add_rn(c, -aity), -zl), zu);
      a.RC[i] = rc;
      mx[3] = nan_max(mx[3], abs_val(rc));
      double rl = 0.0, ru = 0.0, gl = 0.0, gu = 0.0;
      if (fl) {
        rl = add_rn(add_rn(a.lb[row], -x), xl);   // lb - X + XL
        gl = div_rn(zl, xl);
        sm[2] += a.lb[row] * zl;
        sm[4] += xl * zl;
      }
      if (fu) {
        ru = add_rn(add_rn(a.ub[row], -x), -xu);  // ub - X - XU
        gu = div_rn(zu, xu);
        sm[3] += a.ub[row] * zu;
        sm[5] += xu * zu;
      }
      a.RL[i] = rl;
      a.RU[i] = ru;
      mx[1] = nan_max(mx[1], abs_val(rl));
      mx[2] = nan_max(mx[2], abs_val(ru));
      const double g = add_rn(gl, gu);
      a.W[i] = g;
      if (g > 0.0) mn[0] = MinOp()(mn[0], g);   // G > 0 leaves out NaN
      sm[0] += c * x;
      if (row < m) {   // RB = bT - (A X[:n] + X[n:])
        const double rb = add_rn(a.bT[i], -add_rn(a.AX[i], a.X[i + n * B]));
        a.RB[i] = rb;
        mx[0] = nan_max(mx[0], abs_val(rb));
        sm[1] += a.bT[i] * a.Y[i];
      }
    }
  }
  lane_reduce<double, 4>(mx, red, MaxOp());
  lane_reduce<double, 6>(sm, red, AddOp());
  lane_reduce<double, 1>(mn, red, MinOp());
  store_partials<double, 4>(mx, a.partials, kMaxRB, B, b, a.nblk);
  store_partials<double, 6>(sm, a.partials, kSumCX, B, b, a.nblk);
  store_partials<double, 1>(mn, a.partials, kMinG, B, b, a.nblk);
}

__global__ void __launch_bounds__(kThreads) prologue_lane_kernel(ProArgs a) {
  const int64_t b = warp_lane();
  if (b >= a.B) return;   // the whole warp: it serves one lane
  const int64_t B = a.B, nb = a.nblk;
  double r[kNumQ];
#pragma unroll
  for (int q = 0; q < kNumQ; ++q) {
    const double* p = a.partials + ((int64_t)q * B + b) * nb;
    if (q < kSumCX)
      r[q] = warp_partials(p, nb, 0.0, MaxOp());
    else if (q < kMinG)
      r[q] = warp_partials(p, nb, 0.0, AddOp());
    else
      r[q] = warp_partials(p, nb, (double)INFINITY, MinOp());
  }
  if ((threadIdx.x & 31) != 0) return;
  const double mu = div_rn(add_rn(r[8], r[9]), a.num_fin);
  const double pres = nan_max(r[0], nan_max(r[1], r[2]));
  const double dres = r[3];
  const double pobj = r[4];
  const double dobj = add_rn(add_rn(r[5], r[6]), -r[7]);
  const double gap = div_rn(abs_val(add_rn(pobj, -dobj)),
                            add_rn(1.0, mul_rn(0.5, abs_val(add_rn(pobj,
                                                                   dobj)))));
  const bool conv = pres <= a.feas_b && dres <= a.feas_c && gap <= a.opt_tol;
  const double mu_floor = mu < 1e-300 ? 1e-300 : mu;   // keeps NaN
  double* L = a.lane;
  L[kMu * B + b] = mu;
  L[kPobj * B + b] = pobj;
  L[kDobj * B + b] = dobj;
  L[kGap * B + b] = gap;
  L[kPres * B + b] = pres;
  L[kDres * B + b] = dres;
  L[kRegval * B + b] = nan_min(mu, r[kMinG]);
  L[kTol * B + b] = mul_rn(a.kkt_tol, __dsqrt_rn(mu_floor));
  a.done_out[b] = (a.done_in[b] != 0 || conv) ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
prologue_weights_kernel(ProArgs a) {
  const int64_t B = a.B, n = a.n, nm = a.n + a.m;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const double rw = div_rn(1.0, a.lane[kRegval * B + b]);
  for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
       row < nm; row += (int64_t)gridDim.x * blockDim.y) {
    const int64_t i = row * B + b;
    const double g = a.W[i];
    const double w = g > 0.0 ? div_rn(1.0, g) : rw;
    a.W[i] = w;
    if (row >= n) a.resscale[i - n * B] = div_rn(1.0, __dsqrt_rn(w));
  }
}

// _mu_of alone: the two complementarity sums, then mu per lane
__global__ void __launch_bounds__(kThreads) mu_reduce_kernel(ProArgs a) {
  __shared__ double red[kThreads * 2];
  const int64_t B = a.B, nm = a.n + a.m;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  double sm[2] = {0.0, 0.0};
  if (b < B) {
    for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
         row < nm; row += (int64_t)gridDim.x * blockDim.y) {
      const int64_t i = row * B + b;
      if (a.finl[row] != 0) sm[0] += a.XL[i] * a.ZL[i];
      if (a.finu[row] != 0) sm[1] += a.XU[i] * a.ZU[i];
    }
  }
  lane_reduce<double, 2>(sm, red, AddOp());
  store_partials<double, 2>(sm, a.partials, 0, B, b, a.nblk);
}

__global__ void __launch_bounds__(kThreads) mu_lane_kernel(ProArgs a) {
  const int64_t b = warp_lane();
  if (b >= a.B) return;
  const int64_t B = a.B, nb = a.nblk;
  const double s0 = warp_partials(a.partials + b * nb, nb, 0.0, AddOp());
  const double s1 = warp_partials(a.partials + (B + b) * nb, nb, 0.0,
                                  AddOp());
  if ((threadIdx.x & 31) == 0) a.lane[b] = div_rn(add_rn(s0, s1), a.num_fin);
}

int launch_prologue(const ProArgs& a, void* stream) {
  if (a.B < 1 || a.n < 0 || a.m < 1 || !(a.num_fin >= 1.0))
    return (int)cudaErrorInvalidValue;
  const int64_t nm = a.n + a.m;
  const LaneGrid r = red_grid(nm, a.B);
  if (a.nblk != r.gx) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  prologue_reduce_kernel<<<dim3((unsigned)r.gx, (unsigned)r.gy),
                           dim3((unsigned)r.tx, (unsigned)r.ty), 0, s>>>(a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  prologue_lane_kernel<<<(unsigned)blocks_for(a.B, kWarpsPerBlock), kThreads,
                         0, s>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  const LaneGrid g = lane_grid(nm, a.B);
  prologue_weights_kernel<<<dim3((unsigned)g.gx, (unsigned)g.gy),
                            dim3((unsigned)g.tx, (unsigned)g.ty), 0, s>>>(a);
  return (int)cudaGetLastError();
}

int launch_mu(const ProArgs& a, void* stream) {
  if (a.B < 1 || !(a.num_fin >= 1.0)) return (int)cudaErrorInvalidValue;
  const LaneGrid r = red_grid(a.n + a.m, a.B);
  if (a.nblk != r.gx) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  mu_reduce_kernel<<<dim3((unsigned)r.gx, (unsigned)r.gy),
                     dim3((unsigned)r.tx, (unsigned)r.ty), 0, s>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  mu_lane_kernel<<<(unsigned)blocks_for(a.B, kWarpsPerBlock), kThreads, 0,
                   s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ipxt

#define D_(p) static_cast<const double*>(p)
#define U8_(p) static_cast<const uint8_t*>(p)

// Row blocks of a reducing pass over `rows` rows and B lanes (red_grid):
// the length of the last axis of its partials.
extern "C" int64_t ipxt_red_blocks(int64_t rows, int64_t B) {
  return ipxt::red_grid(rows, B).gx;
}

// The step's prologue (see the top of this file). Arrays are row-major with
// B columns; lb, ub, finl, finu have n + m entries, done_in and done_out B;
// partials hold 11 * B * nblk values, nblk = ipxt_red_blocks(n + m, B); lane
// gets 8 rows of B: mu, pobj, dobj, gap, pres, dres, regval, tol. num_fin is
// max(sum(finl) + sum(finu), 1).
extern "C" int ipxt_ipm_prologue_f64(
    int64_t n, int64_t m, int64_t B, const void* AX, const void* ATY,
    const void* X, const void* XL, const void* XU, const void* Y,
    const void* ZL, const void* ZU, const void* bT, const void* cT,
    const void* lb, const void* ub, const void* finl, const void* finu,
    const void* done_in, void* RB, void* RC, void* RL, void* RU, void* W,
    void* resscale, void* partials, int64_t nblk, void* lane, void* done_out,
    double feas_b, double feas_c, double opt_tol, double kkt_tol,
    double num_fin, void* stream) {
  ipxt::ProArgs a;
  a.n = n;
  a.m = m;
  a.B = B;
  a.AX = D_(AX);
  a.ATY = D_(ATY);
  a.X = D_(X);
  a.XL = D_(XL);
  a.XU = D_(XU);
  a.Y = D_(Y);
  a.ZL = D_(ZL);
  a.ZU = D_(ZU);
  a.bT = D_(bT);
  a.cT = D_(cT);
  a.lb = D_(lb);
  a.ub = D_(ub);
  a.finl = U8_(finl);
  a.finu = U8_(finu);
  a.done_in = U8_(done_in);
  a.RB = static_cast<double*>(RB);
  a.RC = static_cast<double*>(RC);
  a.RL = static_cast<double*>(RL);
  a.RU = static_cast<double*>(RU);
  a.W = static_cast<double*>(W);
  a.resscale = static_cast<double*>(resscale);
  a.partials = static_cast<double*>(partials);
  a.nblk = nblk;
  a.lane = static_cast<double*>(lane);
  a.done_out = static_cast<uint8_t*>(done_out);
  a.feas_b = feas_b;
  a.feas_c = feas_c;
  a.opt_tol = opt_tol;
  a.kkt_tol = kkt_tol;
  a.num_fin = num_fin;
  return ipxt::launch_prologue(a, stream);
}

// out[b] = (sum over finl rows of XL ZL + sum over finu rows of XU ZU) /
// num_fin, for (nm, B) arrays; partials hold 2 * B * nblk values, nblk =
// ipxt_red_blocks(nm, B).
extern "C" int ipxt_lane_mu_f64(int64_t nm, int64_t B, const void* XL,
                                const void* XU, const void* ZL,
                                const void* ZU, const void* finl,
                                const void* finu, void* partials,
                                int64_t nblk, void* out, double num_fin,
                                void* stream) {
  ipxt::ProArgs a = {};
  a.n = 0;
  a.m = nm;
  a.B = B;
  a.XL = D_(XL);
  a.XU = D_(XU);
  a.ZL = D_(ZL);
  a.ZU = D_(ZU);
  a.finl = U8_(finl);
  a.finu = U8_(finu);
  a.partials = static_cast<double*>(partials);
  a.nblk = nblk;
  a.lane = static_cast<double*>(out);
  a.num_fin = num_fin;
  return ipxt::launch_mu(a, stream);
}
