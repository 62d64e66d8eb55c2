// K13 starting_point: the masked passes of the batched starting point
// around its two CR solves, for Hopper (sm_90a), in float64.
//
// Replaces: ipx_tpu/parallel/batch.py _starting_point (331-400) from the
// primal update X = X + AI'DY on: xinfeas and xshift, the dual Z = c - AI'Y
// and its cnorm / znorm fix-up, the ZL / ZU split and zshift, the xsum /
// zsum / mu centring and the INF masking. XLA runs them as elementwise
// passes and eight column reductions over (n + m, B) f64 arrays.
//
// What bounds it on the H100: memory, once per solve. Four passes over the
// (n + m, B) iterate: about 14 arrays of 238 MB read and 10 written at
// n + m = 116 002, B = 256, about 1.7 ms at 3.35 TB/s.
//
// Design: the column reductions depend on each other (xsum needs xshift,
// zinfeas the fix-up, zsum and mu zshift), so K13 is three reducing passes,
// each followed by a finishing launch that gives every lane a warp (as K10,
// common.cuh), and one elementwise pass:
//  1. X = X0 + AI'DY, XL = X - lb, XU = ub - X, Z = c - AI'Y (kept in ZL);
//     max of -XL (finl) and -XU (finu), sums of c^2 and Z^2.
//     Lane: xshift = 1 + 1.5 max(xinfeas, 0); fixup = |Z| < rho |c|.
//  2. XL += xshift, XU += xshift; Z += rho c on fixup lanes; ZL / ZU split;
//     max of -ZL (finl) and -ZU (finu), sums of XL (finl) and XU (finu).
//     Lane: zshift, xsum.
//  3. ZL = finl ? ZL + zshift : 0, ZU likewise; sums of ZL, ZU, XL ZL and
//     XU ZU. Lane: zsum, mu, hx = 0.5 mu / zsum, hz = 0.5 mu / xsum.
//  4. XL = finl ? XL + hx : INF, XU likewise, ZL = finl ? ZL + hz : 0, ZU
//     likewise, Y = (1 - rho) Y on fixup lanes.
// No atomics. The elementwise results are rounded op by op as the reference
// writes them (add_rn / mul_rn / div_rn, no FMA), so given the same per-lane
// scalars they equal the plain version bit for bit; the maxima are exact and
// the sums differ from torch.sum by their order of rounding.

#include "common.cuh"

namespace ipxt {
namespace {

// rows of the (kStartLen, B) per-lane output
enum StartRow { kXshift = 0, kFixup, kZshift, kXsum, kZsum, kMuS, kHx, kHz,
                kStartLen };

struct StartArgs {
  int64_t n, m, B;
  const double* X0;    // (n + m, B)
  const double* ATDY;  // (n, B)  A' DY of the primal solve
  const double* DY;    // (m, B)
  const double* ATY;   // (n, B)  A' Y of the dual solve
  const double* Yin;   // (m, B)
  const double* cT;    // (n + m, B)
  const double* lb;    // (n + m,)
  const double* ub;
  const uint8_t* finl;
  const uint8_t* finu;
  double* X;
  double* XL;
  double* XU;
  double* Y;           // (m, B)
  double* ZL;
  double* ZU;
  double* partials;    // (4, B, nblk)
  int64_t nblk;
  double* lane;        // (kStartLen, B)
  double rho, one_minus_rho;
};

// stage 1 of the reduction chain: see the top of the file
__global__ void __launch_bounds__(kThreads) start_reduce1(StartArgs a) {
  __shared__ double red[kThreads * 2];
  const int64_t B = a.B, n = a.n, nm = a.n + a.m;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  double mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.0, 0.0};
  if (b < B) {
    for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
         row < nm; row += (int64_t)gridDim.x * blockDim.y) {
      const int64_t i = row * B + b;
      const bool fl = a.finl[row] != 0, fu = a.finu[row] != 0;
      const double x = add_rn(a.X0[i], row < n ? a.ATDY[i] : a.DY[i - n * B]);
      const double xl = add_rn(x, -a.lb[row]), xu = add_rn(a.ub[row], -x);
      a.X[i] = x;
      a.XL[i] = xl;
      a.XU[i] = xu;
      mx[0] = nan_max(mx[0], fl ? -xl : 0.0);
      mx[1] = nan_max(mx[1], fu ? -xu : 0.0);
      const double c = a.cT[i];
      const double z = add_rn(c, -(row < n ? a.ATY[i] : a.Yin[i - n * B]));
      a.ZL[i] = z;
      sm[0] += c * c;
      sm[1] += z * z;
    }
  }
  lane_reduce<double, 2>(mx, red, MaxOp());
  lane_reduce<double, 2>(sm, red, AddOp());
  store_partials<double, 2>(mx, a.partials, 0, B, b, a.nblk);
  store_partials<double, 2>(sm, a.partials, 2, B, b, a.nblk);
}

__global__ void __launch_bounds__(kThreads) start_reduce2(StartArgs a) {
  __shared__ double red[kThreads * 2];
  const int64_t B = a.B, nm = a.n + a.m;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  double mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.0, 0.0};
  if (b < B) {
    const double xshift = a.lane[kXshift * B + b];
    const bool fix = a.lane[kFixup * B + b] != 0.0;
    for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
         row < nm; row += (int64_t)gridDim.x * blockDim.y) {
      const int64_t i = row * B + b;
      const bool fl = a.finl[row] != 0, fu = a.finu[row] != 0;
      const double xl = add_rn(a.XL[i], xshift), xu = add_rn(a.XU[i], xshift);
      a.XL[i] = xl;
      a.XU[i] = xu;
      double z = a.ZL[i];
      if (fix) z = add_rn(z, mul_rn(a.rho, a.cT[i]));
      double zl, zu;
      if (fl && fu) {
        zl = mul_rn(0.5, z);
        zu = -mul_rn(0.5, z);
      } else {
        zl = fl ? z : 0.0;
        zu = fu ? -z : 0.0;
      }
      a.ZL[i] = zl;
      a.ZU[i] = zu;
      mx[0] = nan_max(mx[0], fl ? -zl : 0.0);
      mx[1] = nan_max(mx[1], fu ? -zu : 0.0);
      if (fl) sm[0] += xl;
      if (fu) sm[1] += xu;
    }
  }
  lane_reduce<double, 2>(mx, red, MaxOp());
  lane_reduce<double, 2>(sm, red, AddOp());
  store_partials<double, 2>(mx, a.partials, 0, B, b, a.nblk);
  store_partials<double, 2>(sm, a.partials, 2, B, b, a.nblk);
}

__global__ void __launch_bounds__(kThreads) start_reduce3(StartArgs a) {
  __shared__ double red[kThreads * 4];
  const int64_t B = a.B, nm = a.n + a.m;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  double sm[4] = {0.0, 0.0, 0.0, 0.0};
  if (b < B) {
    const double zshift = a.lane[kZshift * B + b];
    for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
         row < nm; row += (int64_t)gridDim.x * blockDim.y) {
      const int64_t i = row * B + b;
      const bool fl = a.finl[row] != 0, fu = a.finu[row] != 0;
      const double zl = fl ? add_rn(a.ZL[i], zshift) : 0.0;
      const double zu = fu ? add_rn(a.ZU[i], zshift) : 0.0;
      a.ZL[i] = zl;
      a.ZU[i] = zu;
      if (fl) {
        sm[0] += zl;
        sm[2] += a.XL[i] * zl;
      }
      if (fu) {
        sm[1] += zu;
        sm[3] += a.XU[i] * zu;
      }
    }
  }
  lane_reduce<double, 4>(sm, red, AddOp());
  store_partials<double, 4>(sm, a.partials, 0, B, b, a.nblk);
}

// 1 + 1.5 max(v, 0), keeping NaN as torch.clamp does
__device__ __forceinline__ double shift_of(double v) {
  return add_rn(1.0, mul_rn(1.5, v < 0.0 ? 0.0 : v));
}

template <int kStage>
__global__ void __launch_bounds__(kThreads) start_lane(StartArgs a) {
  const int64_t b = warp_lane();
  if (b >= a.B) return;   // the whole warp: it serves one lane
  const int64_t B = a.B, nb = a.nblk;
  double r[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const double* p = a.partials + ((int64_t)q * B + b) * nb;
    if (kStage < 3 && q < 2)
      r[q] = warp_partials(p, nb, (double)-INFINITY, MaxOp());
    else
      r[q] = warp_partials(p, nb, 0.0, AddOp());
  }
  if ((threadIdx.x & 31) != 0) return;
  double* L = a.lane;
  if (kStage == 1) {
    L[kXshift * B + b] = shift_of(nan_max(r[0], r[1]));
    const double cnorm = __dsqrt_rn(r[2]), znorm = __dsqrt_rn(r[3]);
    L[kFixup * B + b] = znorm < mul_rn(a.rho, cnorm) ? 1.0 : 0.0;
  } else if (kStage == 2) {
    L[kZshift * B + b] = shift_of(nan_max(r[0], r[1]));
    L[kXsum * B + b] = add_rn(add_rn(1.0, r[2]), r[3]);
  } else {
    const double zsum = add_rn(add_rn(1.0, r[0]), r[1]);
    const double mu = add_rn(add_rn(1.0, r[2]), r[3]);
    L[kZsum * B + b] = zsum;
    L[kMuS * B + b] = mu;
    L[kHx * B + b] = div_rn(mul_rn(0.5, mu), zsum);
    L[kHz * B + b] = div_rn(mul_rn(0.5, mu), L[kXsum * B + b]);
  }
}

__global__ void __launch_bounds__(kThreads) start_final(StartArgs a) {
  const int64_t B = a.B, m = a.m, nm = a.n + a.m;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const double hx = a.lane[kHx * B + b], hz = a.lane[kHz * B + b];
  const bool fix = a.lane[kFixup * B + b] != 0.0;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
       row < nm; row += (int64_t)gridDim.x * blockDim.y) {
    const int64_t i = row * B + b;
    const bool fl = a.finl[row] != 0, fu = a.finu[row] != 0;
    a.XL[i] = fl ? add_rn(a.XL[i], hx) : INFINITY;
    a.XU[i] = fu ? add_rn(a.XU[i], hx) : INFINITY;
    a.ZL[i] = fl ? add_rn(a.ZL[i], hz) : 0.0;
    a.ZU[i] = fu ? add_rn(a.ZU[i], hz) : 0.0;
    if (row < m) a.Y[i] = fix ? mul_rn(a.one_minus_rho, a.Yin[i]) : a.Yin[i];
  }
}

int launch_start(const StartArgs& a, void* stream) {
  if (a.B < 1 || a.n < 0 || a.m < 1) return (int)cudaErrorInvalidValue;
  const int64_t nm = a.n + a.m;
  const LaneGrid r = red_grid(nm, a.B);
  if (a.nblk != r.gx) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 rg((unsigned)r.gx, (unsigned)r.gy), rb((unsigned)r.tx,
                                                    (unsigned)r.ty);
  const unsigned lg = (unsigned)blocks_for(a.B, kWarpsPerBlock);
  int err;
#define IPXT_LAUNCH(...)             \
  __VA_ARGS__;                       \
  err = (int)cudaGetLastError();     \
  if (err) return err;
  IPXT_LAUNCH(start_reduce1<<<rg, rb, 0, s>>>(a))
  IPXT_LAUNCH(start_lane<1><<<lg, kThreads, 0, s>>>(a))
  IPXT_LAUNCH(start_reduce2<<<rg, rb, 0, s>>>(a))
  IPXT_LAUNCH(start_lane<2><<<lg, kThreads, 0, s>>>(a))
  IPXT_LAUNCH(start_reduce3<<<rg, rb, 0, s>>>(a))
  IPXT_LAUNCH(start_lane<3><<<lg, kThreads, 0, s>>>(a))
#undef IPXT_LAUNCH
  const LaneGrid g = lane_grid(nm, a.B);
  start_final<<<dim3((unsigned)g.gx, (unsigned)g.gy),
                dim3((unsigned)g.tx, (unsigned)g.ty), 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ipxt

// The starting point's passes from X0 (the clamped zero point), the two K5
// products ATDY = A' DY and ATY = A' Y and the two CR solutions DY and Yin;
// arrays row-major with B columns; partials hold 4 * B * nblk values, nblk =
// ipxt_red_blocks(n + m, B); lane gets 8 rows of B: xshift, fixup (1 or 0),
// zshift, xsum, zsum, mu, 0.5 mu / zsum, 0.5 mu / xsum.
extern "C" int ipxt_starting_point_f64(
    int64_t n, int64_t m, int64_t B, const void* X0, const void* ATDY,
    const void* DY, const void* ATY, const void* Yin, const void* cT,
    const void* lb, const void* ub, const void* finl, const void* finu,
    void* X, void* XL, void* XU, void* Y, void* ZL, void* ZU, void* partials,
    int64_t nblk, void* lane, double rho, double one_minus_rho,
    void* stream) {
  ipxt::StartArgs a;
  a.n = n;
  a.m = m;
  a.B = B;
  a.X0 = static_cast<const double*>(X0);
  a.ATDY = static_cast<const double*>(ATDY);
  a.DY = static_cast<const double*>(DY);
  a.ATY = static_cast<const double*>(ATY);
  a.Yin = static_cast<const double*>(Yin);
  a.cT = static_cast<const double*>(cT);
  a.lb = static_cast<const double*>(lb);
  a.ub = static_cast<const double*>(ub);
  a.finl = static_cast<const uint8_t*>(finl);
  a.finu = static_cast<const uint8_t*>(finu);
  a.X = static_cast<double*>(X);
  a.XL = static_cast<double*>(XL);
  a.XU = static_cast<double*>(XU);
  a.Y = static_cast<double*>(Y);
  a.ZL = static_cast<double*>(ZL);
  a.ZU = static_cast<double*>(ZU);
  a.partials = static_cast<double*>(partials);
  a.nblk = nblk;
  a.lane = static_cast<double*>(lane);
  a.rho = rho;
  a.one_minus_rho = one_minus_rho;
  return ipxt::launch_start(a, stream);
}
