// K13 starting_point: the masked passes of the batched starting point
// around its two CR solves, for Hopper (sm_90a), in float64.
//
// Replaces: ipx_tpu/parallel/batch.py _starting_point (331-400) from the
// primal update X = X + AI'DY on: xinfeas and xshift, the dual Z = c - AI'Y
// and its cnorm / znorm fix-up, the ZL / ZU split and zshift, the xsum /
// zsum / mu centring and the INF masking. XLA runs them as elementwise
// passes and eight column reductions over (n + m, B) f64 arrays.
//
// What bounds it on the H100: memory, once per solve. The inputs are four
// (n + m, B) arrays (X0, A'DY | DY, c, A'Y | Y) and the outputs six; read
// and written once each, that is 0.65 ms at n + m = 116 002, B = 256 and
// 3.35 TB/s.
//
// Design: the column reductions depend on each other (xsum needs xshift,
// zinfeas the fix-up, zsum and mu zshift), so K13 is three reducing stages,
// each finished by a warp a lane that reduces its partials in a fixed order
// (as K10, common.cuh), and one elementwise stage:
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
//
// Two forms, bit for bit the same outputs and lane scalars:
//  - one cooperative launch (start_coop_kernel, what kernels.starting_point
//    runs): the stages run in one grid with a grid barrier after each and
//    after each lane finish. Stage 1 reads the four inputs and writes X,
//    which is final there, and Z into ZL's buffer; stages 2 and 3 read X
//    and Z only (c on fix-up lanes) and write nothing but their partials,
//    redoing the adds of the stages before them with the same add_rn /
//    mul_rn sequence and lane scalars; stage 4 writes XL, XU, ZL, ZU and Y
//    once each (Y from the rows of Yin it reads). That is about 10.2 array
//    reads and 6.2 writes, 3.9 GB, where the seven launches read and write
//    about 31 arrays (7.4 GB); recomputing X and Z from the four inputs in
//    every stage (21 arrays) took 1.82 ms against this form's 1.57 ms
//    (PERF.md §6). The grid walks red_grid's virtual blocks, so
//    every partial slot and every order of summation is the seven launches'
//    own; two lanes a thread with 16-byte loads where B is even and the
//    arrays aligned.
//  - seven launches (start_reduce1-3, each writing the iterate the next one
//    reads back, start_lane<1-3>, start_final): the earlier form, kept to
//    hold the one launch against (kernels.starting_point(...,
//    cooperative=False)).

#include <cooperative_groups.h>

#include <initializer_list>

#include "common.cuh"

namespace ipxt {
namespace {

namespace cg = cooperative_groups;

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

// the thread's lane in its warp, in a block of one or two dimensions
__device__ __forceinline__ int lane_id() {
  return (threadIdx.y * blockDim.x + threadIdx.x) & 31;
}

// warp_partials over the nblk partials of one lane, through L2 (__ldcg):
// the one-launch form reads partials that other blocks wrote earlier in
// the same launch, which the read-only and L1 caches may not hold
template <typename Op>
__device__ double lane_partials_l2(const double* p, int64_t nblk,
                                   double init, Op op) {
  double s = init;
  for (int64_t k = lane_id(); k < nblk; k += 32)
    s = op(s, __ldcg(p + k));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = op(s, __shfl_down_sync(0xffffffffu, s, off));
  return s;
}

// Lane b's scalars of stage kStage from the partials, by one whole warp;
// its thread 0 writes them to a.lane.
template <int kStage>
__device__ void lane_finish(const StartArgs& a, int64_t b) {
  const int64_t B = a.B, nb = a.nblk;
  double r[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const double* p = a.partials + ((int64_t)q * B + b) * nb;
    if (kStage < 3 && q < 2)
      r[q] = lane_partials_l2(p, nb, (double)-INFINITY, MaxOp());
    else
      r[q] = lane_partials_l2(p, nb, 0.0, AddOp());
  }
  if (lane_id() != 0) return;
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
    L[kHz * B + b] = div_rn(mul_rn(0.5, mu), __ldcg(L + kXsum * B + b));
  }
}

template <int kStage>
__global__ void __launch_bounds__(kThreads) start_lane(StartArgs a) {
  const int64_t b = warp_lane();
  if (b >= a.B) return;   // the whole warp: it serves one lane
  lane_finish<kStage>(a, b);
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

// -- the one-launch form -------------------------------------------------------
//
// VW values of p from i on: one 16-byte load where VW = 2
template <int VW>
__device__ __forceinline__ void load2(const double* __restrict__ p,
                                      double (&v)[VW]) {
  if constexpr (VW == 1) {
    v[0] = __ldg(p);
  } else {
    const double2 d = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = d.x;
    v[1] = d.y;
  }
}

template <int VW>
__device__ __forceinline__ void store2(double* p, const double (&v)[VW]) {
  if constexpr (VW == 1)
    __stcs(p, v[0]);
  else
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

// Stage kStage (1-3: a reducing pass, 4: the writing pass) over the rows of
// virtual block (vbx, vby) of the reducing passes' grid (red_grid: the same
// rows, lanes and order of rows as start_reduce1-3, so the same partial
// slots), each thread taking VW adjacent lanes. Stage 1 reads the four
// inputs and writes X (final) and Z = c - AI'Y (into ZL); the later stages
// read X and Z back (and c on fix-up lanes, Yin's rows in stage 4) and
// redo the operations of start_reduce2-3 and start_final on them, in their
// order, with the lane scalars of the stages before; stage 4 writes XL, XU,
// ZL, ZU and Y. Each element is read and written by the same thread in
// every stage.
template <int VW>
__device__ __forceinline__ void ldcg2(const double* p, double (&v)[VW]) {
  if constexpr (VW == 1) {
    v[0] = __ldcg(p);
  } else {
    const double2 d = __ldcg(reinterpret_cast<const double2*>(p));
    v[0] = d.x;
    v[1] = d.y;
  }
}

template <int VW>
__device__ __forceinline__ void stcg2(double* p, const double (&v)[VW]) {
  if constexpr (VW == 1)
    __stcg(p, v[0]);
  else
    __stcg(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

template <int kStage, int VW>
__device__ void start_stage(const StartArgs& a, int64_t vbx, int64_t vby,
                            int64_t gx, double* red) {
  constexpr int Q = kStage == 3 ? 4 : 2;  // sums (and, in 1-2, Q maxima)
  const int64_t B = a.B, n = a.n, nm = a.n + a.m;
  const int64_t b0 = (vby * blockDim.x + threadIdx.x) * VW;
  const bool ok = b0 < B;  // VW = 2 only where B is even
  double mx[2 * VW], sm[Q * VW];
#pragma unroll
  for (int k = 0; k < 2 * VW; ++k) mx[k] = -INFINITY;
#pragma unroll
  for (int k = 0; k < Q * VW; ++k) sm[k] = 0.0;
  double xshift[VW], zshift[VW], hx[VW], hz[VW];
  bool fix[VW];
  if (ok && kStage > 1) {
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      xshift[j] = __ldcg(a.lane + kXshift * B + b0 + j);
      fix[j] = __ldcg(a.lane + kFixup * B + b0 + j) != 0.0;
      if (kStage > 2) zshift[j] = __ldcg(a.lane + kZshift * B + b0 + j);
      if (kStage > 3) {
        hx[j] = __ldcg(a.lane + kHx * B + b0 + j);
        hz[j] = __ldcg(a.lane + kHz * B + b0 + j);
      }
    }
  }
  if (ok) {
    for (int64_t row = vbx * blockDim.y + threadIdx.y; row < nm;
         row += gx * blockDim.y) {
      const int64_t i = row * B + b0;
      const bool fl = a.finl[row] != 0, fu = a.finu[row] != 0;
      const double lbv = a.lb[row], ubv = a.ub[row];
      double xv[VW], zv[VW], c[VW], y[VW];
      if constexpr (kStage > 1) {
        // X and Z as stage 1 stored them (Z in ZL), c on fix-up lanes
        ldcg2<VW>(a.X + i, xv);
        ldcg2<VW>(a.ZL + i, zv);
        bool any_fix = false;
#pragma unroll
        for (int j = 0; j < VW; ++j) any_fix = any_fix || fix[j];
        if (any_fix) load2<VW>(a.cT + i, c);
        if (kStage == 4 && row >= n) load2<VW>(a.Yin + (i - n * B), y);
      } else {
        double x0[VW], d[VW];
        load2<VW>(a.X0 + i, x0);
        load2<VW>(row < n ? a.ATDY + i : a.DY + (i - n * B), d);
        load2<VW>(a.cT + i, c);
        load2<VW>(row < n ? a.ATY + i : a.Yin + (i - n * B), y);
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          xv[j] = add_rn(x0[j], d[j]);
          zv[j] = add_rn(c[j], -y[j]);
        }
        stcg2<VW>(a.X + i, xv);   // X is final; Z is kept in ZL
        stcg2<VW>(a.ZL + i, zv);
      }
      double oxl[VW], oxu[VW], ozl[VW], ozu[VW], oy[VW];
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        // stage 1 (start_reduce1)
        const double x = xv[j];
        double xl = add_rn(x, -lbv), xu = add_rn(ubv, -x);
        double z = zv[j];
        if constexpr (kStage == 1) {
          mx[j] = nan_max(mx[j], fl ? -xl : 0.0);
          mx[VW + j] = nan_max(mx[VW + j], fu ? -xu : 0.0);
          sm[j] += c[j] * c[j];
          sm[VW + j] += z * z;
          continue;
        }
        // stage 2 (start_reduce2)
        xl = add_rn(xl, xshift[j]);
        xu = add_rn(xu, xshift[j]);
        if (fix[j]) z = add_rn(z, mul_rn(a.rho, c[j]));
        double zl, zu;
        if (fl && fu) {
          zl = mul_rn(0.5, z);
          zu = -mul_rn(0.5, z);
        } else {
          zl = fl ? z : 0.0;
          zu = fu ? -z : 0.0;
        }
        if constexpr (kStage == 2) {
          mx[j] = nan_max(mx[j], fl ? -zl : 0.0);
          mx[VW + j] = nan_max(mx[VW + j], fu ? -zu : 0.0);
          if (fl) sm[j] += xl;
          if (fu) sm[VW + j] += xu;
          continue;
        }
        // stage 3 (start_reduce3)
        zl = fl ? add_rn(zl, zshift[j]) : 0.0;
        zu = fu ? add_rn(zu, zshift[j]) : 0.0;
        if constexpr (kStage == 3) {
          if (fl) {
            sm[j] += zl;
            sm[2 * VW + j] += xl * zl;
          }
          if (fu) {
            sm[VW + j] += zu;
            sm[3 * VW + j] += xu * zu;
          }
          continue;
        }
        // the writing pass (start_final)
        oxl[j] = fl ? add_rn(xl, hx[j]) : INFINITY;
        oxu[j] = fu ? add_rn(xu, hx[j]) : INFINITY;
        ozl[j] = fl ? add_rn(zl, hz[j]) : 0.0;
        ozu[j] = fu ? add_rn(zu, hz[j]) : 0.0;
        oy[j] = fix[j] ? mul_rn(a.one_minus_rho, y[j]) : y[j];
      }
      if constexpr (kStage == 4) {
        store2<VW>(a.XL + i, oxl);
        store2<VW>(a.XU + i, oxu);
        store2<VW>(a.ZL + i, ozl);
        store2<VW>(a.ZU + i, ozu);
        if (row >= n) store2<VW>(a.Y + (i - n * B), oy);
      }
    }
  }
  if constexpr (kStage < 4) {
    if constexpr (kStage < 3) lane_reduce<double, 2 * VW>(mx, red, MaxOp());
    lane_reduce<double, Q * VW>(sm, red, AddOp());
    if (threadIdx.y == 0 && ok) {
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        double* p = a.partials + (b0 + j) * a.nblk + vbx;
        if constexpr (kStage < 3) {
          p[0] = mx[j];
          p[B * a.nblk] = mx[VW + j];
        }
#pragma unroll
        for (int q = 0; q < Q; ++q)
          p[((kStage < 3 ? 2 : 0) + q) * B * a.nblk] = sm[q * VW + j];
      }
    }
  }
}

// every stage's virtual blocks, grid-stride, then a grid barrier; after a
// reducing stage, the lanes' scalars (a warp a lane) and another barrier
template <int kStage, int VW>
__device__ __forceinline__ void coop_stage(const StartArgs& a,
                                           cg::grid_group& grid, int64_t gx,
                                           int64_t nvb, double* red) {
  for (int64_t vb = blockIdx.x; vb < nvb; vb += gridDim.x)
    start_stage<kStage, VW>(a, vb % gx, vb / gx, gx, red);
  if constexpr (kStage < 4) {
    grid.sync();
    // whole warps only: a block of 2D shape may end in a partial one
    const int wpb = (blockDim.x * blockDim.y) >> 5;
    const int w = (threadIdx.y * blockDim.x + threadIdx.x) >> 5;
    if (w < wpb)
      for (int64_t b = blockIdx.x * (int64_t)wpb + w; b < a.B;
           b += (int64_t)gridDim.x * wpb)
        lane_finish<kStage>(a, b);
    grid.sync();
  }
}

template <int VW>
__global__ void __launch_bounds__(kThreads) start_coop_kernel(StartArgs a,
                                                              int64_t gx,
                                                              int64_t nvb) {
  __shared__ double red[kThreads * 4];
  cg::grid_group grid = cg::this_grid();
  coop_stage<1, VW>(a, grid, gx, nvb, red);
  coop_stage<2, VW>(a, grid, gx, nvb, red);
  coop_stage<3, VW>(a, grid, gx, nvb, red);
  coop_stage<4, VW>(a, grid, gx, nvb, red);
}

int launch_coop(const StartArgs& a, bool vec2, void* stream) {
  const int64_t nm = a.n + a.m;
  const LaneGrid r = red_grid(nm, a.B);
  const int vw = vec2 ? 2 : 1;
  const int64_t nvb = r.gx * r.gy;
  int64_t cap = 0;
  const int err = vec2 ? coop_capacity<start_coop_kernel<2>>(&cap, kThreads / 2)
                       : coop_capacity<start_coop_kernel<1>>(&cap);
  if (err != 0) return err;
  int64_t grid = nvb < cap ? nvb : cap;
  grid = blocks_for(nvb, blocks_for(nvb, grid));  // even virtual blocks a block
  int64_t gx = r.gx;
  void* args[] = {const_cast<StartArgs*>(&a), &gx, const_cast<int64_t*>(&nvb)};
  const dim3 block((unsigned)(r.tx / vw), (unsigned)r.ty);
  const void* kernel = vec2 ? (const void*)start_coop_kernel<2>
                            : (const void*)start_coop_kernel<1>;
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      kernel, dim3((unsigned)grid), block, args, 0,
      static_cast<cudaStream_t>(stream));
  // read and clear the last error too, so that a refusal is reported here
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
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

namespace {

ipxt::StartArgs start_args(int64_t n, int64_t m, int64_t B, const void* X0,
                           const void* ATDY, const void* DY, const void* ATY,
                           const void* Yin, const void* cT, const void* lb,
                           const void* ub, const void* finl, const void* finu,
                           void* X, void* XL, void* XU, void* Y, void* ZL,
                           void* ZU, void* partials, int64_t nblk, void* lane,
                           double rho, double one_minus_rho) {
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
  return a;
}

}  // namespace

// The starting point's passes from X0 (the clamped zero point), the two K5
// products ATDY = A' DY and ATY = A' Y and the two CR solutions DY and Yin;
// arrays row-major with B columns; partials hold 4 * B * nblk values, nblk =
// ipxt_red_blocks(n + m, B); lane gets 8 rows of B: xshift, fixup (1 or 0),
// zshift, xsum, zsum, mu, 0.5 mu / zsum, 0.5 mu / xsum. Seven launches: the
// three reducing passes, each writing the iterate the next reads back and
// followed by its lanes' launch, and the last elementwise pass (kept to
// hold the one-launch form against).
extern "C" int ipxt_starting_point_f64(
    int64_t n, int64_t m, int64_t B, const void* X0, const void* ATDY,
    const void* DY, const void* ATY, const void* Yin, const void* cT,
    const void* lb, const void* ub, const void* finl, const void* finu,
    void* X, void* XL, void* XU, void* Y, void* ZL, void* ZU, void* partials,
    int64_t nblk, void* lane, double rho, double one_minus_rho,
    void* stream) {
  return ipxt::launch_start(
      start_args(n, m, B, X0, ATDY, DY, ATY, Yin, cT, lb, ub, finl, finu, X,
                 XL, XU, Y, ZL, ZU, partials, nblk, lane, rho, one_minus_rho),
      stream);
}

// The same outputs and lane scalars, bit for bit, in one cooperative launch
// (start_coop_kernel) that writes the iterate once; two lanes a thread with
// 16-byte loads where B is even and every (rows, B) array 16-byte aligned.
extern "C" int ipxt_starting_point_coop_f64(
    int64_t n, int64_t m, int64_t B, const void* X0, const void* ATDY,
    const void* DY, const void* ATY, const void* Yin, const void* cT,
    const void* lb, const void* ub, const void* finl, const void* finu,
    void* X, void* XL, void* XU, void* Y, void* ZL, void* ZU, void* partials,
    int64_t nblk, void* lane, double rho, double one_minus_rho,
    void* stream) {
  if (B < 1 || n < 0 || m < 1 || nblk != ipxt::red_grid(n + m, B).gx)
    return (int)cudaErrorInvalidValue;
  bool vec2 = B % 2 == 0;
  for (const void* p : {X0, ATDY, DY, ATY, Yin, cT, (const void*)X,
                        (const void*)XL, (const void*)XU, (const void*)Y,
                        (const void*)ZL, (const void*)ZU})
    vec2 = vec2 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  const ipxt::StartArgs a =
      start_args(n, m, B, X0, ATDY, DY, ATY, Yin, cT, lb, ub, finl, finu, X,
                 XL, XU, Y, ZL, ZU, partials, nblk, lane, rho, one_minus_rho);
  return ipxt::launch_coop(a, vec2, stream);
}
