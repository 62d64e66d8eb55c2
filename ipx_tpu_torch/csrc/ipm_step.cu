// K8 step_batch and K9 ipm_update: the per-lane step sizes and the masked
// iterate update of one batched IPM step, for Hopper (sm_90a).
//
// Replaces: ipx_tpu/parallel/batch.py _step_batch with the maxp / maxd
// minima of _ipm_step (506-509, 525-528), the muaff column sum (511-515),
// and the masked update of X, XL, XU, Y, ZL, ZU with BARRIER_MIN (529-548).
// XLA fuses each of those into elementwise passes and column reductions
// over (n + m, B) f64 arrays.
//
// What bounds it on the H100: memory. K8 reads eight (n + m, B) arrays for
// two minima per lane (237 MB at n + m = 116 002, B = 256, f64), and muaff
// the same eight; K9 reads and writes its six iterate arrays once. Each is
// one streaming pass with a few flops per value.
//
// Design: the 2-D layout of common.cuh (threads across lanes, blocks
// striding over rows), per-block per-lane minima or sums, and a one-block
// pass that combines them per lane in a fixed order. A column minimum is
// exact whatever the order, so K8's maxp and maxd equal their plain version
// bit for bit; the ratio -(X damp) / DX is rounded as PyTorch rounds it,
// and taken only where the mask keeps it, so an infinite XL or XU (an
// infinite bound) never meets a zero. K9 is elementwise; its products and
// sums are rounded on their own (mul_rn / add_rn, no FMA), so it too is
// exact against the plain version. The maximum with BARRIER_MIN keeps NaN,
// as jnp.maximum and torch.maximum do.

#include "common.cuh"

namespace ipxt {
namespace {

template <typename T>
struct StepArgs {
  int64_t nm, B;
  const T* XL;
  const T* XU;
  const T* ZL;
  const T* ZU;
  const T* DXL;
  const T* DXU;
  const T* DZL;
  const T* DZU;
  const uint8_t* finl;  // (nm,) 0 or 1
  const uint8_t* finu;
  T* partials;          // (2, npb, B)
  int64_t npb;
  T* maxp;              // (B,)
  T* maxd;
  T num_fin;            // sum(finl) + sum(finu), for muaff
  T* muaff;             // (B,)
};

// the candidate of one entry in the ratio test of _step_batch
template <typename T>
__device__ __forceinline__ T ratio(T x, T dx, bool fin) {
  const T damp = T(1.0 - 2.220446049250313e-16);  // 1 - eps of float64
  if (fin && dx < T(0) && isfinite(x)) return div_rn(-mul_rn(x, damp), dx);
  return T(INFINITY);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) step_min_kernel(StepArgs<T> a) {
  __shared__ T red[kThreads];
  const int64_t B = a.B;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  const bool lane_ok = b < B;
  T mp[1] = {T(INFINITY)}, md[1] = {T(INFINITY)};
  if (lane_ok) {
    for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
         row < a.nm; row += (int64_t)gridDim.x * blockDim.y) {
      const int64_t i = row * B + b;
      const bool fl = a.finl[row] != 0, fu = a.finu[row] != 0;
      mp[0] = MinOp()(mp[0], ratio(a.XL[i], a.DXL[i], fl));
      mp[0] = MinOp()(mp[0], ratio(a.XU[i], a.DXU[i], fu));
      md[0] = MinOp()(md[0], ratio(a.ZL[i], a.DZL[i], fl));
      md[0] = MinOp()(md[0], ratio(a.ZU[i], a.DZU[i], fu));
    }
  }
  lane_reduce<T, 1>(mp, red, MinOp());
  lane_reduce<T, 1>(md, red, MinOp());
  if (threadIdx.y == 0 && lane_ok) {
    a.partials[(int64_t)blockIdx.x * B + b] = mp[0];
    a.partials[(a.npb + blockIdx.x) * B + b] = md[0];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) step_lane_kernel(StepArgs<T> a) {
  for (int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x; b < a.B;
       b += (int64_t)gridDim.x * kThreads) {
    const T p = lane_partials(a.partials, a.npb, a.B, b, T(1), MinOp());
    const T d = lane_partials(a.partials + a.npb * a.B, a.npb, a.B, b, T(1),
                              MinOp());
    a.maxp[b] = p;
    a.maxd[b] = d;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) muaff_sum_kernel(StepArgs<T> a) {
  __shared__ T red[kThreads];
  const int64_t B = a.B;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  const bool lane_ok = b < B;
  T s[1] = {T(0)};
  if (lane_ok) {
    const T p = a.maxp[b], d = a.maxd[b];
    for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
         row < a.nm; row += (int64_t)gridDim.x * blockDim.y) {
      const int64_t i = row * B + b;
      if (a.finl[row] != 0)
        s[0] += (a.XL[i] + p * a.DXL[i]) * (a.ZL[i] + d * a.DZL[i]);
      if (a.finu[row] != 0)
        s[0] += (a.XU[i] + p * a.DXU[i]) * (a.ZU[i] + d * a.DZU[i]);
    }
  }
  lane_reduce<T, 1>(s, red, AddOp());
  if (threadIdx.y == 0 && lane_ok) a.partials[(int64_t)blockIdx.x * B + b] = s[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) muaff_lane_kernel(StepArgs<T> a) {
  const T div = a.num_fin > T(1) ? a.num_fin : T(1);
  for (int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x; b < a.B;
       b += (int64_t)gridDim.x * kThreads)
    a.muaff[b] = lane_partials(a.partials, a.npb, a.B, b, T(0), AddOp()) / div;
}

// max(v, lo) that keeps NaN
template <typename T>
__device__ __forceinline__ T barrier_max(T v, T lo) {
  return (v > lo || v != v) ? v : lo;
}

template <typename T>
struct UpdateArgs {
  int64_t nm, m, B;
  T* X;
  T* XL;
  T* XU;
  T* Y;   // (m, B)
  T* ZL;
  T* ZU;
  const T* DX;
  const T* DXL;
  const T* DXU;
  const T* DY;
  const T* DZL;
  const T* DZU;
  const T* alphap;  // (B,)
  const T* alphad;
  const uint8_t* done;  // (B,)
  const uint8_t* finl;  // (nm,)
  const uint8_t* finu;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) ipm_update_kernel(UpdateArgs<T> a) {
  const T kBarrierMin = T(1e-30);
  const int64_t B = a.B;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B || a.done[b] != 0) return;  // frozen lanes keep their iterate
  const T ap = a.alphap[b], ad = a.alphad[b];
  for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
       row < a.nm; row += (int64_t)gridDim.x * blockDim.y) {
    const int64_t i = row * B + b;
    a.X[i] = add_rn(a.X[i], mul_rn(ap, a.DX[i]));
    if (a.finl[row] != 0) {
      a.XL[i] = barrier_max(add_rn(a.XL[i], mul_rn(ap, a.DXL[i])),
                            kBarrierMin);
      a.ZL[i] = barrier_max(add_rn(a.ZL[i], mul_rn(ad, a.DZL[i])),
                            kBarrierMin);
    }
    if (a.finu[row] != 0) {
      a.XU[i] = barrier_max(add_rn(a.XU[i], mul_rn(ap, a.DXU[i])),
                            kBarrierMin);
      a.ZU[i] = barrier_max(add_rn(a.ZU[i], mul_rn(ad, a.DZU[i])),
                            kBarrierMin);
    }
    if (row < a.m) a.Y[i] = add_rn(a.Y[i], mul_rn(ad, a.DY[i]));
  }
}

template <typename T>
StepArgs<T> step_args(int64_t nm, int64_t B, const void* XL, const void* XU,
                      const void* ZL, const void* ZU, const void* DXL,
                      const void* DXU, const void* DZL, const void* DZU,
                      const void* finl, const void* finu, void* partials,
                      int64_t npb, void* maxp, void* maxd) {
  StepArgs<T> a;
  a.nm = nm;
  a.B = B;
  a.XL = static_cast<const T*>(XL);
  a.XU = static_cast<const T*>(XU);
  a.ZL = static_cast<const T*>(ZL);
  a.ZU = static_cast<const T*>(ZU);
  a.DXL = static_cast<const T*>(DXL);
  a.DXU = static_cast<const T*>(DXU);
  a.DZL = static_cast<const T*>(DZL);
  a.DZU = static_cast<const T*>(DZU);
  a.finl = static_cast<const uint8_t*>(finl);
  a.finu = static_cast<const uint8_t*>(finu);
  a.partials = static_cast<T*>(partials);
  a.npb = npb;
  a.maxp = static_cast<T*>(maxp);
  a.maxd = static_cast<T*>(maxd);
  a.num_fin = T(0);
  a.muaff = nullptr;
  return a;
}

template <typename T>
int step_batch(int64_t nm, int64_t B, const void* XL, const void* XU,
               const void* ZL, const void* ZU, const void* DXL,
               const void* DXU, const void* DZL, const void* DZU,
               const void* finl, const void* finu, void* partials,
               int64_t npb, void* maxp, void* maxd, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  const LaneGrid g = lane_grid(nm, B);
  if (npb != g.gx) return (int)cudaErrorInvalidValue;
  const StepArgs<T> a = step_args<T>(nm, B, XL, XU, ZL, ZU, DXL, DXU, DZL,
                                     DZU, finl, finu, partials, npb, maxp,
                                     maxd);
  auto s = static_cast<cudaStream_t>(stream);
  step_min_kernel<T><<<dim3((unsigned)g.gx, (unsigned)g.gy),
                       dim3((unsigned)g.tx, (unsigned)g.ty), 0, s>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  step_lane_kernel<T><<<(unsigned)blocks_for(B, kThreads), kThreads, 0, s>>>(
      a);
  return (int)cudaGetLastError();
}

template <typename T>
int muaff(int64_t nm, int64_t B, const void* XL, const void* XU,
          const void* ZL, const void* ZU, const void* DXL, const void* DXU,
          const void* DZL, const void* DZU, const void* finl,
          const void* finu, const void* maxp, const void* maxd,
          double num_fin, void* partials, int64_t npb, void* out,
          void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  const LaneGrid g = lane_grid(nm, B);
  if (npb != g.gx) return (int)cudaErrorInvalidValue;
  StepArgs<T> a = step_args<T>(nm, B, XL, XU, ZL, ZU, DXL, DXU, DZL, DZU,
                               finl, finu, partials, npb,
                               const_cast<void*>(maxp),
                               const_cast<void*>(maxd));
  a.num_fin = T(num_fin);
  a.muaff = static_cast<T*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  muaff_sum_kernel<T><<<dim3((unsigned)g.gx, (unsigned)g.gy),
                        dim3((unsigned)g.tx, (unsigned)g.ty), 0, s>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  muaff_lane_kernel<T><<<(unsigned)blocks_for(B, kThreads), kThreads, 0, s>>>(
      a);
  return (int)cudaGetLastError();
}

template <typename T>
int ipm_update(int64_t nm, int64_t m, int64_t B, void* X, void* XL, void* XU,
               void* Y, void* ZL, void* ZU, const void* DX, const void* DXL,
               const void* DXU, const void* DY, const void* DZL,
               const void* DZU, const void* alphap, const void* alphad,
               const void* done, const void* finl, const void* finu,
               void* stream) {
  if (B < 1 || m > nm) return (int)cudaErrorInvalidValue;
  UpdateArgs<T> a;
  a.nm = nm;
  a.m = m;
  a.B = B;
  a.X = static_cast<T*>(X);
  a.XL = static_cast<T*>(XL);
  a.XU = static_cast<T*>(XU);
  a.Y = static_cast<T*>(Y);
  a.ZL = static_cast<T*>(ZL);
  a.ZU = static_cast<T*>(ZU);
  a.DX = static_cast<const T*>(DX);
  a.DXL = static_cast<const T*>(DXL);
  a.DXU = static_cast<const T*>(DXU);
  a.DY = static_cast<const T*>(DY);
  a.DZL = static_cast<const T*>(DZL);
  a.DZU = static_cast<const T*>(DZU);
  a.alphap = static_cast<const T*>(alphap);
  a.alphad = static_cast<const T*>(alphad);
  a.done = static_cast<const uint8_t*>(done);
  a.finl = static_cast<const uint8_t*>(finl);
  a.finu = static_cast<const uint8_t*>(finu);
  const LaneGrid g = lane_grid(nm, B);
  ipm_update_kernel<T><<<dim3((unsigned)g.gx, (unsigned)g.gy),
                         dim3((unsigned)g.tx, (unsigned)g.ty), 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ipxt

// maxp[b] = min(1, min over rows of the XL/DXL/finl and XU/DXU/finu ratios),
// maxd[b] the same over ZL/DZL and ZU/DZU; partials hold 2 * npb * B values,
// npb = ipxt_lane_blocks(nm, B).
#define IPXT_STEP_BATCH(SUF, T)                                                \
  extern "C" int ipxt_step_batch_##SUF(                                        \
      int64_t nm, int64_t B, const void* XL, const void* XU, const void* ZL,   \
      const void* ZU, const void* DXL, const void* DXU, const void* DZL,       \
      const void* DZU, const void* finl, const void* finu, void* partials,     \
      int64_t npb, void* maxp, void* maxd, void* stream) {                     \
    return ipxt::step_batch<T>(nm, B, XL, XU, ZL, ZU, DXL, DXU, DZL, DZU,      \
                               finl, finu, partials, npb, maxp, maxd, stream); \
  }
IPXT_STEP_BATCH(f64, double)
IPXT_STEP_BATCH(f32, float)

// out[b] = sum over rows of finl ? (XL + maxp DXL)(ZL + maxd DZL) : 0 plus
// the same over the upper pairs, divided by max(num_fin, 1); partials hold
// npb * B values.
#define IPXT_MUAFF(SUF, T)                                                     \
  extern "C" int ipxt_muaff_##SUF(                                             \
      int64_t nm, int64_t B, const void* XL, const void* XU, const void* ZL,   \
      const void* ZU, const void* DXL, const void* DXU, const void* DZL,       \
      const void* DZU, const void* finl, const void* finu, const void* maxp,   \
      const void* maxd, double num_fin, void* partials, int64_t npb,           \
      void* out, void* stream) {                                               \
    return ipxt::muaff<T>(nm, B, XL, XU, ZL, ZU, DXL, DXU, DZL, DZU, finl,     \
                          finu, maxp, maxd, num_fin, partials, npb, out,       \
                          stream);                                             \
  }
IPXT_MUAFF(f64, double)
IPXT_MUAFF(f32, float)

// On the lanes b with done[b] == 0: X += alphap DX, Y += alphad DY (rows
// < m), and where finl (finu): XL (XU) = max(XL + alphap DXL, 1e-30), ZL
// (ZU) = max(ZL + alphad DZL, 1e-30); in place.
#define IPXT_IPM_UPDATE(SUF, T)                                                \
  extern "C" int ipxt_ipm_update_##SUF(                                        \
      int64_t nm, int64_t m, int64_t B, void* X, void* XL, void* XU, void* Y,  \
      void* ZL, void* ZU, const void* DX, const void* DXL, const void* DXU,    \
      const void* DY, const void* DZL, const void* DZU, const void* alphap,    \
      const void* alphad, const void* done, const void* finl,                  \
      const void* finu, void* stream) {                                        \
    return ipxt::ipm_update<T>(nm, m, B, X, XL, XU, Y, ZL, ZU, DX, DXL, DXU,   \
                               DY, DZL, DZU, alphap, alphad, done, finl, finu, \
                               stream);                                        \
  }
IPXT_IPM_UPDATE(f64, double)
IPXT_IPM_UPDATE(f32, float)
