// K17 level_solve: the sweeps of a level-scheduled sparse triangular solve
// T X = V, V and X of shape (m, B) with the B lanes contiguous, float64, for
// Hopper (sm_90a).
//
// Replaces: tools/device_trisolve_proto.py:118-132, level_solve: one
// lax.fori_loop over the levels of T, each step a gather-multiply of the
// level's entries, a segment sum per row, the subtraction from b, the
// scaling by 1 / diag and a scatter into X, on arrays padded to
// (levels, Rmax) and (levels, Emax) for XLA's static shapes.
//
// Here the schedule is kept unpadded (ops/trisolve.py): the rows in level
// order, a host pointer per level, and the rows' off-diagonal entries as one
// CSR in the same order. The C entry launches one pass per level on the
// given stream; the launch boundary orders the levels, and a pass reads
// only rows of X that earlier levels wrote, never a row of its own level.
// X may be V (in place): a row's V is read only by the threads that then
// write the same row of X.
//
// Two shapes of pass:
//   B = 1    one warp per row: lane t takes the row's entries t, t + 32, ...
//            in order, and a shuffle tree sums the 32 partial sums;
//   B >= 2   threads across the lanes (up to kThreads a block, blockIdx.y
//            tiles the rest) by threadIdx.y across the level's rows; a
//            thread sums its row's entries in the order T stores them, so
//            each gathered row of X is one coalesced read across the
//            block's lanes.
// Each row's sum runs in a fixed order, so two runs agree bit for bit.
//
// What bounds it on the H100: memory and launch latency. A sweep reads each
// entry (8 + 4 bytes), the schedule (rows, entry pointers, 1 / diag) and V
// once and writes X once: at m = 20 000 and B = 256 that is about 82 MB,
// 25 us at 3.35 TB/s, spread over 13-24 launches, one per level. At B = 1 a
// level moves a few kilobytes and the sweep costs its launches. What the
// design does about it: lanes on neighbouring threads for coalesced reads
// of X, and one host call for all the launches of a sweep. A persistent
// single-launch sweep, TMA and wgmma are later work.

#include "common.cuh"

namespace ipxt {
namespace {

constexpr int kWarpRows = kThreads / 32;   // rows of a block at B = 1

__global__ void __launch_bounds__(kThreads)
level_warp_kernel(int64_t nrows, const int* __restrict__ rows,
                  const int64_t* __restrict__ entry_ptr,
                  const int* __restrict__ cols,
                  const double* __restrict__ vals,
                  const double* __restrict__ inv_diag, const double* V,
                  double* X) {
  const int64_t p = (int64_t)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (p >= nrows) return;  // uniform within the warp
  const int lane = threadIdx.x & 31;
  const int64_t e0 = entry_ptr[p], e1 = entry_ptr[p + 1];
  double s = 0.0;
  for (int64_t e = e0 + lane; e < e1; e += 32) s += vals[e] * X[cols[e]];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int64_t r = rows[p];
    X[r] = (V[r] - s) * inv_diag[p];
  }
}

__global__ void __launch_bounds__(kThreads)
level_lanes_kernel(int64_t nrows, int64_t B, const int* __restrict__ rows,
                   const int64_t* __restrict__ entry_ptr,
                   const int* __restrict__ cols,
                   const double* __restrict__ vals,
                   const double* __restrict__ inv_diag, const double* V,
                   double* X) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (p >= nrows || b >= B) return;
  const int64_t e0 = entry_ptr[p], e1 = entry_ptr[p + 1];
  double s = 0.0;
  for (int64_t e = e0; e < e1; ++e)
    s += vals[e] * X[(int64_t)cols[e] * B + b];
  const int64_t r = (int64_t)rows[p] * B + b;
  X[r] = (V[r] - s) * inv_diag[p];
}

}  // namespace
}  // namespace ipxt

using namespace ipxt;

// One sweep: for l = 0..nlev-1 a pass over the rows rows[level_ptr[l] ..
// level_ptr[l + 1]). level_ptr lies on the host; every other pointer on the
// card. Returns the first CUDA error of a launch, else 0.
extern "C" int ipxt_level_solve_f64(int64_t nlev, const int64_t* level_ptr,
                                    int64_t B, const void* rows,
                                    const void* entry_ptr, const void* cols,
                                    const void* vals, const void* inv_diag,
                                    const void* V, void* X, void* stream) {
  if (nlev < 0 || B < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int tx = (int)(B < kThreads ? B : kThreads);
  const int ty = kThreads / tx;
  const int64_t gy = blocks_for(B, tx);
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  for (int64_t l = 0; l < nlev; ++l) {
    const int64_t p0 = level_ptr[l], nrows = level_ptr[l + 1] - p0;
    if (nrows <= 0) continue;
    const int* r = static_cast<const int*>(rows) + p0;
    const int64_t* ep = static_cast<const int64_t*>(entry_ptr) + p0;
    const double* inv = static_cast<const double*>(inv_diag) + p0;
    if (B == 1) {
      level_warp_kernel<<<(unsigned)blocks_for(nrows, kWarpRows), kThreads,
                          0, s>>>(nrows, r, ep, static_cast<const int*>(cols),
                                  static_cast<const double*>(vals), inv,
                                  static_cast<const double*>(V),
                                  static_cast<double*>(X));
    } else {
      const dim3 grid((unsigned)blocks_for(nrows, ty), (unsigned)gy);
      const dim3 block((unsigned)tx, (unsigned)ty);
      level_lanes_kernel<<<grid, block, 0, s>>>(
          nrows, B, r, ep, static_cast<const int*>(cols),
          static_cast<const double*>(vals), inv,
          static_cast<const double*>(V), static_cast<double*>(X));
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
