// K5 csr_spmm and K6 normal_apply_batched: sparse matrix times a batch of
// vectors over CSR rows, Y = A U with U of shape (cols, B), row-major (B
// contiguous), for Hopper (sm_90a).
//
// Replaces: ipx_tpu/ops/spmv.py apply_csr_batched / apply_csr_batched_tree
// (a `take` of the rows of U into an (nnz, B) array and a sorted
// segment_sum over it) and NormalMatrixDevice.apply_batched /
// normal_apply_batched_tree, with the column dots jnp.sum(V * out, axis=0)
// of ipx_tpu/parallel/batch.py _cr_solve.C.
//
// What bounds it on the H100: memory. Every nonzero gathers one row of U
// (B values) and there is one multiply-add per value gathered. At the batched
// path's full width (m = 20 000, n = 96 002, nnz 192 004, B = 256, f32) one
// K6 writes and re-reads U = W_s * (A' V) (98 MB each way), reads W_s
// (98 MB) and moves about 60 MB of (m, B) arrays: about 0.1-0.15 ms at
// 3.35 TB/s. There is no reuse that a tensor core could exploit.
//
// Design: a group of threads per output row walks the row's nonzeros; the
// threads of the group split the B lanes, each taking VW adjacent lanes with
// one 16-byte load (float4 / double2) where B is a multiple of VW and the
// pointers are aligned, one lane otherwise. A gather of row `col` of U is
// then contiguous across the group, and the (nnz, B) intermediate of the
// reference and of the plain version never exists. Blocks stride over the
// rows (at most kMaxRowBlocks of them), so the per-lane partials of a
// reduction stay short.
//
// K6 is two launches with epilogues, as K2 is to K1:
//   U   = W_s * (A' V)                 (rowscale, an (n, B) array)
//   out = A U + W_slack * V            (addw, addv)
// and the second launch writes per-block, per-lane partials of the column
// dots V.out, shape (blocks, B). They are summed in a fixed order (lane_sum
// below, or the K7 passes of batch_cr.cu), never with atomics, so a stage
// repeats bit for bit.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (cudaErrorInvalidValue for arguments it does
// not take).

#include <initializer_list>

#include "common.cuh"

namespace ipxt {
namespace {

// VW values from p: one 16-byte load when VW > 1 (p is then aligned).
template <typename T, int VW>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[VW]) {
  if constexpr (VW == 1) {
    v[0] = p[0];
  } else if constexpr (sizeof(T) == 8) {
    const double2 d = *reinterpret_cast<const double2*>(p);
    v[0] = d.x;
    v[1] = d.y;
  } else {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

// the same through the read-only cache, for the gathered rows of U
template <typename T, int VW>
__device__ __forceinline__ void ldg_vec(const T* p, T (&v)[VW]) {
  if constexpr (VW == 1) {
    v[0] = __ldg(p);
  } else if constexpr (sizeof(T) == 8) {
    const double2 d = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = d.x;
    v[1] = d.y;
  } else {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

template <typename T, int VW>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[VW]) {
  if constexpr (VW == 1) {
    p[0] = v[0];
  } else if constexpr (sizeof(T) == 8) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <typename T, int VW>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(int64_t rows, int64_t B, const int64_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const T* __restrict__ vals, const T* __restrict__ U,
                const T* __restrict__ rowscale, const T* __restrict__ addw,
                const T* __restrict__ addv, T* __restrict__ Y,
                T* __restrict__ partials, const T* __restrict__ state) {
  __shared__ T red[kThreads * VW];
  if (loop_done(state)) return;
  const int64_t lane0 = ((int64_t)blockIdx.y * blockDim.x + threadIdx.x) * VW;
  const bool lane_ok = lane0 < B;
  T dot[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) dot[j] = T(0);
  if (lane_ok) {
    for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
         row < rows; row += (int64_t)gridDim.x * blockDim.y) {
      T acc[VW];
#pragma unroll
      for (int j = 0; j < VW; ++j) acc[j] = T(0);
      const int64_t end = indptr[row + 1];
      for (int64_t k = indptr[row]; k < end; ++k) {
        const T a = vals[k];
        T u[VW];
        ldg_vec<T, VW>(U + (int64_t)indices[k] * B + lane0, u);
#pragma unroll
        for (int j = 0; j < VW; ++j) acc[j] += a * u[j];
      }
      const int64_t o = row * B + lane0;
      if (rowscale != nullptr) {
        T s[VW];
        load_vec<T, VW>(rowscale + o, s);
#pragma unroll
        for (int j = 0; j < VW; ++j) acc[j] *= s[j];
      }
      if (addw != nullptr) {
        T w[VW], v[VW];
        load_vec<T, VW>(addw + o, w);
        load_vec<T, VW>(addv + o, v);
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          acc[j] += w[j] * v[j];
          dot[j] += v[j] * acc[j];
        }
      }
      store_vec<T, VW>(Y + o, acc);
    }
  }
  if (partials != nullptr) {
    lane_reduce<T, VW>(dot, red, AddOp());
    if (threadIdx.y == 0 && lane_ok)
      store_vec<T, VW>(partials + (int64_t)blockIdx.x * B + lane0, dot);
  }
}

// out[b] = sum over k of p[k, b], in order; one thread per lane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lane_sum_kernel(int64_t n, int64_t B, const T* __restrict__ p,
                T* __restrict__ out) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b < B) out[b] = lane_partials(p, n, B, b, T(0), AddOp());
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int csr_spmm(int64_t rows, int64_t B, const void* indptr, const void* indices,
             const void* vals, const void* U, const void* rowscale,
             const void* addw, const void* addv, void* Y, void* partials,
             const void* state, int vw, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (B < 1 || (vw != 1 && vw != V)) return (int)cudaErrorInvalidValue;
  if ((addw == nullptr) != (addv == nullptr) ||
      (partials != nullptr && addv == nullptr))
    return (int)cudaErrorInvalidValue;
  if (vw == V) {
    if (B % V != 0) return (int)cudaErrorInvalidValue;
    for (const void* p : {U, rowscale, addw, addv, (const void*)Y,
                          (const void*)partials})
      if (p != nullptr && !aligned16(p)) return (int)cudaErrorInvalidValue;
  }
  const LaneGrid g = lane_grid(rows, B / vw);
  const dim3 grid((unsigned)g.gx, (unsigned)g.gy);
  const dim3 block((unsigned)g.tx, (unsigned)g.ty);
  auto s = static_cast<cudaStream_t>(stream);
  auto ip = static_cast<const int64_t*>(indptr);
  auto ix = static_cast<const int32_t*>(indices);
  auto v = static_cast<const T*>(vals);
  auto u = static_cast<const T*>(U);
  auto rs = static_cast<const T*>(rowscale);
  auto aw = static_cast<const T*>(addw);
  auto av = static_cast<const T*>(addv);
  auto y = static_cast<T*>(Y);
  auto pp = static_cast<T*>(partials);
  auto st = static_cast<const T*>(state);
  if (vw == 1)
    csr_spmm_kernel<T, 1><<<grid, block, 0, s>>>(rows, B, ip, ix, v, u, rs,
                                                  aw, av, y, pp, st);
  else
    csr_spmm_kernel<T, V><<<grid, block, 0, s>>>(rows, B, ip, ix, v, u, rs,
                                                  aw, av, y, pp, st);
  return (int)cudaGetLastError();
}

template <typename T>
int lane_sum(int64_t n, int64_t B, const void* p, void* out, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  lane_sum_kernel<T><<<(unsigned)blocks_for(B, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      n, B, static_cast<const T*>(p), static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ipxt

// Row blocks of a batched pass over `rows` rows and `chunks` lane chunks (B
// lanes, or B / VW for K5): the number of per-lane partials it writes.
extern "C" int64_t ipxt_lane_blocks(int64_t rows, int64_t chunks) {
  return ipxt::lane_grid(rows, chunks).gx;
}

// Y[i, :] = (sum_k vals[k] U[indices[k], :]) * rowscale[i, :]
//           + addw[i, :] addv[i, :];
// rowscale, addw/addv, partials and state may each be null; all arrays are
// row-major with B columns. With partials, partials[blk, :] = sum over the
// rows of row block blk of addv[i, :] Y[i, :]. vw is 1 or 16 / sizeof(T).
extern "C" int ipxt_csr_spmm_f64(int64_t rows, int64_t B, const void* indptr,
                                 const void* indices, const void* vals,
                                 const void* U, const void* rowscale,
                                 const void* addw, const void* addv, void* Y,
                                 void* partials, const void* state, int vw,
                                 void* stream) {
  return ipxt::csr_spmm<double>(rows, B, indptr, indices, vals, U, rowscale,
                                addw, addv, Y, partials, state, vw, stream);
}

extern "C" int ipxt_csr_spmm_f32(int64_t rows, int64_t B, const void* indptr,
                                 const void* indices, const void* vals,
                                 const void* U, const void* rowscale,
                                 const void* addw, const void* addv, void* Y,
                                 void* partials, const void* state, int vw,
                                 void* stream) {
  return ipxt::csr_spmm<float>(rows, B, indptr, indices, vals, U, rowscale,
                               addw, addv, Y, partials, state, vw, stream);
}

// out[b] = sum of p[0..n, b] in order, for the n x B partials of a launch.
extern "C" int ipxt_lane_sum_f64(int64_t n, int64_t B, const void* p,
                                 void* out, void* stream) {
  return ipxt::lane_sum<double>(n, B, p, out, stream);
}

extern "C" int ipxt_lane_sum_f32(int64_t n, int64_t B, const void* p,
                                 void* out, void* stream) {
  return ipxt::lane_sum<float>(n, B, p, out, stream);
}
