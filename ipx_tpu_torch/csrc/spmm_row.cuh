// What the batched row kernels share, for B lanes a row (B contiguous): the
// 16-byte loads and stores of VW lanes, K5's row epilogue and the store of
// its per-block, per-lane partials, and the check of a lane width against B
// and the pointers' alignment. Used by K5 and K6 (spmm.cu) and by K16's
// fused block normal apply (sharded.cu), so that all of them round alike.
#pragma once

#include <initializer_list>

#include "common.cuh"

namespace ipxt {

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

// the same as a streaming load (evict first), for arrays read once that
// should not push the gathered rows out of L2
template <typename T, int VW>
__device__ __forceinline__ void ldcs_vec(const T* p, T (&v)[VW]) {
  if constexpr (VW == 1) {
    v[0] = __ldcs(p);
  } else if constexpr (sizeof(T) == 8) {
    const double2 d = __ldcs(reinterpret_cast<const double2*>(p));
    v[0] = d.x;
    v[1] = d.y;
  } else {
    const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

// VW values to p as a streaming store (evict first), for an output that
// should not push the gathered rows out of L2
template <typename T, int VW>
__device__ __forceinline__ void stcs_vec(T* p, const T (&v)[VW]) {
  if constexpr (VW == 1) {
    __stcs(p, v[0]);
  } else if constexpr (sizeof(T) == 8) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  } else {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
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

// K5's epilogue for one row: acc *= rowscale; acc += addw addv and, into
// dot, addv acc; then the store. o is the row's offset plus lane0.
template <typename T, int VW, bool kStream>
__device__ __forceinline__ void row_epilogue(int64_t o, T (&acc)[VW],
                                             const T* __restrict__ rowscale,
                                             const T* __restrict__ addw,
                                             const T* __restrict__ addv,
                                             T* __restrict__ Y, T (&dot)[VW]) {
  if (rowscale != nullptr) {
    T s[VW];
    load_vec<T, VW>(rowscale + o, s);
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[j] *= s[j];
  }
  if (addw != nullptr) {
    T w[VW], v[VW];
    if constexpr (kStream)
      ldcs_vec<T, VW>(addw + o, w);
    else
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

// the per-block, per-lane partials of the column dots, row block blockIdx.x
template <typename T, int VW>
__device__ __forceinline__ void store_dots(T (&dot)[VW], T* red, bool lane_ok,
                                           int64_t B, int64_t lane0,
                                           T* __restrict__ partials) {
  lane_reduce<T, VW>(dot, red, AddOp());
  if (threadIdx.y == 0 && lane_ok)
    store_vec<T, VW>(partials + (int64_t)blockIdx.x * B + lane0, dot);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Checks the lane width vw against B and the pointers' alignment.
template <typename T>
bool width_ok(int64_t B, int vw, std::initializer_list<const void*> ptrs) {
  constexpr int V = 16 / sizeof(T);
  if (B < 1 || (vw != 1 && vw != V)) return false;
  if (vw == V) {
    if (B % V != 0) return false;
    for (const void* p : ptrs)
      if (p != nullptr && !aligned16(p)) return false;
  }
  return true;
}

}  // namespace ipxt
