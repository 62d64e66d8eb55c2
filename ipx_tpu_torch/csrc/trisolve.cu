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
// order, a pointer per level (on the host and on the card), and the rows'
// off-diagonal entries as one CSR in the same order. A row reads only rows
// of X that earlier levels wrote, never a row of its own level.
//
// The sweep: one launch per sweep (ipxt_level_sweep_f64). Lanes never
// interact: column b of X depends only on column b of V. So the order
// between levels needs to hold only among the threads that own a lane, and
// a block that owns a tile of lanes walks every level of the sweep on its
// own, with __syncthreads() between levels. No grid-wide barrier.
//   B = 1    one block; X lives in shared memory when m doubles fit (160
//            KB at m = 20 000), so V is read once, X written once and the
//            gathers never leave the SM. A thread takes a row and sums it
//            as the per-level form's warp does: lane t's entries t, t + 32,
//            ... in order, then the shuffle tree, which it replays over the
//            32 lane sums (a closed form up to 8 entries,
//            replay_warp_tree past them).
//   B >= 2   blocks of kSweepThreads threads over a tile of `lanes` lanes,
//            two lanes a thread (16-byte loads and stores) where B is even,
//            the rest of the threads across a level's rows. A thread sums
//            its row's entries in the order T stores them.
// Level 0 is a stream (its rows name no other row). After it, only the
// gathers of X depend on earlier levels, so a thread's loads of the rest
// (rows, entry pointers, 1 / diag, V, the first entries' columns and
// values) run up to two batches ahead of its sums (walk), and a level
// waits for its gathers of X, not for a chain of dependent loads a row.
//
// The per-level form, kept for comparison only (ipxt_level_solve_f64): one
// launch per level, the launch boundary ordering the levels:
//   B = 1    one warp per row: lane t takes the row's entries t, t + 32,
//            ... in order, and a shuffle tree sums the 32 partial sums;
//   B >= 2   threads across the lanes (up to kThreads a block, blockIdx.y
//            tiles the rest) by threadIdx.y across the level's rows.
// Both forms sum every row in the same order with the same roundings
// (fma_rn, add_rn), so they agree bit for bit, and two runs of either too.
//
// What bounds it on the H100: latency and memory. A sweep reads each entry
// (8 + 4 bytes), the schedule (rows, entry pointers, 1 / diag) and V once
// and writes X once: at m = 20 000 and B = 256 about 82 MB for the L and U
// sweeps, 25 us at 3.35 TB/s, over 24 + 13 levels of which 20 hold fewer
// than 300 rows. The per-level form pays a launch, its ramp-up and a chain
// of dependent loads for every level (about 1.8 us of device time at the
// narrow ones); the sweep pays a block barrier and the gathers of X a
// level, about 1-2 us, but a tile's few SMs stream a wide level at less of
// the card's rate than a whole-card launch (PERF.md §6).

#include "common.cuh"

namespace ipxt {
namespace {

constexpr int kWarpRows = kThreads / 32;   // rows of a block at B = 1
constexpr int kSweepThreads = 512;         // threads of a sweep's block

// -- the per-level form -------------------------------------------------------
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
  for (int64_t e = e0 + lane; e < e1; e += 32)
    s = fma_rn(vals[e], X[cols[e]], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = add_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  if (lane == 0) {
    const int64_t r = rows[p];
    X[r] = mul_rn(V[r] - s, inv_diag[p]);
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
    s = fma_rn(vals[e], X[(int64_t)cols[e] * B + b], s);
  const int64_t r = (int64_t)rows[p] * B + b;
  X[r] = mul_rn(V[r] - s, inv_diag[p]);
}

// -- the sweep ----------------------------------------------------------------
struct Sched {
  int64_t nlev;
  const int64_t* level_ptr;  // on the card
  const int* rows;
  const int64_t* entry_ptr;
  const int* cols;
  const double* vals;
  const double* inv_diag;
};

// -- the sweep's pipeline ----------------------------------------------------
//
// A thread's work in a sweep is a sequence of batches: in each level l, the
// rows p, p + stride, ... (kRows of them) for p = level_ptr[l] + slot,
// + kRows stride, ... below level_ptr[l + 1]. Only the gathers of X depend
// on earlier levels; the rest of a batch (its rows, entry pointers, 1 /
// diag, V, and the first kAhead entries' columns and values) is read-only
// input. So the loads run ahead: while a thread computes batch i, the
// loads of batch i + 1's data (which need its head) and batch i + 2's head
// are in flight, and a level's pass waits only for its gathers of X, not
// for a chain of dependent loads a row.
constexpr int kRows = 1;      // rows of a batch
constexpr int kAhead = 4;     // entries of a row loaded a batch ahead
constexpr int kTreeClosed = 2 * kAhead;
static_assert(kAhead == 4, "compute_one's closed form sums four pairs");

struct Head {      // the rows of a batch (k < 0: no row)
  int r[kRows];
  int k[kRows];
  int64_t e[kRows];
  double inv[kRows];
};

template <int VW>
struct Data {      // what a batch's rows read besides X, VW lanes a thread
  double v[kRows][VW];
  int col[kRows][kAhead];
  double w[kRows][kAhead];
};

// VW consecutive lanes of one row: one 16-byte access for VW = 2 (the
// caller keeps the row start 16-byte aligned), `cached` false bypassing L1
template <int VW>
__device__ __forceinline__ void load_lanes(const double* p, double (&o)[VW],
                                           bool cached) {
  if constexpr (VW == 2) {
    const double2 t = cached ? __ldg(reinterpret_cast<const double2*>(p))
                             : __ldcg(reinterpret_cast<const double2*>(p));
    o[0] = t.x;
    o[1] = t.y;
  } else {
    o[0] = cached ? __ldg(p) : __ldcg(p);
  }
}

template <int VW>
__device__ __forceinline__ void store_lanes(double* p,
                                            const double (&v)[VW]) {
  if constexpr (VW == 2)
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  else
    *p = v[0];
}

struct Cursor {    // a thread's batch: level l, position p, level end
  int64_t p, end;
  int l;
  bool ok;
};

// Moves c to the first batch at or after its position that lies inside a
// level; ok turns false past the last level.
__device__ __forceinline__ void settle(const Sched& s, Cursor& c,
                                       int64_t slot) {
  while (c.ok && c.p >= c.end) {
    if (++c.l >= s.nlev) {
      c.ok = false;
      return;
    }
    c.p = __ldg(s.level_ptr + c.l) + slot;
    c.end = __ldg(s.level_ptr + c.l + 1);
  }
}

__device__ __forceinline__ Cursor next_batch(const Sched& s, Cursor c,
                                             int64_t slot, int64_t stride) {
  c.p += kRows * stride;
  settle(s, c, slot);
  return c;
}

__device__ __forceinline__ Head load_head(const Sched& s, const Cursor& c,
                                          int64_t stride) {
  Head h;
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int64_t q = c.p + u * stride;
    h.k[u] = -1;
    if (c.ok && q < c.end) {
      h.r[u] = __ldg(s.rows + q);
      h.e[u] = __ldg(s.entry_ptr + q);
      h.k[u] = (int)(__ldg(s.entry_ptr + q + 1) - h.e[u]);
      h.inv[u] = __ldg(s.inv_diag + q);
    }
  }
  return h;
}

// V of lanes b .. b + VW - 1 (V + b, rows B apart) and the first kAhead
// entries
template <int VW>
__device__ __forceinline__ Data<VW> load_data(const Sched& s, const Head& h,
                                              int64_t B, const double* V) {
  Data<VW> d;
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    if (h.k[u] < 0) continue;
    load_lanes<VW>(V + (int64_t)h.r[u] * B, d.v[u], true);
#pragma unroll
    for (int t = 0; t < kAhead; ++t)
      if (t < h.k[u]) {
        d.col[u][t] = __ldg(s.cols + h.e[u] + t);
        d.w[u][t] = __ldg(s.vals + h.e[u] + t);
      }
  }
  return d;
}

__device__ __forceinline__ double canon(double s) { return add_rn(s, 0.0); }

// The sum of row entries e0..e1 as level_warp_kernel's warp takes it: lane
// t's sum of the entries e0 + t, e0 + t + 32, ... from 0 with one fma a
// term, then the shuffle tree over the 32 lane sums, in which lane 0 ends
// with T(0, 1), T(j, off) = T(j, 2 off) + T(j + off, 2 off) and T(j, 32) =
// lane j's sum, replayed by one thread: walked depth first the tree's
// leaves come in bit-reversed lane order, and a stack of one pending sum a
// height replays its additions.
__device__ __forceinline__ double replay_warp_tree(int64_t e0, int64_t e1,
                                                   const int* cols,
                                                   const double* vals,
                                                   const double* x) {
  constexpr int H = 5;  // 32 = 1 << H lanes
  double st[H];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int t = (int)(__brev((unsigned)i) >> (32 - H));
    double y = 0.0;
    for (int64_t e = e0 + t; e < e1; e += 32)
      y = fma_rn(__ldg(vals + e), x[__ldg(cols + e)], y);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      if (((i >> h) & 1) == 0) {
        st[h] = y;
        break;
      }
      y = add_rn(st[h], y);
      if (h == H - 1) st[0] = y;  // the root, i = 31
    }
  }
  return st[0];
}

// B = 1: x[r] = (v - sum) / diag for the batch's rows, each sum as
// level_warp_kernel's warp takes it. Rows of up to kTreeClosed = 8 entries
// take the tree's closed form: lane j's sum s_j is one fma from +0.0 for
// j < k and +0.0 past the row's entries, and a sum plus +0.0 is itself
// with -0.0 made +0.0 (canon), so the tree's lower levels reduce to c_j =
// canon(s_j), and lane 0 ends with ((c_0 + c_4) + (c_2 + c_6)) + ((c_1 +
// c_5) + (c_3 + c_7)), where c_{j + 4} = +0.0 leaves c_j as it is. Longer
// rows replay the whole tree (replay_warp_tree).
template <typename Put>
__device__ __forceinline__ void compute_one(const Sched& s, const Head& h,
                                            const Data<1>& d,
                                            const double* x, Put put) {
  double g[kRows][kAhead];
#pragma unroll
  for (int u = 0; u < kRows; ++u)
#pragma unroll
    for (int t = 0; t < kAhead; ++t)
      if (t < h.k[u] && h.k[u] <= kTreeClosed) g[u][t] = x[d.col[u][t]];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int k = h.k[u];
    if (k < 0) continue;
    double sum;
    if (k <= kTreeClosed) {
      double c[kAhead];
#pragma unroll
      for (int t = 0; t < kAhead; ++t)
        c[t] = t < k ? canon(fma_rn(d.w[u][t], g[u][t], 0.0)) : 0.0;
#pragma unroll
      for (int t = 0; t < kAhead; ++t)
        if (kAhead + t < k) {
          const int64_t e = h.e[u] + kAhead + t;
          c[t] = add_rn(c[t], canon(fma_rn(__ldg(s.vals + e),
                                           x[__ldg(s.cols + e)], 0.0)));
        }
      sum = add_rn(add_rn(c[0], c[2]), add_rn(c[1], c[3]));
    } else {
      sum = replay_warp_tree(h.e[u], h.e[u] + k, s.cols, s.vals, x);
    }
    put(h.r[u], mul_rn(d.v[u][0] - sum, h.inv[u]));
  }
}

// B >= 2, lanes b .. b + VW - 1: X[r, b] = (v - sum) / diag, each row's
// entries in storage order. The gathers of X bypass L1 (__ldcg): the
// sweep writes X, so it is not read-only data.
template <int VW>
__device__ __forceinline__ void compute_lanes(const Sched& s, const Head& h,
                                              const Data<VW>& d, int64_t B,
                                              int64_t b, double* X) {
  double g[kRows][kAhead][VW];
#pragma unroll
  for (int u = 0; u < kRows; ++u)
#pragma unroll
    for (int t = 0; t < kAhead; ++t)
      if (t < h.k[u])
        load_lanes<VW>(X + (int64_t)d.col[u][t] * B + b, g[u][t], false);
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    if (h.k[u] < 0) continue;
    double sum[VW], out[VW];
#pragma unroll
    for (int j = 0; j < VW; ++j) sum[j] = 0.0;
#pragma unroll
    for (int t = 0; t < kAhead; ++t)
      if (t < h.k[u])
#pragma unroll
        for (int j = 0; j < VW; ++j)
          sum[j] = fma_rn(d.w[u][t], g[u][t][j], sum[j]);
    for (int64_t e = h.e[u] + kAhead; e < h.e[u] + h.k[u]; ++e) {
      double x[VW];
      load_lanes<VW>(X + (int64_t)__ldg(s.cols + e) * B + b, x, false);
      const double w = __ldg(s.vals + e);
#pragma unroll
      for (int j = 0; j < VW; ++j) sum[j] = fma_rn(w, x[j], sum[j]);
    }
#pragma unroll
    for (int j = 0; j < VW; ++j)
      out[j] = mul_rn(d.v[u][j] - sum[j], h.inv[u]);
    store_lanes<VW>(X + (int64_t)h.r[u] * B + b, out);
  }
}

// One thread's walk over every level of the sweep: batches from `slot`
// with rows `stride` apart, a barrier (sync()) after each level. kOne: B =
// 1, the gathers read x (shared or global memory) and put(i, value) writes
// x[i]; else lanes b .. b + VW - 1 (lane_ok: b < B) of X, rows B apart.
// Every thread calls sync() nlev times.
//
// Level 0 comes first, on its own: its rows name no other row (a stored
// entry off the diagonal, even an explicit zero, puts a row in a later
// level), so it is a stream X[r] = (V[r] - 0) / diag, kStream rows a
// thread at a time.
constexpr int kStream = 8;

template <bool kOne, int VW, typename Put, typename Sync>
__device__ __forceinline__ void walk(const Sched& s, int64_t slot,
                                     int64_t stride, int64_t B, int64_t b,
                                     bool lane_ok, const double* V,
                                     double* x, Put put, Sync sync) {
  const int64_t p1 = __ldg(s.level_ptr + 1);
  for (int64_t p = slot; lane_ok && p < p1; p += kStream * stride) {
    int64_t r[kStream];
    double inv[kStream], v[kStream][VW];
#pragma unroll
    for (int u = 0; u < kStream; ++u) {
      const int64_t q = p + u * stride;
      if (q < p1) {
        r[u] = (int64_t)__ldg(s.rows + q) * B + b;
        inv[u] = __ldg(s.inv_diag + q);
      }
    }
#pragma unroll
    for (int u = 0; u < kStream; ++u)
      if (p + u * stride < p1) load_lanes<VW>(V + r[u], v[u], true);
#pragma unroll
    for (int u = 0; u < kStream; ++u) {
      if (p + u * stride >= p1) continue;
      double out[VW];
#pragma unroll
      for (int j = 0; j < VW; ++j) out[j] = mul_rn(v[u][j] - 0.0, inv[u]);
      if (kOne)
        put(r[u], out[0]);
      else
        store_lanes<VW>(x + r[u], out);
    }
  }
  sync();
  if (s.nlev == 1) return;
  Cursor c0{p1 + slot, __ldg(s.level_ptr + 2), 1, lane_ok};
  settle(s, c0, slot);
  Cursor c1 = next_batch(s, c0, slot, stride);
  Head h0 = load_head(s, c0, stride), h1 = load_head(s, c1, stride);
  Data<VW> d0 = load_data<VW>(s, h0, B, V + b);
  for (int l = 1; l < s.nlev; ++l) {
    while (c0.ok && c0.l == l) {
      const Cursor c2 = next_batch(s, c1, slot, stride);
      const Head h2 = load_head(s, c2, stride);
      const Data<VW> d1 = load_data<VW>(s, h1, B, V + b);
      if constexpr (kOne)
        compute_one(s, h0, d0, x, put);
      else
        compute_lanes<VW>(s, h0, d0, B, b, x);
      c0 = c1;
      c1 = c2;
      h0 = h1;
      h1 = h2;
      d0 = d1;
    }
    sync();
  }
}

// B = 1: the whole sweep in one block. kShared: X lives in shared memory
// (m doubles of dynamic shared memory) and is written out at the end.
template <bool kShared>
__global__ void __launch_bounds__(kSweepThreads, 1)
sweep_one_kernel(int64_t m, Sched s, const double* __restrict__ V,
                 double* X) {
  extern __shared__ double xs[];
  double* x = kShared ? xs : X;
  walk<true, 1>(s, threadIdx.x, blockDim.x, 1, 0, true, V, x,
             [&](int64_t i, double v) { x[i] = v; },
             [] { __syncthreads(); });
  // walk ended on a barrier after the last level
  if (kShared)
    for (int64_t i = threadIdx.x; i < m; i += blockDim.x) X[i] = xs[i];
}

// B >= 2: block `tile` owns lanes tile * LANES ... and every level's rows;
// a thread takes VW of the tile's lanes (VW = 2: B even, so every row of V
// and X starts 16-byte aligned). One block an SM: the 128 tiles of
// kernels.k17_tile fill the card once, and a thread may take the SM's
// registers for loads in flight (faster at B = 256 and 1024 than the
// compiler's default register budget, PERF.md §6).
template <int LANES, int VW>
__global__ void __launch_bounds__(kSweepThreads, 1)
sweep_tile_kernel(int64_t B, Sched s, const double* __restrict__ V,
                  double* X) {
  constexpr int kGroups = LANES / VW;          // threads across a row
  const int64_t b =
      (int64_t)blockIdx.x * LANES + (threadIdx.x % kGroups) * VW;
  const auto put = [](int64_t, double) {};   // the lanes store themselves
  walk<false, VW>(s, threadIdx.x / kGroups, kSweepThreads / kGroups, B, b,
                  b < B, V, X, put, [] { __syncthreads(); });
}

// a tile of LANES lanes a block, two lanes a thread where B is even and V
// and X start 16-byte aligned
template <int LANES>
cudaError_t launch_tiles(int64_t B, const Sched& s, const double* V,
                         double* X, cudaStream_t stream) {
  const int64_t tiles = blocks_for(B, LANES);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(V) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(X) % 16 == 0;
  if (LANES >= 2 && B % 2 == 0 && aligned)
    sweep_tile_kernel<LANES, LANES >= 2 ? 2 : 1>
        <<<(unsigned)tiles, kSweepThreads, 0, stream>>>(B, s, V, X);
  else
    sweep_tile_kernel<LANES, 1>
        <<<(unsigned)tiles, kSweepThreads, 0, stream>>>(B, s, V, X);
  return cudaGetLastError();
}

// Shared memory a block may take on the current device (its opt-in limit).
int shared_limit(int64_t* out) {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  *out = bytes;
  return (int)err;
}

}  // namespace
}  // namespace ipxt

using namespace ipxt;

// The per-level form, for comparison only: for l = 0..nlev-1 a launch over
// the rows rows[level_ptr[l] .. level_ptr[l + 1]). level_ptr lies on the
// host; every other pointer on the card. Returns the first CUDA error of a
// launch, else 0.
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

// The sweep in one launch: level_ptr (nlev + 1 int64) and every other
// pointer on the card; X must not be V. B = 1 takes one block, with X in
// shared memory when m doubles fit (lanes is not read); B >= 2 takes
// blocks_for(B, lanes) blocks, each a tile of `lanes` lanes (1, 2, 4, 8, 16
// or 32). Returns the launch's CUDA error, else 0.
extern "C" int ipxt_level_sweep_f64(int64_t m, int64_t nlev,
                                    const void* level_ptr, int64_t B,
                                    int lanes, const void* rows,
                                    const void* entry_ptr, const void* cols,
                                    const void* vals, const void* inv_diag,
                                    const void* V, void* X, void* stream) {
  if (m < 1 || nlev < 1 || B < 1) return (int)cudaErrorInvalidValue;
  Sched s;
  s.nlev = nlev;
  s.level_ptr = static_cast<const int64_t*>(level_ptr);
  s.rows = static_cast<const int*>(rows);
  s.entry_ptr = static_cast<const int64_t*>(entry_ptr);
  s.cols = static_cast<const int*>(cols);
  s.vals = static_cast<const double*>(vals);
  s.inv_diag = static_cast<const double*>(inv_diag);
  auto v = static_cast<const double*>(V);
  auto x = static_cast<double*>(X);
  auto st = static_cast<cudaStream_t>(stream);
  if (B == 1) {
    int64_t limit = 0;
    const int err = shared_limit(&limit);
    if (err != 0) return err;
    const int64_t bytes = 8 * m;
    if (bytes <= limit) {
      const cudaError_t set = cudaFuncSetAttribute(
          sweep_one_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (set != cudaSuccess) return (int)set;
      sweep_one_kernel<true><<<1, kSweepThreads, (size_t)bytes, st>>>(
          m, s, v, x);
    } else {
      sweep_one_kernel<false><<<1, kSweepThreads, 0, st>>>(m, s, v, x);
    }
    return (int)cudaGetLastError();
  }
  cudaError_t err;
  switch (lanes) {
    case 1: err = launch_tiles<1>(B, s, v, x, st); break;
    case 2: err = launch_tiles<2>(B, s, v, x, st); break;
    case 4: err = launch_tiles<4>(B, s, v, x, st); break;
    case 8: err = launch_tiles<8>(B, s, v, x, st); break;
    case 16: err = launch_tiles<16>(B, s, v, x, st); break;
    case 32: err = launch_tiles<32>(B, s, v, x, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
