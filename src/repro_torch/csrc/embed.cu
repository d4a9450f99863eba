// Fused gather and segment-sum (K5) for Hopper (sm_90a):
//
//     out[s, t, :] = sum over e with seg[e] == s of w[t, e] * table[t, gather[t, e], :]
//
// for T tables [T, R, D] float32, gather ids [T, E] int32, one shared seg [E]
// int32 in ascending order, optional weights [T, E] float32, and out
// [V, T, D] float32 (T = 1 is the single-table [V, D]). Gather ids outside
// [0, R) and segment ids outside [0, V) contribute nothing; sums are float32.
//
// Replaces: src/repro/kernels/ops.py:segment_embed (_segment_embed_jit), which
// on the TPU gathers the rows into [E, D] (padded to 128 columns), weights and
// masks them, and hands them to the one-hot segment-sum K1
// (src/repro/kernels/segsum.py, pl.pallas_call). It carries DCN-v2's
// EmbeddingBag (src/repro/models/recsys.py:embedding_bag), once for all 26
// tables.
//
// What bounds it: memory. Each lane reads a 4-byte id and one D-float row,
// chosen at random from a table far larger than L2 (26 x 10^6 x 64 bytes), and
// each bag writes D floats once: at DCN-v2's serving batch (262,144 bags of 4
// ids, 26 tables) about 2.3 GB against 0.44 G adds, so the least time is
// bytes / 3.35 TB/s.
//
// What the design does about it: the gathered rows are never written. Done as
// gather then K1, as on the TPU, the [T, E, D] rows (1.74 GB at that batch)
// would be written and read again; here they go from the table into
// registers and only the sums are stored. Two launches:
//
//   1. row_offsets (row_offsets.cuh, K1's offset pass): the sorted seg becomes
//      bag offsets, once for all tables.
//   2. embed: a group of G threads owns one (table, bag); each thread owns
//      VEC = 4 consecutive floats of the row (one 16-byte load; a scalar path
//      takes rows that are not 16-byte aligned), so at D = 16 a group is 4
//      threads and a warp serves 8 bags. The group walks its bag's lanes in
//      order, UNROLL at a time (ids and weights first, then the row loads, so
//      several loads are in flight per thread), skips invalid ids, and sums
//      in registers. One writer per output row: no atomics, and the sums are
//      deterministic. The table is the grid's y axis, so one launch serves
//      every table, and a warp's eight bags read 128 contiguous bytes of ids.
//
// Offsets into the tables, the ids and the output are 64-bit. Launched on the
// caller's stream; it neither allocates nor synchronises: the caller passes
// the offset scratch. Each C entry point returns cudaGetLastError() after its
// launches.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_offsets.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

template <int VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) r[j] = __ldg(p + j);
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* p, const float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = r[j];
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
embed_kernel(const float* __restrict__ tables, long long n_rows, int d,
             const int* __restrict__ gather, long long n_lanes,
             const float* __restrict__ weights, const int* __restrict__ off, int n_bags,
             int n_tables, int group, float* __restrict__ out) {
  const int t = blockIdx.y;
  const long long bag =
      static_cast<long long>(blockIdx.x) * (THREADS / group) + threadIdx.x / group;
  if (bag >= n_bags) return;
  const int lane = threadIdx.x % group;
  const int a = off[bag], b = off[bag + 1];
  const int* __restrict__ ids = gather + t * n_lanes;
  const float* __restrict__ w = weights ? weights + t * n_lanes : nullptr;
  const float* __restrict__ tab = tables + t * n_rows * d;
  float* dst = out + (bag * n_tables + t) * d;
  const int n_vec = d / VEC;
  for (int c = lane; c < n_vec; c += group) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    int e = a;
    for (; e + UNROLL <= b; e += UNROLL) {
      int id[UNROLL];
      float wt[UNROLL], r[UNROLL][VEC];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        id[k] = __ldg(ids + e + k);
        wt[k] = w ? __ldg(w + e + k) : 1.f;
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k)
        if (id[k] >= 0 && id[k] < n_rows)
          load_row<VEC>(tab + static_cast<long long>(id[k]) * d + c * VEC, r[k]);
#pragma unroll
      for (int k = 0; k < UNROLL; ++k)
        if (id[k] >= 0 && id[k] < n_rows) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += wt[k] * r[k][j];
        }
    }
    for (; e < b; ++e) {
      const int id = __ldg(ids + e);
      if (id < 0 || id >= n_rows) continue;
      const float wt = w ? __ldg(w + e) : 1.f;
      float r[VEC];
      load_row<VEC>(tab + static_cast<long long>(id) * d + c * VEC, r);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += wt * r[j];
    }
    store_row<VEC>(dst + c * VEC, acc);
  }
}

template <int VEC>
void launch_embed(const float* tables, long long n_rows, int d, int n_tables,
                  const int* gather, long long n_lanes, const float* weights,
                  const int* off, int n_bags, float* out, cudaStream_t stream) {
  int group = 1;  // threads per (table, bag): enough for the row, at most a warp
  while (group < d / VEC && group < 32) group *= 2;
  const long long blocks = (static_cast<long long>(n_bags) + THREADS / group - 1) /
                           (THREADS / group);
  embed_kernel<VEC><<<dim3(static_cast<unsigned>(blocks), n_tables), THREADS, 0, stream>>>(
      tables, n_rows, d, gather, n_lanes, weights, off, n_bags, n_tables, group, out);
}

}  // namespace

// Scratch ints the caller must pass for n_bags bags: the bag offsets.
extern "C" long long embed_scratch_ints(int n_bags) {
  return static_cast<long long>(n_bags) + 1;
}

// tables [n_tables, n_rows, d], gather and weights (nullable) [n_tables,
// n_lanes], seg [n_lanes] ascending, out [n_bags, n_tables, d]; all float32 or
// int32, contiguous. n_tables <= 65535 (the grid's y axis).
extern "C" int segment_embed_f32(const void* tables, long long n_rows, int d, int n_tables,
                                 const void* gather, long long n_lanes, const void* seg,
                                 const void* weights, int n_bags, void* out, void* scratch,
                                 void* stream_ptr) {
  if (n_bags <= 0 || d <= 0 || n_tables <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int* off = static_cast<int*>(scratch);
  row_offsets::launch(static_cast<const int*>(seg), n_lanes, n_bags, off, stream);
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(tables) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const float* tab = static_cast<const float*>(tables);
  const int* ids = static_cast<const int*>(gather);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  if (vec4)
    launch_embed<4>(tab, n_rows, d, n_tables, ids, n_lanes, w, off, n_bags, o, stream);
  else
    launch_embed<1>(tab, n_rows, d, n_tables, ids, n_lanes, w, off, n_bags, o, stream);
  return static_cast<int>(cudaGetLastError());
}

// The text of a CUDA error code, for the wrapper's exception.
extern "C" const char* embed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
