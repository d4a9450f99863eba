// Sorted segment-sum for Hopper (sm_90a):
//
//     out[v, :] = sum over e with seg[e] == v of values[e, :]
//
// for seg ascending; ids outside [0, n_rows) contribute nothing.
//
// Replaces: src/repro/kernels/segsum.py:segment_sum_sorted (Pallas body
// _segsum_kernel), the JAX package's one-hot MXU segment-sum. It carries the
// peel's degree update (core/dispatch.py:peel_delta) for P-Bahmani and the
// k-core fixpoint of CBDS-P.
//
// What bounds it: memory. Each lane is read once (a 4-byte id plus a 1- or
// 4-byte value) and each row written once, against one add per lane, so the
// least time is bytes / 3.35 TB/s: 23.7 us at the main path's shape (15.5 M
// bool lanes onto 524 K int32 rows).
//
// What the design does about it: sortedness turns the scatter into a
// reduction over contiguous runs, so no atomics on the sums and no sentinel
// tail are needed, and the summation order depends only on the data (the
// results are deterministic). The work is balanced by lanes, not by rows:
// Graph500 RMAT graphs put a large share of the lanes on a few low vertex
// ids (one row of 40 K lanes at scale 19), so a block that owned a fixed
// range of consecutive rows would hold the card waiting on the first few
// blocks. Two launches:
//
//   1. row_offsets (row_offsets.cuh, shared with K5): one thread per lane,
//      coalesced. Lane e starts the rows (id[e-1], id[e]], so it writes
//      off[r] = e for them: every off[r] = lower_bound(seg, r) is written
//      exactly once. A lane that starts a run longer than LONG lanes also
//      appends its row to a list of long rows.
//   2. reduce (D = 1): one thread per short row, which sums its run serially
//      (consecutive threads read neighbouring runs, so the warp's loads share
//      cache lines); and a fixed set of warps that take the long rows off
//      the list, each long row reduced by one warp with 16-byte vector loads
//      (16 bool lanes a load) and a shuffle tree. For D > 1, one warp per
//      row with lanes over the columns.
//
// Values may arrive as 1-byte bools; no conversion pass is made for them.
// Launched on the caller's stream; it neither allocates nor synchronises:
// the caller passes the scratch (row offsets and the long-row list).
// Each C entry point returns cudaGetLastError() after its launches.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_offsets.cuh"

namespace {

constexpr int THREADS = 256;       // 8 warps a block
constexpr int WARPS = THREADS / 32;
constexpr int LONG = 64;           // runs longer than this are reduced by a warp
constexpr int LONG_BLOCKS = 1056;  // 8 448 warps: 64 on each of 132 SMs
constexpr unsigned FULL = 0xffffffffu;

template <typename A>
__device__ __forceinline__ A warp_sum(A x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(FULL, x, off);
  return x;  // lane 0 holds the sum
}

// Sum of one 16-byte vector of values, in the accumulator's type.
template <typename T, typename A> struct Vec;
template <> struct Vec<float, float> {
  static constexpr int N = 4;
  __device__ static float sum(uint4 v) {
    return __uint_as_float(v.x) + __uint_as_float(v.y) + __uint_as_float(v.z) +
           __uint_as_float(v.w);
  }
};
template <> struct Vec<int, int> {
  static constexpr int N = 4;
  __device__ static int sum(uint4 v) {
    return static_cast<int>(v.x + v.y + v.z + v.w);
  }
};
template <> struct Vec<unsigned char, int> {
  static constexpr int N = 16;
  __device__ static int sum(uint4 v) {  // byte sums of each word
    return static_cast<int>(__vsadu4(v.x, 0u) + __vsadu4(v.y, 0u) +
                            __vsadu4(v.z, 0u) + __vsadu4(v.w, 0u));
  }
};

template <typename T, typename A>
__global__ void __launch_bounds__(THREADS)
reduce_d1_kernel(const T* __restrict__ vals, const int* __restrict__ off, int n_rows,
                 int n_short_blocks, const int* __restrict__ long_rows,
                 const int* __restrict__ n_long, A* __restrict__ out) {
  if (blockIdx.x < n_short_blocks) {
    const int r = blockIdx.x * THREADS + threadIdx.x;
    if (r >= n_rows) return;
    const int a = off[r], b = off[r + 1];
    if (b - a > LONG) return;  // on the long-row list
    A acc = 0;
    for (int e = a; e < b; ++e) acc += static_cast<A>(vals[e]);
    out[r] = acc;
    return;
  }
  // Long rows: one warp per row off the list, 16-byte loads for the aligned
  // body, scalar lanes for the unaligned head and the tail (< 16 lanes each).
  using V = Vec<T, A>;
  const int lane = threadIdx.x & 31;
  const int count = *n_long;
  const int n_warps = (gridDim.x - n_short_blocks) * WARPS;
  for (int k = (blockIdx.x - n_short_blocks) * WARPS + (threadIdx.x >> 5); k < count;
       k += n_warps) {
    const int r = long_rows[k];
    const int a = off[r], b = off[r + 1];
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(vals + a) % 16 / sizeof(T));
    const int body = mis ? min(b, a + (V::N - mis)) : a;  // first aligned lane
    const int n_vec = (b - body) / V::N;
    const int tail = body + n_vec * V::N;
    A acc = 0;
    if (lane < body - a) acc += static_cast<A>(vals[a + lane]);
    if (lane < b - tail) acc += static_cast<A>(vals[tail + lane]);
    const uint4* vec = reinterpret_cast<const uint4*>(vals + body);
#pragma unroll 4
    for (int i = lane; i < n_vec; i += 32) acc += V::sum(vec[i]);
    acc = warp_sum(acc);
    if (lane == 0) out[r] = acc;
  }
}

// D > 1: one warp per row (grid-stride), lanes over the columns.
template <typename T, typename A>
__global__ void __launch_bounds__(THREADS)
reduce_dn_kernel(const T* __restrict__ vals, const int* __restrict__ off, int n_rows,
                 int d, A* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = static_cast<long long>(gridDim.x) * WARPS;
  for (long long r = blockIdx.x * static_cast<long long>(WARPS) + (threadIdx.x >> 5);
       r < n_rows; r += n_warps) {
    const long long a = off[r], b = off[r + 1];
    for (int c = lane; c < d; c += 32) {
      A acc = 0;
      for (long long e = a; e < b; ++e) acc += static_cast<A>(vals[e * d + c]);
      out[r * d + c] = acc;
    }
  }
}

template <typename T, typename A>
int launch(const void* vals, const void* seg, long long n_lanes, int n_rows, int d,
           void* out, void* scratch, void* stream_ptr) {
  if (n_rows <= 0 || d <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // scratch: off [n_rows + 1], n_long [1], long_rows [n_lanes / LONG + 1]
  int* off = static_cast<int*>(scratch);
  int* n_long = off + n_rows + 1;
  int* long_rows = n_long + 1;
  const cudaError_t err = cudaMemsetAsync(n_long, 0, sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_offsets::launch<LONG>(static_cast<const int*>(seg), n_lanes, n_rows, off, long_rows,
                            n_long, stream);
  if (d == 1) {
    const int short_blocks = (n_rows + THREADS - 1) / THREADS;
    reduce_d1_kernel<T, A><<<short_blocks + LONG_BLOCKS, THREADS, 0, stream>>>(
        static_cast<const T*>(vals), off, n_rows, short_blocks, long_rows, n_long,
        static_cast<A*>(out));
  } else {
    const long long row_blocks = (static_cast<long long>(n_rows) + WARPS - 1) / WARPS;
    reduce_dn_kernel<T, A><<<static_cast<int>(row_blocks < 8448 ? row_blocks : 8448),
                             THREADS, 0, stream>>>(static_cast<const T*>(vals), off,
                                                   n_rows, d, static_cast<A*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch ints the caller must pass for n_lanes lanes onto n_rows rows.
extern "C" long long segsum_scratch_ints(long long n_lanes, int n_rows) {
  return static_cast<long long>(n_rows) + 2 + n_lanes / LONG + 1;
}

// float32 values -> float32 sums, [E] or [E, d] row-major.
extern "C" int segsum_sorted_f32(const void* vals, const void* seg, long long n_lanes,
                                 int n_rows, int d, void* out, void* scratch,
                                 void* stream) {
  return launch<float, float>(vals, seg, n_lanes, n_rows, d, out, scratch, stream);
}

// int32 values -> int32 sums (exact at any size).
extern "C" int segsum_sorted_i32(const void* vals, const void* seg, long long n_lanes,
                                 int n_rows, int d, void* out, void* scratch,
                                 void* stream) {
  return launch<int, int>(vals, seg, n_lanes, n_rows, d, out, scratch, stream);
}

// bool (one byte, 0 or 1) values -> int32 counts: the peel's 0/1 lanes.
extern "C" int segsum_sorted_u8(const void* vals, const void* seg, long long n_lanes,
                                int n_rows, int d, void* out, void* scratch,
                                void* stream) {
  return launch<unsigned char, int>(vals, seg, n_lanes, n_rows, d, out, scratch, stream);
}

// The text of a CUDA error code, for the wrapper's exception.
extern "C" const char* segsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
