// Sorted segment-sum for Hopper (sm_90a):
//
//     out[v, :] = sum over e with seg[e] == v of values[e, :]
//
// for seg ascending; ids outside [0, n_rows) contribute nothing.
//
// Replaces: src/repro/kernels/segsum.py:segment_sum_sorted (Pallas body
// _segsum_kernel), the JAX package's one-hot MXU segment-sum. It carries
// core/dispatch.py:peel_delta, ops.segment_sum and the GNNs' message passing
// (models/gnn.py:_seg); the peel's own edge stage runs on the same core in
// peel.cu (K2).
//
// What bounds it: memory. Each lane is read once (a 4-byte id plus a 1- or
// 4-byte value) and each row written once, against one add per lane, so the
// least time is bytes / 3.35 TB/s: 23.7 us at the main path's shape (15.5 M
// bool lanes onto 524 K int32 rows).
//
// What the design does about it (D = 1): one pass of the segmented-reduction
// core of seg_reduce.cuh. Warps own tiles of 512 consecutive lanes (balanced
// by lanes, so RMAT's hub rows cost no more than any other lanes), load ids
// and values with 16-byte vector loads, sum runs in registers and across the
// warp by a segmented shuffle scan, and store each row from the thread that
// ends it. Launches: a memset of the output; the reduction; for float32 a
// short carry launch that adds the partials of rows crossing tile edges in
// tile order (deterministic); int32 adds them with atomicAdd (exact).
// Values may arrive as 1-byte bools, read 16 a load with no conversion pass;
// values that start off a 16-byte boundary relative to the ids (a view such
// as values[3:]) are read lane by lane.
//
// D > 1 (the GNNs' messages: D = 3, 7, 16, 64 and MACE's 1,152, float32):
// the row-offset pass of row_offsets.cuh, then one warp per row with lanes
// over the columns, each lane summing its column over the row's lanes in
// lane order (so float32 sums are bitwise repeatable). Bound by the same
// bytes (E * D values read once); a warp keeps one load in flight a column
// chunk, which is what holds it above that bound.
//
// Rows (segsum_rows_*): the sums of G independent rows of L lanes in one
// launch, int32 out [G, V + 1]. This replaces K1 under the JAX package's
// vmap, which gives the Pallas grid a batch axis for the fused tenants'
// bucket peels (src/repro/core/prune.py:533 _batched_bucket_peel_jit, its
// degrees through segsum.py:118). A memset of the output, then row-local
// blocks (reduce_rows_kernel on seg_reduce.cuh's walk_span): a block owns a
// span of whole tiles of one row and runs the one-row reduction on that
// row's lanes and pointers (plain keys, the row's own alignment pad, the
// output offset by r * (V + 1), so a row's sentinel tail never meets the
// next row's vertex 0); a span that starts in the sentinel tail returns at
// once. Bound by the same bytes as one call over G * L lanes; as for K2
// rows, the shared core's per-tile arithmetic is what holds it above that.
//
// Launched on the caller's stream; it neither allocates nor synchronises:
// the caller passes the scratch (float32 carries, or the D > 1 row offsets).
// Each C entry point returns cudaGetLastError() after its launches.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "row_offsets.cuh"
#include "seg_reduce.cuh"

namespace {

using seg_reduce::ITEMS;
using seg_reduce::TILE;

constexpr int THREADS = 256;       // 8 warps a block
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ int from_bits(unsigned x, int) { return static_cast<int>(x); }
__device__ __forceinline__ float from_bits(unsigned x, float) { return __uint_as_float(x); }

// A chunk's 16 values as loaded: four bytes or one 4-byte value a word.
template <typename T>
struct RawVals {
  unsigned w[ITEMS * sizeof(T) / 4];
};

// 16-byte loads when vec (the chunk lies inside the lanes and the address is
// aligned), else lane by lane; lanes outside [0, n_lanes) read 0.
template <typename T>
__device__ __forceinline__ void load_vals(const T* __restrict__ vals, long long l0,
                                          long long n_lanes, bool vec, RawVals<T>& r) {
  constexpr int N = ITEMS * sizeof(T) / 4;
  if (vec && l0 >= 0 && l0 + ITEMS <= n_lanes) {
    const uint4* p = reinterpret_cast<const uint4*>(vals + l0);
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const uint4 q = __ldcs(p + k);
      r.w[4 * k] = q.x, r.w[4 * k + 1] = q.y, r.w[4 * k + 2] = q.z, r.w[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) r.w[k] = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long e = l0 + j;
      if (e < 0 || e >= n_lanes) continue;
      if constexpr (sizeof(T) == 1)
        r.w[j / 4] |= static_cast<unsigned>(vals[e]) << (8 * (j % 4));
      else
        r.w[j] = reinterpret_cast<const unsigned*>(vals)[e];
    }
  }
}

template <typename T, typename A>
__device__ __forceinline__ A lane_val(const RawVals<T>& r, int j) {
  if constexpr (sizeof(T) == 1)
    return static_cast<A>((r.w[j / 4] >> (8 * (j % 4))) & 0xffu);
  else
    return static_cast<A>(from_bits(r.w[j], T()));
}

// The work of tile t: the core's reduction onto out[0, n_rows); int32 sums
// add the crossing rows with atomicAdd, float32 sums write them to the carry
// slots (2 a tile).
template <typename T, typename A>
__device__ __forceinline__ void sum_tile(long long t, const seg_reduce::Chunk<RawVals<T>>& c,
                                         int n_rows, A* __restrict__ out,
                                         int* __restrict__ carry_rows,
                                         A* __restrict__ carry_vals) {
  A v[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) v[j] = lane_val<T, A>(c.extra, j);
  const auto carry = seg_reduce::reduce_tile<A>(c.rows, v, c.prev, c.next, n_rows,
                                                [&](int r, A total) { out[r] = total; });
  if ((threadIdx.x & 31) != 0) return;
  if constexpr (std::is_integral<A>::value) {  // int32: exact atomics
    if (carry.head_row >= 0) atomicAdd(out + carry.head_row, carry.head_val);
    if (carry.tail_row >= 0) atomicAdd(out + carry.tail_row, carry.tail_val);
  } else {
    carry_rows[2 * t] = carry.head_row;
    carry_vals[2 * t] = carry.head_val;
    carry_rows[2 * t + 1] = carry.tail_row;
    carry_vals[2 * t + 1] = carry.tail_val;
  }
}

// D = 1: warp tiles of one sequence of lanes walked grid-stride.
template <typename T, typename A, bool VEC>
__global__ void __launch_bounds__(THREADS)
reduce_d1_kernel(const T* __restrict__ vals, const int* __restrict__ seg,
                 long long n_lanes, int pad, long long n_tiles, seg_reduce::PlainKeys keys,
                 A* __restrict__ out, int* __restrict__ carry_rows,
                 A* __restrict__ carry_vals) {
  seg_reduce::walk_tiles<RawVals<T>>(
      seg, n_lanes, pad, n_tiles, keys, WARPS,
      [&](long long l0, RawVals<T>& r) { load_vals<T>(vals, l0, n_lanes, VEC, r); },
      [&](long long t, const seg_reduce::Chunk<RawVals<T>>& c) {
        sum_tile<T, A>(t, c, keys.n_rows, out, carry_rows, carry_vals);
      });
}

template <typename T, typename A, bool VEC>
void launch_d1(const T* vals, const int* seg, long long n_lanes, int pad, long long n_tiles,
               seg_reduce::PlainKeys keys, A* out, int* carry_rows, A* carry_vals,
               cudaStream_t stream) {
  auto kernel = reduce_d1_kernel<T, A, VEC>;
  const int blocks = seg_reduce::persistent_blocks(kernel, THREADS, 0, n_tiles);
  kernel<<<blocks, THREADS, 0, stream>>>(vals, seg, n_lanes, pad, n_tiles, keys, out,
                                         carry_rows, carry_vals);
}

// Rows: block b owns span b % spans of row b / spans (len lanes of ids in
// [0, v], v the sentinel) and sums it onto the row's v + 1 output ints.
template <typename T>
__global__ void __launch_bounds__(THREADS)
reduce_rows_kernel(const T* __restrict__ vals, const int* __restrict__ seg, int len, int v,
                   int spans, int* __restrict__ out) {
  const int r = blockIdx.x / spans;
  const long long lanes = static_cast<long long>(r) * len;
  const int* seg_r = seg + lanes;
  const T* vals_r = vals + lanes;
  const int pad = seg_reduce::pad_of(seg_r);
  long long t_begin, t_end;
  seg_reduce::span_of(blockIdx.x - r * spans, spans, seg_reduce::tiles_of(len, pad), t_begin,
                      t_end);
  if (t_begin == t_end) return;
  // values take 16-byte loads when their chunks start on the ids' 16-byte
  // boundary in this row, lane-by-lane loads otherwise
  const bool vec = (reinterpret_cast<uintptr_t>(vals_r) - sizeof(T) * pad) % 16 == 0;
  int* out_r = out + static_cast<long long>(r) * (v + 1);
  seg_reduce::walk_span<RawVals<T>>(
      seg_r, len, pad, t_begin, t_end, seg_reduce::PlainKeys{v}, WARPS, []() {},
      [&](long long l0, RawVals<T>& w) { load_vals<T>(vals_r, l0, len, vec, w); },
      [&](long long t, const seg_reduce::Chunk<RawVals<T>>& c) {
        sum_tile<T, int>(t, c, v, out_r, nullptr, nullptr);
      });
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
int launch(const void* vals_ptr, const void* seg_ptr, long long n_lanes, int n_rows, int d,
           void* out_ptr, void* scratch, void* stream_ptr) {
  if (n_rows <= 0 || d <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const T* vals = static_cast<const T*>(vals_ptr);
  const int* seg = static_cast<const int*>(seg_ptr);
  A* out = static_cast<A*>(out_ptr);
  if (d == 1) {
    const cudaError_t err = cudaMemsetAsync(out, 0, sizeof(A) * n_rows, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_lanes == 0) return static_cast<int>(cudaGetLastError());
    const int pad = seg_reduce::pad_of(seg);
    const long long n_tiles = seg_reduce::tiles_of(n_lanes, pad);
    // scratch (float32 sums only): carry rows [2 * n_tiles], then values
    int* carry_rows = static_cast<int*>(scratch);
    A* carry_vals = reinterpret_cast<A*>(carry_rows + 2 * n_tiles);
    // values take 16-byte loads when their chunks start on the ids' 16-byte
    // boundary, lane-by-lane loads otherwise
    const bool vec = (reinterpret_cast<uintptr_t>(vals) - sizeof(T) * pad) % 16 == 0;
    const seg_reduce::PlainKeys keys{n_rows};
    if (vec)
      launch_d1<T, A, true>(vals, seg, n_lanes, pad, n_tiles, keys, out, carry_rows,
                            carry_vals, stream);
    else
      launch_d1<T, A, false>(vals, seg, n_lanes, pad, n_tiles, keys, out, carry_rows,
                             carry_vals, stream);
    if constexpr (!std::is_integral<A>::value) {  // float32: add the carries in tile order
      const long long blocks = (n_tiles + THREADS - 1) / THREADS;
      seg_reduce::carry_f32_kernel<<<static_cast<int>(blocks < 8448 ? blocks : 8448),
                                     THREADS, 0, stream>>>(carry_rows, carry_vals, n_tiles,
                                                           out);
    }
    return static_cast<int>(cudaGetLastError());
  }
  // D > 1: scratch holds the row offsets [n_rows + 1]
  int* off = static_cast<int*>(scratch);
  row_offsets::launch(seg, n_lanes, n_rows, off, stream);
  const long long row_blocks = (static_cast<long long>(n_rows) + WARPS - 1) / WARPS;
  reduce_dn_kernel<T, A><<<static_cast<int>(row_blocks < 8448 ? row_blocks : 8448), THREADS,
                           0, stream>>>(vals, off, n_rows, d, out);
  return static_cast<int>(cudaGetLastError());
}

// Rows: values and seg [rows, len] (each row sorted by its own ids in [0, v])
// onto int32 out [rows, v + 1], the sentinel column v included: a memset
// and the row-local reduction, crossing rows added with atomicAdd. No
// scratch.
template <typename T>
int launch_rows(const void* vals_ptr, const void* seg_ptr, int rows, int len, int v,
                void* out_ptr, void* stream_ptr) {
  if (rows <= 0 || v < 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int* out = static_cast<int*>(out_ptr);
  const cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(int) * static_cast<long long>(rows) * (v + 1), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (len == 0) return static_cast<int>(cudaGetLastError());
  auto kernel = reduce_rows_kernel<T>;
  const int spans = seg_reduce::row_spans(kernel, THREADS, 0, rows,
                                          seg_reduce::tiles_of(len, 0), len);
  kernel<<<rows * spans, THREADS, 0, stream>>>(static_cast<const T*>(vals_ptr),
                                               static_cast<const int*>(seg_ptr), len, v, spans,
                                               out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch ints the caller must pass for n_lanes lanes onto n_rows rows of
// width d: the float32 carries at d = 1 (for any alignment of the ids), the
// row offsets at d > 1, none for int32 sums at d = 1.
extern "C" long long segsum_scratch_ints(long long n_lanes, int n_rows, int d,
                                         int float_sums) {
  if (d > 1) return static_cast<long long>(n_rows) + 1;
  return float_sums ? 4 * seg_reduce::tiles_of(n_lanes, 3) : 0;
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

// Row-batched int32 sums (K1 over rows): [rows, len] int32 or bool (one
// byte) values and int32 ids, each row ascending on its own, onto int32 out
// [rows, v + 1] (column v, the sentinel's, is to be dropped by the caller).
extern "C" int segsum_rows_i32(const void* vals, const void* seg, int rows, int len, int v,
                               void* out, void* stream) {
  return launch_rows<int>(vals, seg, rows, len, v, out, stream);
}

extern "C" int segsum_rows_u8(const void* vals, const void* seg, int rows, int len, int v,
                              void* out, void* stream) {
  return launch_rows<unsigned char>(vals, seg, rows, len, v, out, stream);
}

// The text of a CUDA error code, for the wrapper's exception.
extern "C" const char* segsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
