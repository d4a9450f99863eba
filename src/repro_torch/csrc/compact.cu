// Inclusive prefix sum (K3) and stream compaction (K4) for Hopper (sm_90a).
//
//   prefix_sum:      out[i] = x[0] + ... + x[i]      (int32 out)
//   stream_compact:  out = full(out_size, fill); out[pos[e] - 1] = values[e]
//                    for every live lane e with pos = prefix_sum(live) and
//                    pos[e] - 1 < out_size (overflow lanes drop)
//
// Replaces: src/repro/kernels/compact.py:prefix_sum (Pallas body
// _prefix_kernel, an upper-triangular MXU matmul per 512-lane tile with a
// scalar carry down a sequential grid, exact only below 2^24 because it
// sums in float32) and compact.py:stream_compact (K3, then K1 over the
// nondecreasing positions, again float32). Both carry the pruned peel's
// in-bucket compaction ladder (core/prune.py:_compact_edges, _staged_peel).
//
// What bounds them: memory. A scan reads each lane once and writes one int32
// per lane against one add, so the least time is bytes / 3.35 TB/s (41.9 MB,
// 12.5 us, for 8,388,608 bool lanes). The compaction reads the mask and the
// live lanes' values once and writes each output slot once.
//
// What the design does about it. Hopper's blocks run in any order, so the
// TPU kernel's carry down a sequential grid becomes three launches, each a
// pass at full memory width:
//
//   1. tile_sums: one block per TILE = 4,096 lanes, 16 consecutive lanes a
//      thread (one 16-byte load of bool lanes, read as bytes with no
//      conversion pass; four for int32), reduced to one sum per tile;
//   2. scan_tile_sums: one block turns the tile sums into exclusive tile
//      offsets (a loop of 1,024-wide block scans with a running carry);
//   3. scan_tiles: each block reloads its tile, scans each thread's 16
//      lanes in registers, scans the thread totals across the block with
//      warp shuffles, adds the tile offset and writes with 16-byte stores.
//
// Every sum is int32, so the scan is exact at any length below 2^31 lanes
// (the JAX kernel's float32 is exact only below 2^24). K4 is K3's scan
// followed by one scatter launch in which every output slot has exactly one
// writer: lane e with pos[e] - 1 = j < out_size writes slot j, and slots at
// or past the live count get `fill`. No atomics, so the output is
// deterministic, and survivors keep their lane order (a dst-sorted input
// stays dst-sorted). It does not go through K1 as the TPU version does: a
// segmented sum is the wrong tool for a permutation. A single-pass scan with
// decoupled look-back would save the second read of the input; that is later
// work.
//
// Launched on the caller's stream; nothing here allocates or synchronises:
// the caller passes the scratch (tile offsets and the total). Each C entry
// point returns cudaGetLastError() after its launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;                // 8 warps a block
constexpr int ITEMS = 16;                   // consecutive lanes a thread
constexpr int TILE = THREADS * ITEMS;       // 4,096 lanes a block
constexpr int SCAN_THREADS = 1024;          // the one block of phase 2
constexpr int SCATTER_BLOCKS = 132 * 16;    // grid-stride cap: 16 blocks an SM
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The ITEMS lanes of one thread, [i, i + ITEMS), as ints; lanes at or past
// n read as 0. i is a multiple of ITEMS, so whether the vector path applies
// depends only on the base pointer's alignment and the ragged end.
template <typename T> struct Lanes;

template <> struct Lanes<unsigned char> {  // bool lanes: one byte, 0 or 1
  __device__ static void load(const unsigned char* __restrict__ x, long long i,
                              long long n, int (&v)[ITEMS]) {
    if (i + ITEMS <= n && aligned16(x + i)) {
      const uint4 w = *reinterpret_cast<const uint4*>(x + i);
      const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int b = 0; b < 4; ++b) v[4 * k + b] = (words[k] >> (8 * b)) & 0xffu;
    } else {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) v[j] = i + j < n ? x[i + j] : 0;
    }
  }
};

template <> struct Lanes<int> {
  __device__ static void load(const int* __restrict__ x, long long i, long long n,
                              int (&v)[ITEMS]) {
    if (i + ITEMS <= n && aligned16(x + i)) {
      const int4* p = reinterpret_cast<const int4*>(x + i);
#pragma unroll
      for (int k = 0; k < ITEMS / 4; ++k) {
        const int4 w = p[k];
        v[4 * k] = w.x;
        v[4 * k + 1] = w.y;
        v[4 * k + 2] = w.z;
        v[4 * k + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) v[j] = i + j < n ? x[i + j] : 0;
    }
  }
};

__device__ __forceinline__ int warp_inclusive(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// Exclusive prefix of x over the NT threads of the block; `total` gets the
// block's sum. `ws` is shared scratch of NT / 32 + 1 ints. Every thread of
// the block must call it; it ends with a barrier, so ws may be reused.
template <int NT>
__device__ __forceinline__ int block_exclusive(int x, int* ws, int& total) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inc = warp_inclusive(x);
  if (lane == 31) ws[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < NW ? ws[lane] : 0;
    const int winc = warp_inclusive(w);
    if (lane < NW) ws[lane] = winc - w;
    if (lane == NW - 1) ws[NW] = winc;
  }
  __syncthreads();
  const int excl = ws[warp] + inc - x;
  total = ws[NW];
  __syncthreads();
  return excl;
}

// Phase 1: one sum per tile.
template <typename T>
__global__ void __launch_bounds__(THREADS)
tile_sums_kernel(const T* __restrict__ x, long long n, int* __restrict__ sums) {
  __shared__ int ws[THREADS / 32 + 1];
  const long long i = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x * ITEMS;
  int v[ITEMS];
  Lanes<T>::load(x, i, n, v);
  int s = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) s += v[j];
  int total;
  block_exclusive<THREADS>(s, ws, total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// Phase 2: tile sums -> exclusive tile offsets, in place; the grand total
// goes to *total.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_tile_sums_kernel(int* __restrict__ sums, int n_tiles, int* __restrict__ total) {
  __shared__ int ws[SCAN_THREADS / 32 + 1];
  int carry = 0;
  for (int base = 0; base < n_tiles; base += SCAN_THREADS) {
    const int t = base + static_cast<int>(threadIdx.x);
    const int x = t < n_tiles ? sums[t] : 0;
    int chunk;
    const int ex = block_exclusive<SCAN_THREADS>(x, ws, chunk);
    if (t < n_tiles) sums[t] = carry + ex;
    carry += chunk;
  }
  if (threadIdx.x == 0) *total = carry;
}

// Phase 3: the scan of each tile plus its offset.
template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_tiles_kernel(const T* __restrict__ x, long long n, const int* __restrict__ offsets,
                  int* __restrict__ out) {
  __shared__ int ws[THREADS / 32 + 1];
  const long long i = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x * ITEMS;
  int v[ITEMS];
  Lanes<T>::load(x, i, n, v);
#pragma unroll
  for (int j = 1; j < ITEMS; ++j) v[j] += v[j - 1];  // inclusive, in registers
  int total;
  const int base = offsets[blockIdx.x] + block_exclusive<THREADS>(v[ITEMS - 1], ws, total);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) v[j] += base;
  if (i + ITEMS <= n && aligned16(out + i)) {
    int4* p = reinterpret_cast<int4*>(out + i);
#pragma unroll
    for (int k = 0; k < ITEMS / 4; ++k)
      p[k] = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (i + j < n) out[i + j] = v[j];
  }
}

template <typename T>
int scan(const void* x, long long n, void* out, void* scratch, void* stream_ptr) {
  if (n <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n_tiles = (n + TILE - 1) / TILE;
  // scratch: tile offsets [n_tiles], total [1]
  int* offsets = static_cast<int*>(scratch);
  int* total = offsets + n_tiles;
  const T* xs = static_cast<const T*>(x);
  tile_sums_kernel<T><<<static_cast<unsigned>(n_tiles), THREADS, 0, stream>>>(xs, n, offsets);
  scan_tile_sums_kernel<<<1, SCAN_THREADS, 0, stream>>>(offsets, static_cast<int>(n_tiles),
                                                        total);
  scan_tiles_kernel<T><<<static_cast<unsigned>(n_tiles), THREADS, 0, stream>>>(
      xs, n, offsets, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K4's scatter: one writer per output slot. Lane e, live with j = pos[e] - 1
// < out_size, copies its d values to row j; rows from the live count (pos[n -
// 1], clipped to out_size) onwards get `fill`.
__global__ void __launch_bounds__(THREADS)
compact_scatter_kernel(const int* __restrict__ values, int d,
                       const unsigned char* __restrict__ live,
                       const int* __restrict__ pos, long long n, long long out_size,
                       int fill, int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  for (long long e = first; e < n; e += stride) {
    if (!live[e]) continue;
    const long long j = static_cast<long long>(pos[e]) - 1;
    if (j >= out_size) continue;  // overflow lanes drop
    for (int c = 0; c < d; ++c) out[j * d + c] = values[e * d + c];
  }
  const long long n_live = n > 0 ? static_cast<long long>(pos[n - 1]) : 0;
  const long long kept = n_live < out_size ? n_live : out_size;
  for (long long s = kept * d + first; s < out_size * d; s += stride) out[s] = fill;
}

}  // namespace

// Scratch ints the caller passes for a scan of n lanes.
extern "C" long long compact_scratch_ints(long long n) {
  return (n + TILE - 1) / TILE + 1;
}

// Inclusive scan of bool (one byte, 0 or 1) lanes, int32 out.
extern "C" int prefix_sum_u8(const void* x, long long n, void* out, void* scratch,
                             void* stream) {
  return scan<unsigned char>(x, n, out, scratch, stream);
}

// Inclusive scan of int32 lanes, int32 out (wrapping as int32 does).
extern "C" int prefix_sum_i32(const void* x, long long n, void* out, void* scratch,
                              void* stream) {
  return scan<int>(x, n, out, scratch, stream);
}

// Compaction of int32 rows [n, d] under the bool mask `live`, with `pos`
// the inclusive scan of `live` (K3's output; unread when n == 0), into
// out [out_size, d].
extern "C" int stream_compact_i32(const void* values, int d, const void* live,
                                  const void* pos, long long n, long long out_size,
                                  int fill, void* out, void* stream_ptr) {
  if (out_size <= 0 || d <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long work = n > out_size * d ? n : out_size * d;
  const long long blocks = (work + THREADS - 1) / THREADS;
  compact_scatter_kernel<<<static_cast<unsigned>(blocks < SCATTER_BLOCKS ? blocks
                                                                         : SCATTER_BLOCKS),
                           THREADS, 0, stream>>>(
      static_cast<const int*>(values), d, static_cast<const unsigned char*>(live),
      static_cast<const int*>(pos), n, out_size, fill, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The text of a CUDA error code, for the wrapper's exception.
extern "C" const char* compact_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
