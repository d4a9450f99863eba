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
// What the design does about it. Hopper's blocks run in any order, so K3
// turns the TPU kernel's carry down a sequential grid into three launches,
// each a pass at full memory width:
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
// (the JAX kernel's float32 is exact only below 2^24).
//
// K4 does not go through K3 or K1 (a segmented sum is the wrong tool for a
// permutation): it is one pass over the mask with decoupled look-back, so
// the mask is read once and no position array is written. Blocks take 4,096-
// lane tiles in order from a ticket counter, count their live lanes,
// publish the count, learn the live lanes before them from their
// predecessors' published counts, and copy their live lanes' rows, reading
// `values` only for live lanes, to consecutive output slots. Every output
// slot has exactly one writer: no atomics on the output, so it is
// deterministic, and survivors keep their lane order (a dst-sorted input
// stays dst-sorted). Lanes past out_size drop. The fill tail [live count,
// out_size) is written by the kernel's own blocks once the last tile has
// published the total: each block, when no tile is left, waits for it and
// fills a grid-stride share, so no block writes the whole tail and no second
// launch is needed. The tile status words and the ticket start at zero:
// the caller passes them and the C entry point zeroes them with one
// cudaMemsetAsync on the same stream, so calls on two streams never share
// them.
//
// Launched on the caller's stream; nothing here allocates or synchronises:
// the caller passes the scratch (K3's tile offsets and total, K4's status
// words). Each C entry point returns cudaGetLastError() after its launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;                // 8 warps a block
constexpr int ITEMS = 16;                   // consecutive lanes a thread
constexpr int TILE = THREADS * ITEMS;       // 4,096 lanes a block
constexpr int SCAN_THREADS = 1024;          // the one block of phase 2
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

// K4: one pass with decoupled look-back (Merrill and Garland, "Single-pass
// parallel prefix scan with decoupled look-back", 2016). A tile's status
// word holds a flag in its high half and a count in its low half: the tile's
// own live count (AGGREGATE) as soon as the tile is loaded, then the live
// count of every lane up to its end (INCLUSIVE) once its look-back is done.
constexpr unsigned long long AGGREGATE = 1ull << 32;
constexpr unsigned long long INCLUSIVE = 2ull << 32;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long flag,
                                             int count) {
  *reinterpret_cast<volatile unsigned long long*>(p) = flag | static_cast<unsigned>(count);
}

// The live lanes before `tile`: warp 0 reads the status of the 32 tiles
// before it at once, waits until each has published, adds the counts up to
// the nearest INCLUSIVE one, and moves 32 tiles back while there is none.
// Tile 0 publishes INCLUSIVE at once, so the walk ends. Every lane of warp 0
// calls it and gets the sum.
__device__ int look_back(const unsigned long long* status, int tile) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int top = tile - 1;; top -= 32) {
    const int k = top - lane;
    unsigned long long s = k >= 0 ? load_status(status + k) : INCLUSIVE;
    while (__any_sync(FULL, (s >> 32) == 0)) {
      if ((s >> 32) == 0) {
        __nanosleep(32);
        s = load_status(status + k);
      }
    }
    const unsigned inclusive = __ballot_sync(FULL, (s >> 32) == 2);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    int x = lane <= stop ? static_cast<int>(static_cast<unsigned>(s)) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
    excl += x;
    if (inclusive) return excl;
  }
}

// Each block takes tiles in order from a ticket counter, so a tile's
// predecessors are all held by running blocks and the look-back never waits
// on a block that has not started. For each tile: one 16-byte load of the
// mask a thread, a block scan of the counts, AGGREGATE published, the tile's
// live lanes listed in shared memory in lane order, the look-back (warp 0),
// INCLUSIVE published, then the live lanes' rows copied to out[excl + k]
// with consecutive threads on consecutive slots. When no tile is left, the
// block waits for the last tile's INCLUSIVE count (every tile is then held
// by a running block) and fills its share of the slots from the live count
// to out_size.
__global__ void __launch_bounds__(THREADS)
compact_kernel(const int* __restrict__ values, int d, const unsigned char* __restrict__ live,
               long long n, long long out_size, int fill, int* __restrict__ out,
               unsigned long long* status, unsigned int* ticket, int n_tiles) {
  __shared__ unsigned short lanes[TILE];  // the tile's live lanes, in order
  __shared__ int ws[THREADS / 32 + 1];
  __shared__ int s_tile, s_excl;
  const bool pairs = d == 2 && reinterpret_cast<uintptr_t>(values) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 8 == 0;
  for (;;) {
    if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(ticket, 1u));
    __syncthreads();
    const int tile = s_tile;
    if (tile >= n_tiles) break;
    const long long base = static_cast<long long>(tile) * TILE;
    int v[ITEMS];
    Lanes<unsigned char>::load(live, base + threadIdx.x * ITEMS, n, v);
    int count = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) count += v[j];
    int agg;
    int at = block_exclusive<THREADS>(count, ws, agg);
    if (threadIdx.x == 0) store_status(status + tile, tile == 0 ? INCLUSIVE : AGGREGATE, agg);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (v[j]) lanes[at++] = static_cast<unsigned short>(threadIdx.x * ITEMS + j);
    if (threadIdx.x < 32) {
      const int excl = tile == 0 ? 0 : look_back(status, tile);
      if (threadIdx.x == 0) {
        if (tile != 0) store_status(status + tile, INCLUSIVE, excl + agg);
        s_excl = excl;
      }
    }
    __syncthreads();
    const long long excl = s_excl;
    const long long end = min(static_cast<long long>(agg), out_size - excl);  // drop overflow
    for (long long k = threadIdx.x; k < end; k += THREADS) {
      const long long e = base + lanes[k], slot = excl + k;
      if (pairs) {
        reinterpret_cast<int2*>(out)[slot] = __ldg(reinterpret_cast<const int2*>(values) + e);
      } else {
        for (int c = 0; c < d; ++c) out[slot * d + c] = __ldg(values + e * d + c);
      }
    }
    __syncthreads();  // lanes, s_tile and s_excl are reused
  }
  __shared__ long long s_kept;
  if (threadIdx.x == 0) {
    long long total = 0;
    if (n_tiles > 0) {
      unsigned long long s;
      while (((s = load_status(status + n_tiles - 1)) >> 32) != 2) __nanosleep(64);
      total = static_cast<unsigned>(s);
    }
    s_kept = total < out_size ? total : out_size;
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long s = s_kept * d + blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
       s < out_size * d; s += stride)
    out[s] = fill;
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

// Lanes a K4 tile: the caller passes one 8-byte status word a tile and one
// for the ticket counter.
extern "C" int compact_tile_lanes() { return TILE; }

// Compaction of int32 rows [n, d] under the bool mask `live` into out
// [out_size, d]. `status` holds ceil(n / TILE) + 1 8-byte words; they are
// zeroed here, on the stream, before the kernel (one memset, one
// kernel launch).
extern "C" int stream_compact_i32(const void* values, int d, const void* live, long long n,
                                  long long out_size, int fill, void* out, void* status,
                                  void* stream_ptr) {
  if (out_size <= 0 || d <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n_tiles = (n + TILE - 1) / TILE;
  cudaError_t err = cudaMemsetAsync(status, 0, (n_tiles + 1) * 8, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // every tile, or enough blocks to fill the output in a few strides, at most
  // what the card holds at once (2,048 threads an SM)
  const long long fill_blocks = (out_size * d + THREADS * ITEMS - 1) / (THREADS * ITEMS);
  long long blocks = n_tiles > fill_blocks ? n_tiles : fill_blocks;
  const long long resident = static_cast<long long>(sms) * (2048 / THREADS);
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  auto* words = static_cast<unsigned long long*>(status);
  compact_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const int*>(values), d, static_cast<const unsigned char*>(live), n, out_size,
      fill, static_cast<int*>(out), words, reinterpret_cast<unsigned int*>(words + n_tiles),
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// The text of a CUDA error code, for the wrapper's exception.
extern "C" const char* compact_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
