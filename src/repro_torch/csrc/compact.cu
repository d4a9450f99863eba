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
// TPU kernel's carry down a sequential grid becomes decoupled look-back
// (Merrill and Garland, "Single-pass parallel prefix scan with decoupled
// look-back", 2016), and both kernels are one pass over their input:
//
// K3 is one launch after one memset. Each block of 512 threads takes the
// next tile of 8,192 lanes from a ticket counter, 16 consecutive lanes a thread
// (one 16-byte load of bool lanes, read as bytes with no conversion pass;
// four for int32), scans each thread's 16 lanes in registers and the thread
// totals across the block with warp shuffles, publishes the tile's sum
// (AGGREGATE), stages its sums in shared memory (swizzled, so neither the
// stores nor the reads conflict on a bank) while warp 0 learns the sum of
// every lane before the tile from its predecessors' status words (the
// look-back), publishes the running total (INCLUSIVE), and writes each
// int32 once, consecutive threads on consecutive 16-byte words. The input
// is read once; no tile sums go through memory and no block scans them
// alone. Every sum is int32, so the scan is exact at any length below 2^31
// lanes (the JAX kernel's float32 is exact only below 2^24). What keeps it
// off its bound is the look-back's wait, which holds each block's slot:
// scan_ceiling_u8 runs the same pass without it to measure that.
//
// K4 does not go through K3 or K1 (a segmented sum is the wrong tool for a
// permutation): it is the same look-back over the mask, so the mask is read
// once and no position array is written. Blocks take 4,096-lane tiles in
// order from a ticket counter, count their live lanes, publish the count,
// learn the live lanes before them from their predecessors' published
// counts, and copy their live lanes' rows, reading `values` only for live
// lanes, to consecutive output slots. Every output slot has exactly one
// writer: no atomics on the output, so it is deterministic, and survivors
// keep their lane order (a dst-sorted input stays dst-sorted). Lanes past
// out_size drop. The fill tail [live count, out_size) is written by the
// kernel's own blocks once the last tile has published the total: each
// block, when no tile is left, waits for it and fills a grid-stride share,
// so no block writes the whole tail and no second launch is needed.
//
// Both kernels take tiles in ticket order, so a tile's predecessors are all
// held by blocks that have started and the look-back never waits on a block
// that has not. Their tile status words and the ticket start at zero: the
// caller passes them and the C entry point zeroes them with one
// cudaMemsetAsync on the same stream, so calls on two streams, or back to
// back, never share them.
//
// Launched on the caller's stream; nothing here allocates or synchronises.
// Each C entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;                // 8 warps a K4 block
constexpr int ITEMS = 16;                   // consecutive lanes a thread
constexpr int TILE = THREADS * ITEMS;       // 4,096 lanes a K4 block
constexpr int SCAN_THREADS = 512;           // 16 warps a K3 block
constexpr int SCAN_TILE = SCAN_THREADS * ITEMS;  // 8,192 lanes a K3 block
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

// The look-back of K3 and K4. A tile's status word holds a flag in its high
// half and a sum in its low half (an int32's bits): the tile's own sum (K3)
// or live count (K4) as AGGREGATE as soon as the tile is loaded, then the
// sum over every lane up to its end (INCLUSIVE) once its look-back is done.
// The sum and its flag are one 8-byte word, so a reader never sees one
// without the other and no fence is needed.
constexpr unsigned long long AGGREGATE = 1ull << 32;
constexpr unsigned long long INCLUSIVE = 2ull << 32;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long flag,
                                             int count) {
  *reinterpret_cast<volatile unsigned long long*>(p) = flag | static_cast<unsigned>(count);
}

// The sum over the lanes before `tile`: warp 0 reads the status of the 32 tiles
// before it at once, waits until each has published, adds the counts up to
// the nearest INCLUSIVE one, and moves 32 tiles back while there is none.
// Tile 0 publishes INCLUSIVE at once, so the walk ends. Every lane of warp 0
// calls it and gets the sum. int32 sums wrap as int32 does.
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

// K3. The thread's 16 sums are staged in shared memory as 4 int4 words,
// word k of thread t at t * 4 + (k ^ ((t >> 1) & 3)): each quarter warp's
// 16-byte stores then cover all 32 banks once, and so do the reads of 8
// consecutive words that feed the coalesced stores to `out`.
__device__ __forceinline__ int staged_word(int q) {  // int4 word q of the tile
  const int owner = q >> 2;
  return owner * 4 + ((q & 3) ^ ((owner >> 1) & 3));
}

// One block a tile, its tile from the ticket (grid = n_tiles): the loaded
// lanes scanned in registers, then across the block, AGGREGATE published,
// the sums staged, the look-back (warp 0), INCLUSIVE published, and the
// tile's int32s written once each with the tile's offset added. Blocks of
// 512 threads held to 32 registers, so 4 fit an SM: the look-back stalls a
// block, and more blocks in flight hide more of it. LOOK_BACK false is a
// diagnostic, not a scan: each tile's sums without its offset, the same
// traffic with no wait, which shows what the look-back costs.
template <typename T, bool LOOK_BACK = true>
__global__ void __launch_bounds__(SCAN_THREADS, 4)
scan_kernel(const T* __restrict__ x, long long n, int* __restrict__ out,
            unsigned long long* status, unsigned int* ticket) {
  __shared__ int4 staged[SCAN_TILE / 4];
  __shared__ int ws[SCAN_THREADS / 32 + 1];
  __shared__ int s_tile, s_excl;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int tile = s_tile;
  const long long base = static_cast<long long>(tile) * SCAN_TILE;
  int v[ITEMS];
  Lanes<T>::load(x, base + threadIdx.x * ITEMS, n, v);
#pragma unroll
  for (int j = 1; j < ITEMS; ++j) v[j] += v[j - 1];  // inclusive, in registers
  int agg;
  const int at = block_exclusive<SCAN_THREADS>(v[ITEMS - 1], ws, agg);
  if (threadIdx.x == 0) store_status(status + tile, tile == 0 ? INCLUSIVE : AGGREGATE, agg);
#pragma unroll
  for (int k = 0; k < ITEMS / 4; ++k)
    staged[staged_word(threadIdx.x * 4 + k)] =
        make_int4(v[4 * k] + at, v[4 * k + 1] + at, v[4 * k + 2] + at, v[4 * k + 3] + at);
  if (threadIdx.x < 32) {
    const int excl = tile == 0 || !LOOK_BACK ? 0 : look_back(status, tile);
    if (threadIdx.x == 0) {
      if (tile != 0) store_status(status + tile, INCLUSIVE, excl + agg);
      s_excl = excl;
    }
  }
  __syncthreads();
  const int excl = s_excl;
  int* o = out + base;
  const long long m = n - base < SCAN_TILE ? n - base : SCAN_TILE;
  if (m == SCAN_TILE && aligned16(o)) {
#pragma unroll
    for (int r = 0; r < SCAN_TILE / 4 / SCAN_THREADS; ++r) {
      const int q = r * SCAN_THREADS + threadIdx.x;
      const int4 w = staged[staged_word(q)];
      reinterpret_cast<int4*>(o)[q] = make_int4(w.x + excl, w.y + excl, w.z + excl, w.w + excl);
    }
  } else {  // the ragged last tile, or an out that is not 16-byte aligned
    const int* words = reinterpret_cast<const int*>(staged);
    for (int i = threadIdx.x; i < m; i += SCAN_THREADS)
      o[i] = words[staged_word(i >> 2) * 4 + (i & 3)] + excl;
  }
}

// K4. Each block takes tiles in order from the ticket, in a loop, because
// its blocks also write the fill tail. For each tile: one 16-byte load of the
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

template <typename T, bool LOOK_BACK = true>
int scan(const void* x, long long n, void* out, void* status, cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long n_tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  cudaError_t err = cudaMemsetAsync(status, 0, (n_tiles + 1) * 8, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* words = static_cast<unsigned long long*>(status);
  scan_kernel<T, LOOK_BACK><<<static_cast<unsigned>(n_tiles), SCAN_THREADS, 0, stream>>>(
      static_cast<const T*>(x), n, static_cast<int*>(out), words,
      reinterpret_cast<unsigned int*>(words + n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inclusive scan of bool (one byte, 0 or 1) lanes, int32 out. `status` holds
// ceil(n / SCAN_TILE) + 1 8-byte words (a tile's status each, then the
// ticket), which ceil(n / TILE) + 1 covers; they are zeroed here, on the
// stream, before the kernel (one memset, one kernel launch).
extern "C" int prefix_sum_u8(const void* x, long long n, void* out, void* status,
                             void* stream) {
  return scan<unsigned char>(x, n, out, status, static_cast<cudaStream_t>(stream));
}

// Inclusive scan of int32 lanes, int32 out (wrapping as int32 does); `status`
// as for prefix_sum_u8.
extern "C" int prefix_sum_i32(const void* x, long long n, void* out, void* status,
                              void* stream) {
  return scan<int>(x, n, out, status, static_cast<cudaStream_t>(stream));
}

// The diagnostic pass of K3 over bool lanes: the same memset, loads and
// stores with no look-back, so each tile's sums lack their offset. Its time
// is what K3 would take if the look-back cost nothing.
extern "C" int scan_ceiling_u8(const void* x, long long n, void* out, void* status,
                               void* stream) {
  return scan<unsigned char, false>(x, n, out, status, static_cast<cudaStream_t>(stream));
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
