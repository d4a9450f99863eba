// The peel's fused edge stage (K2) for Hopper (sm_90a). Over the symmetric
// COO lanes src, dst (int32 [E], sorted by dst, the sentinel n sorting last)
// with vertex masks active and failed (bool [n]), per lane
//
//     valid = src < n & dst < n
//     live  = valid & active[src] & active[dst]
//     fs    = failed[src] & live,   fd = failed[dst] & live
//
// and it writes
//
//     delta[v]  = sum over lanes with dst == v of fs                (int32 [n])
//     removed   = sum over all lanes of (fs | fd)                   (int32)
//     inc[v]    = sum over lanes with dst == v of fd & (!fs | dst < src)
//                                                (int32 [n], with charge only)
//
// active null means every vertex is live: delta is then the JAX package's
// peel_update. Ids below 0 count as invalid.
//
// Replaces: src/repro/kernels/ops.py:peel_update (_peel_update_jit, which
// reaches the Pallas segment-sum K1 at ops.py:200), and with it the edge
// stage that the JAX package's peel bodies (core/pbahmani.py:pbahmani_pass,
// core/kcore.py:_level_fixpoint, refine/loads.py:refine_pass) compute around
// K1 and XLA fuses into one loop; eager PyTorch would launch each of its
// ops over all lanes and write every intermediate mask to device memory.
//
// What bounds it: memory. Each lane's src and dst are read once (8 bytes);
// the vertex masks (2 bytes a vertex) and the outputs are small beside them:
// 37.8 us at the main path's shape (15.5 M lanes) at 3.35 TB/s.
//
// What the design does about it: one pass of the segmented-reduction core of
// seg_reduce.cuh with a lane prologue in place of K1's value load. Two
// launches:
//
//   1. pack: (active, failed) become 2 bits a vertex, 16 vertices a word
//      (128 KB at n = 524,288), and the outputs are zeroed.
//   2. peel: persistent blocks. When the packed words fit in shared memory
//      (up to smem_max_bytes), one block of 1,024 threads an SM copies them
//      there once, so every lane's gather of its src's state is a
//      shared-memory read (a gather through L1 costs about a cycle for each
//      distinct line a warp touches, a shared-memory read a few bank
//      conflicts); above that, blocks of 512 threads read the words through
//      L1/L2. Each thread loads 16 dst and 16 src with 16-byte loads, reads
//      the dst's state once a run (dst is constant along a run), and forms
//      each lane's value: fs in the low 16 bits and the charge in the high
//      16 (a warp tile holds 512 lanes, so neither field can carry into the
//      other). The core sums runs in registers and across the warp; rows
//      that cross a tile edge are added with atomicAdd (integers, exact in
//      any order); removed is summed per warp and added once a warp.
//
// Rows (peel_edges_rows): G independent peels in one launch, the fused
// tenants' batched passes. It replaces K2 under the JAX package's vmap
// (src/repro/stream/delta.py:481 _batched_warm_peel_jit, core/prune.py:533
// _batched_bucket_peel_jit and refine/loads.py:211 _batched_refine_round_jit,
// whose pass bodies reach the Pallas K1 at kernels/segsum.py:118 with a batch
// grid axis). src and dst are [G, L], each row dst-sorted on its own; the
// masks are [G, V]; delta and inc are written as [G, V + 1] (the sentinel
// column stays 0), removed as [G]. Bound by the same bytes as one pass over
// G * L lanes. One memset of the outputs, then one launch of row-local
// blocks (peel_rows_kernel on seg_reduce.cuh's walk_span):
//
//   * A block owns a span of whole tiles of one row r (G x S blocks, S from
//     seg_reduce::row_spans), so it runs the one-row pass on that row's own
//     lanes and pointers: plain keys, no row arithmetic a lane, r's 16-byte
//     alignment pad its own (L may be odd), outputs offset by r * (V + 1),
//     removed[r] summed over the block and added with one atomicAdd. A span
//     that starts in the row's sentinel tail returns at once.
//   * The block packs row r's active/failed bytes (2V bytes, L2-resident
//     after the row's first block) into 2 bits a vertex in its own shared
//     memory (V/4 bytes: 4 KB at V = 16,384), so every src lookup is a
//     shared-memory read and no pack launch is needed. Above smem_max_bytes
//     of packed row the lookups read the two bytes through L1/L2 instead
//     (still row-local: an SM caches only its rows). Spans are at least V/2
//     lanes long once every SM has a block, so the pack's reads stay at most
//     half the block's lane bytes.
//   * The lookups, not the bytes, set the pace of the lane prologue, so the
//     rows tile has its own (peel_rows_tile): no lookup branches, the dst
//     states from a two-word window in registers, bit operations. 512-thread
//     blocks, two an SM at 64 registers with the state in shared memory.
//   * What is left is the arithmetic of the shared core's tile reduction,
//     whose time adds to the loads' rather than hiding under them. Staging
//     a warp's next tile in shared memory by cp.async, or prefetching it
//     into L2, measured slower or no faster on the H100 (the staging costs
//     registers, and the batched passes find their lanes in L2).
//
// Launched on the caller's stream; it neither allocates nor synchronises:
// the caller passes one int32 buffer (peel_buffer_ints, peel_rows_buffer_ints)
// that holds the outputs (and, for one row, the packed words). The C entry
// points return cudaGetLastError() after their launches.

#include <cstdint>
#include <cuda_runtime.h>

#include "seg_reduce.cuh"

namespace {

using seg_reduce::FULL;
using seg_reduce::ITEMS;
using seg_reduce::TILE;

constexpr int PACK_THREADS = 256;
// Threads a block of the peel launch: with the state in shared memory one
// block fills an SM (32 warps beside 128 KB of state); through L1/L2 two
// blocks of 16 warps do (measured faster than one of 32 on the H100).
template <bool SMEM>
__host__ __device__ constexpr int threads_of() {
  return SMEM ? 1024 : 512;
}
// Threads a block of the rows launch, and the blocks an SM must hold: two
// with the row's state in shared memory (64 registers a thread), one when it
// is read through L1/L2 (whose charge variant spills at 64). Measured on the
// H100 against 256 and 384 threads and other register caps: the fastest
// without spills at 16 and 32 rows of 131,072 lanes.
constexpr int ROW_THREADS = 512;
template <bool SMEM>
__host__ __device__ constexpr int row_min_blocks() {
  return SMEM ? 2 : 1;
}

// Buffer layout (int32): delta [n] | removed [1] | inc [n] (charge only) |
// packed words, 16-byte aligned.
long long words_offset(long long n, bool charge) {
  const long long outs = n + 1 + (charge ? n : 0);
  return (outs + 3) / 4 * 4;
}

long long n_words_of(long long n) { return (n + 15) / 16; }

// Word w: bit 2i is active[16w + i], bit 2i + 1 failed[16w + i]. Also zeroes
// the n_zero output ints in front of the words.
__global__ void __launch_bounds__(PACK_THREADS)
pack_kernel(const unsigned char* __restrict__ active, const unsigned char* __restrict__ failed,
            long long n, unsigned* __restrict__ words, long long n_words, int* __restrict__ zero,
            long long n_zero) {
  const long long stride = static_cast<long long>(gridDim.x) * PACK_THREADS;
  const long long count = n_words > n_zero ? n_words : n_zero;
  for (long long i = blockIdx.x * static_cast<long long>(PACK_THREADS) + threadIdx.x;
       i < count; i += stride) {
    if (i < n_words) {
      unsigned w = 0;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const long long v = 16 * i + k;
        if (v < n) {
          const unsigned a = active ? (active[v] & 1u) : 1u;
          w |= (a | (failed[v] & 1u) << 1) << (2 * k);
        }
      }
      words[i] = w;
    }
    if (i < n_zero) zero[i] = 0;
  }
}

// Four 0/1 bytes (vertices 0-3 of x) onto bits 0, 2, 4, 6.
__device__ __forceinline__ unsigned spread4(unsigned x) {
  x &= 0x01010101u;
  return (x | x >> 6 | x >> 12 | x >> 18) & 0x55u;
}

// Sixteen 0/1 bytes onto the even bits of a word.
__device__ __forceinline__ unsigned spread16(uint4 q) {
  return spread4(q.x) | spread4(q.y) << 8 | spread4(q.z) << 16 | spread4(q.w) << 24;
}

// Words of a row's packed state in the rows kernel: vertices [0, n) and zero
// words through vertex n / 16 * 16 + 31, so that vertex n (every id the
// kernel clamps) reads as 0 and a two-word window from any vertex's word
// stays inside.
__host__ __device__ constexpr int row_words_of(int n) { return n / 16 + 2; }

// One row's state packed by the whole block into words[0, row_words_of(n))
// (the layout of pack_kernel, 0 from vertex n on): 16-byte loads of both
// masks where they are 16-byte aligned, byte loads otherwise.
__device__ __forceinline__ void pack_row(const unsigned char* __restrict__ active,
                                         const unsigned char* __restrict__ failed, int n,
                                         unsigned* __restrict__ words) {
  const int n_words = row_words_of(n);
  const bool vec = reinterpret_cast<uintptr_t>(failed) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(active) % 16 == 0;
  for (int w = threadIdx.x; w < n_words; w += ROW_THREADS) {
    unsigned a = 0, f = 0;
    if (vec && 16 * w + 16 <= n) {
      f = spread16(__ldg(reinterpret_cast<const uint4*>(failed) + w));
      a = active ? spread16(__ldg(reinterpret_cast<const uint4*>(active) + w)) : 0x55555555u;
    } else {
      for (int i = 0; i < 16 && 16 * w + i < n; ++i) {
        a |= (active ? active[16 * w + i] & 1u : 1u) << (2 * i);
        f |= (failed[16 * w + i] & 1u) << (2 * i);
      }
    }
    words[w] = a | f << 1;
  }
}

struct Src {  // a chunk's 16 src ids as loaded
  int s[ITEMS];
};

__device__ __forceinline__ unsigned state_of(const unsigned* st, int v) {
  return (st[v >> 4] >> ((v & 15) * 2)) & 3u;
}

// A chunk's 16 src ids: four 16-byte loads when vec and the chunk lies
// inside the lanes, else lane by lane (-1 outside them).
__device__ __forceinline__ void load_src(const int* __restrict__ src, long long l0,
                                         long long n_lanes, bool vec, Src& r) {
  if (vec && l0 >= 0 && l0 + ITEMS <= n_lanes) {
    const int4* p = reinterpret_cast<const int4*>(src + l0);
#pragma unroll
    for (int k = 0; k < ITEMS / 4; ++k) {
      const int4 q = __ldcs(p + k);
      r.s[4 * k] = q.x, r.s[4 * k + 1] = q.y, r.s[4 * k + 2] = q.z, r.s[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long e = l0 + j;
      r.s[j] = e >= 0 && e < n_lanes ? src[e] : -1;
    }
  }
}

// A tile's lane values (fs in the low 16 bits, the charge in the high 16)
// summed by the core: rows inside the tile stored, the crossing rows added
// with atomicAdd.
template <bool CHARGE>
__device__ __forceinline__ void sum_tile(const seg_reduce::Chunk<Src>& c, const int (&v)[ITEMS],
                                         int n, int* __restrict__ delta,
                                         int* __restrict__ inc) {
  const auto carry = seg_reduce::reduce_tile<int>(c.rows, v, c.prev, c.next, n,
                                                  [&](int r, int total) {
                                                    delta[r] = total & 0xffff;
                                                    if (CHARGE) inc[r] = total >> 16;
                                                  });
  if ((threadIdx.x & 31) == 0) {
    const int rows[2] = {carry.head_row, carry.tail_row};
    const int vals[2] = {carry.head_val, carry.tail_val};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (rows[k] < 0) continue;
      if (vals[k] & 0xffff) atomicAdd(delta + rows[k], vals[k] & 0xffff);
      if (CHARGE && (vals[k] >> 16)) atomicAdd(inc + rows[k], vals[k] >> 16);
    }
  }
}

// The work of one tile of one row of n vertices (the one-row kernel's, and
// the rows kernel's with the state through L1/L2): the lane prologue (an
// invalid end has state 0, so it is never live), then sum_tile. state(v)
// gives vertex v's 2 bits. Returns this thread's count of dead lanes.
template <bool CHARGE, typename State>
__device__ __forceinline__ int peel_tile(const seg_reduce::Chunk<Src>& c, int n,
                                         const State& state, int* __restrict__ delta,
                                         int* __restrict__ inc) {
  const int (&id)[ITEMS] = c.rows;
  int v[ITEMS];
  unsigned ds = 0;
  int d = -1, dead = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int k = id[j];
    if (j == 0 || k != id[j - 1]) {
      d = k;
      ds = k >= 0 && k < n ? state(k) : 0u;
    }
    const int sj = c.extra.s[j];
    const unsigned ss = sj >= 0 && sj < n ? state(sj) : 0u;
    const bool live = (ss & ds & 1u) != 0;
    const bool fs = live && (ss & 2u);
    const bool fd = live && (ds & 2u);
    v[j] = static_cast<int>(fs);
    if (CHARGE && fd && (!fs || d < sj)) v[j] += 1 << 16;
    dead += fs || fd;
  }
  sum_tile<CHARGE>(c, v, n, delta, inc);
  return dead;
}

// The work of one tile of a row whose packed state is in shared memory
// (row_words_of(n) words): peel_tile's, with a lane prologue cut for the
// rows kernel, where the lookups rather than the bytes set the pace. Ids are
// clamped (as unsigned) onto vertex n, whose state is 0, so no lookup
// branches; a thread's 16 sorted dst ids usually lie within 32 vertices, so
// their states come from a window of two words held in registers (when
// every thread of the warp is so, else once a run, as in peel_tile); live,
// fs and fd are bit operations on the 2-bit states.
template <bool CHARGE>
__device__ __forceinline__ int peel_rows_tile(const seg_reduce::Chunk<Src>& c, int n,
                                              const unsigned* __restrict__ words,
                                              int* __restrict__ delta, int* __restrict__ inc) {
  const int (&id)[ITEMS] = c.rows;
  const unsigned un = static_cast<unsigned>(n);
  // the thread's least and greatest clamped id: lanes before the row (-1,
  // only at its start) clamp to n, the greatest
  const bool before = id[0] < 0;
  const unsigned lo = (before ? 0u : min(static_cast<unsigned>(id[0]), un)) >> 4 << 4;
  const unsigned hi = before ? un : min(static_cast<unsigned>(id[ITEMS - 1]), un);
  const unsigned long long window =
      words[lo >> 4] | static_cast<unsigned long long>(words[(lo >> 4) + 1]) << 32;
  const bool in_window = __all_sync(FULL, hi - lo < 32u);
  int v[ITEMS];
  int dead = 0;
  unsigned ds = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const unsigned k = min(static_cast<unsigned>(id[j]), un);
    if (in_window)
      ds = static_cast<unsigned>(window >> (2 * (k - lo))) & 3u;
    else if (j == 0 || id[j] != id[j - 1])
      ds = state_of(words, static_cast<int>(k));
    const int sj = c.extra.s[j];
    const unsigned ss = state_of(words, static_cast<int>(min(static_cast<unsigned>(sj), un)));
    const unsigned live = ss & ds & 1u;
    const unsigned fs = live & (ss >> 1);
    const unsigned fd = live & (ds >> 1);
    v[j] = static_cast<int>(fs);
    if (CHARGE) v[j] += static_cast<int>(fd & ((fs ^ 1u) | (static_cast<int>(k) < sj))) << 16;
    dead += static_cast<int>(fs | fd);
  }
  sum_tile<CHARGE>(c, v, n, delta, inc);
  return dead;
}

// One row: persistent blocks walk the tiles grid-stride.
template <bool SMEM, bool CHARGE>
__global__ void __launch_bounds__(threads_of<SMEM>())
peel_kernel(const int* __restrict__ src, const int* __restrict__ dst, long long n_lanes,
            int pad, bool src_vec, long long n_tiles, int n, seg_reduce::PlainKeys keys,
            const unsigned* __restrict__ words, long long n_words,
            int* __restrict__ delta, int* __restrict__ removed, int* __restrict__ inc) {
  constexpr int THREADS = threads_of<SMEM>(), WARPS = THREADS / 32;
  extern __shared__ uint4 shared_words[];
  const unsigned* st = words;
  if constexpr (SMEM) {
    const uint4* w4 = reinterpret_cast<const uint4*>(words);
    for (long long i = threadIdx.x; i < n_words / 4; i += THREADS) shared_words[i] = w4[i];
    unsigned* sw = reinterpret_cast<unsigned*>(shared_words);
    for (long long i = n_words / 4 * 4 + threadIdx.x; i < n_words; i += THREADS)
      sw[i] = words[i];
    __syncthreads();
    st = sw;
  }
  int removed_acc = 0;
  seg_reduce::walk_tiles<Src>(
      dst, n_lanes, pad, n_tiles, keys, WARPS,
      [&](long long l0, Src& r) { load_src(src, l0, n_lanes, src_vec, r); },
      [&](long long, const seg_reduce::Chunk<Src>& c) {
        removed_acc += peel_tile<CHARGE>(c, n, [&](int v) { return state_of(st, v); },
                                         delta, inc);
      });
  removed_acc = __reduce_add_sync(FULL, removed_acc);
  if ((threadIdx.x & 31) == 0 && removed_acc) atomicAdd(removed, removed_acc);
}

template <bool SMEM, bool CHARGE>
void launch_peel(const int* src, const int* dst, long long n_lanes, int pad, bool src_vec,
                 long long n_tiles, int n, const unsigned* words, long long n_words,
                 int* delta, int* removed, int* inc, cudaStream_t stream) {
  auto kernel = peel_kernel<SMEM, CHARGE>;
  constexpr int THREADS = threads_of<SMEM>();
  const size_t smem = SMEM ? static_cast<size_t>(n_words) * 4 : 0;
  static bool opted_in = false;  // once per instantiation, before any graph capture
  if (SMEM && !opted_in) {
    int dev = 0, most = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    opted_in = true;
  }
  const int blocks = seg_reduce::persistent_blocks(kernel, THREADS, smem, n_tiles);
  kernel<<<blocks, THREADS, smem, stream>>>(src, dst, n_lanes, pad, src_vec, n_tiles, n,
                                            seg_reduce::PlainKeys{n}, words, n_words, delta,
                                            removed, inc);
}

// Rows: block b owns span b % spans of row b / spans. SMEM: the row's state
// packed in shared memory, else its bytes read through L1/L2.
template <bool SMEM, bool CHARGE>
__global__ void __launch_bounds__(ROW_THREADS, row_min_blocks<SMEM>())
peel_rows_kernel(const int* __restrict__ src, const int* __restrict__ dst, int len, int n,
                 int spans, const unsigned char* __restrict__ active,
                 const unsigned char* __restrict__ failed, int* __restrict__ delta,
                 int* __restrict__ removed, int* __restrict__ inc) {
  constexpr int WARPS = ROW_THREADS / 32;
  extern __shared__ unsigned row_words[];
  __shared__ int warp_removed[WARPS];
  const int r = blockIdx.x / spans;
  const long long lanes = static_cast<long long>(r) * len;
  const int* src_r = src + lanes;
  const int* dst_r = dst + lanes;
  const int pad = seg_reduce::pad_of(dst_r);
  long long t_begin, t_end;
  seg_reduce::span_of(blockIdx.x - r * spans, spans, seg_reduce::tiles_of(len, pad), t_begin,
                      t_end);
  if (t_begin == t_end) return;
  const bool src_vec = (reinterpret_cast<uintptr_t>(src_r) - 4 * pad) % 16 == 0;
  const long long verts = static_cast<long long>(r) * n;
  const unsigned char* act_r = active ? active + verts : nullptr;
  const unsigned char* fail_r = failed + verts;
  const long long keys = static_cast<long long>(r) * (n + 1);
  int* delta_r = delta + keys;
  int* inc_r = CHARGE ? inc + keys : nullptr;
  int removed_acc = 0;
  seg_reduce::walk_span<Src>(
      dst_r, len, pad, t_begin, t_end, seg_reduce::PlainKeys{n}, WARPS,
      [&]() {
        if constexpr (SMEM) {
          pack_row(act_r, fail_r, n, row_words);
          __syncthreads();
        }
      },
      [&](long long l0, Src& s) { load_src(src_r, l0, len, src_vec, s); },
      [&](long long, const seg_reduce::Chunk<Src>& c) {
        if constexpr (SMEM) {
          removed_acc += peel_rows_tile<CHARGE>(c, n, row_words, delta_r, inc_r);
        } else {
          removed_acc += peel_tile<CHARGE>(
              c, n,
              [&](int v) {
                return (act_r ? __ldg(act_r + v) & 1u : 1u) | (__ldg(fail_r + v) & 1u) << 1;
              },
              delta_r, inc_r);
        }
      });
  removed_acc = __reduce_add_sync(FULL, removed_acc);
  if ((threadIdx.x & 31) == 0) warp_removed[threadIdx.x >> 5] = removed_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += warp_removed[w];
    if (sum) atomicAdd(removed + r, sum);
  }
}

template <bool SMEM, bool CHARGE>
void launch_rows(const int* src, const int* dst, int rows, int len, int n,
                 const unsigned char* active, const unsigned char* failed, int* delta,
                 int* removed, int* inc, cudaStream_t stream) {
  auto kernel = peel_rows_kernel<SMEM, CHARGE>;
  const size_t smem = SMEM ? static_cast<size_t>((row_words_of(n) + 3) / 4 * 16) : 0;
  static bool opted_in = false;  // once per instantiation, before any graph capture
  if (SMEM && !opted_in) {  // all the shared memory a block may have, less the static
    int dev = 0, most = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes attr;
    cudaFuncGetAttributes(&attr, kernel);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         most - static_cast<int>(attr.sharedSizeBytes));
    opted_in = true;
  }
  // with the state packed by every block, spans of at least n / 2 lanes,
  // so that the block's 2n bytes of masks stay at most half its lane bytes
  const long long cap = SMEM ? 2 * static_cast<long long>(len) / n : len;
  const int spans = seg_reduce::row_spans(kernel, ROW_THREADS, smem, rows,
                                          seg_reduce::tiles_of(len, 0), cap);
  kernel<<<rows * spans, ROW_THREADS, smem, stream>>>(src, dst, len, n, spans, active, failed,
                                                       delta, removed, inc);
}

// One row: pack the state of n vertices and zero the outputs, then the pass
// over the lanes, its shared-memory and charge variants chosen here.
int run(const void* src, const void* dst, long long n_lanes, int n, const void* active,
        const void* failed, int charge, long long smem_max_bytes, void* buf,
        void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int* out = static_cast<int*>(buf);
  int* delta = out;
  int* removed = out + n;
  int* inc = out + n + 1;
  const long long n_words = n_words_of(n);
  unsigned* words = reinterpret_cast<unsigned*>(out + words_offset(n, charge != 0));
  const long long n_zero = n + 1 + (charge ? n : 0);
  const long long count = n_words > n_zero ? n_words : n_zero;
  const long long pack_blocks = (count + PACK_THREADS - 1) / PACK_THREADS;
  pack_kernel<<<static_cast<int>(pack_blocks < 8448 ? pack_blocks : 8448), PACK_THREADS, 0,
                stream>>>(static_cast<const unsigned char*>(active),
                          static_cast<const unsigned char*>(failed), n, words, n_words, out,
                          n_zero);
  if (n_lanes > 0) {
    const int* s = static_cast<const int*>(src);
    const int* d = static_cast<const int*>(dst);
    const int pad = seg_reduce::pad_of(d);
    const long long n_tiles = seg_reduce::tiles_of(n_lanes, pad);
    const bool src_vec = (reinterpret_cast<uintptr_t>(s) - 4 * pad) % 16 == 0;
    const bool smem = 4 * n_words <= smem_max_bytes;
    if (smem && charge)
      launch_peel<true, true>(s, d, n_lanes, pad, src_vec, n_tiles, n, words, n_words, delta,
                              removed, inc, stream);
    else if (smem)
      launch_peel<true, false>(s, d, n_lanes, pad, src_vec, n_tiles, n, words, n_words, delta,
                               removed, inc, stream);
    else if (charge)
      launch_peel<false, true>(s, d, n_lanes, pad, src_vec, n_tiles, n, words, n_words, delta,
                               removed, inc, stream);
    else
      launch_peel<false, false>(s, d, n_lanes, pad, src_vec, n_tiles, n, words, n_words,
                                delta, removed, inc, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows: one memset of the outputs, then the row-local pass.
int run_rows(const void* src, const void* dst, int rows, int len, int n, const void* active,
             const void* failed, int charge, long long smem_max_bytes, void* buf,
             void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n_keys = static_cast<long long>(rows) * (n + 1);
  int* out = static_cast<int*>(buf);
  int* delta = out;
  int* removed = out + n_keys;
  int* inc = out + n_keys + rows;
  const cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(int) * (n_keys + rows + (charge ? n_keys : 0)), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (len == 0) return static_cast<int>(cudaGetLastError());
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dst);
  const auto* a = static_cast<const unsigned char*>(active);
  const auto* f = static_cast<const unsigned char*>(failed);
  const bool smem = 4 * n_words_of(n) <= smem_max_bytes;
  if (smem && charge)
    launch_rows<true, true>(s, d, rows, len, n, a, f, delta, removed, inc, stream);
  else if (smem)
    launch_rows<true, false>(s, d, rows, len, n, a, f, delta, removed, inc, stream);
  else if (charge)
    launch_rows<false, true>(s, d, rows, len, n, a, f, delta, removed, inc, stream);
  else
    launch_rows<false, false>(s, d, rows, len, n, a, f, delta, removed, inc, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Ints of the buffer the caller passes for n vertices.
extern "C" long long peel_buffer_ints(int n, int charge) {
  return words_offset(n, charge != 0) + n_words_of(n);
}

// Bytes of packed vertex state (2 bits a vertex) for n vertices: the shared
// memory a block of the peel launch takes when they are kept there (for the
// rows entry, n the vertices of a row).
extern "C" long long peel_state_bytes(long long n) { return 4 * n_words_of(n); }

// The edge stage. buf: peel_buffer_ints(n, charge) int32, 16-byte aligned;
// delta is buf[0:n], removed buf[n], inc buf[n+1:2n+1]. The packed state is
// kept in shared memory when it takes at most smem_max_bytes.
extern "C" int peel_edges(const void* src, const void* dst, long long n_lanes, int n,
                          const void* active, const void* failed, int charge,
                          long long smem_max_bytes, void* buf, void* stream_ptr) {
  if (n <= 0) return 0;
  return run(src, dst, n_lanes, n, active, failed, charge, smem_max_bytes, buf, stream_ptr);
}

// Ints of the buffer for the row-batched stage: rows of n vertices each.
extern "C" long long peel_rows_buffer_ints(int rows, int n, int charge) {
  const long long n_keys = static_cast<long long>(rows) * (n + 1);
  return n_keys + rows + (charge ? n_keys : 0);
}

// The edge stage of `rows` independent peels in one pass: src and dst
// [rows, len] int32, each row dst-sorted on its own (ids in [0, n], n the
// sentinel); active and failed bool [rows, n]. buf: peel_rows_buffer_ints
// int32; with K = rows * (n + 1), delta is buf[0:K] as [rows, n + 1]
// (column n the sentinel's, zero), removed buf[K:K+rows], inc
// buf[K+rows:2K+rows] as [rows, n + 1]. A row's packed state (2 bits a
// vertex) is kept in its blocks' shared memory when it takes at most
// smem_max_bytes, else read through L1/L2.
extern "C" int peel_edges_rows(const void* src, const void* dst, int rows, int len, int n,
                               const void* active, const void* failed, int charge,
                               long long smem_max_bytes, void* buf, void* stream_ptr) {
  if (rows <= 0 || n <= 0) return 0;
  return run_rows(src, dst, rows, len, n, active, failed, charge, smem_max_bytes, buf,
                  stream_ptr);
}

// The text of a CUDA error code, for the wrapper's exception.
extern "C" const char* peel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
