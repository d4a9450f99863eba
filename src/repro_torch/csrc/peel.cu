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
// state is [G, V], 2 bits a vertex. The core keys lane e of row r as r * (V + 1) + dst in
// registers (RowKeys), so the G rows are segments of one ascending sequence:
// a row's sentinel tail cannot merge with the next row's vertex 0. delta and
// inc are written in that key space, [G, V + 1] (the sentinel column stays
// 0). The packed state, G * V vertices, is read through L1/L2: kept in
// shared memory as the one-row pass keeps it, the 1,024-thread blocks cap a
// thread at 64 registers and the row arithmetic then spills (measured
// slower on the H100 at G = 4-32 rows of 131,072 lanes). removed is per row: a warp whose tile lies in one row keeps its count
// across tiles and adds it once the row changes; a tile across a row edge
// adds each thread's run per row. Bound by the same bytes as one pass over
// G * L lanes; one launch a pass for the whole group instead of G.
//
// Launched on the caller's stream; it neither allocates nor synchronises:
// the caller passes one int32 buffer (peel_buffer_ints) that holds the
// outputs and the packed words. The C entry point returns cudaGetLastError()
// after its launches.

#include <cstdint>
#include <type_traits>
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

// Buffer layout (int32): delta [n_keys] | removed [n_removed] | inc [n_keys]
// (charge only) | packed words, 16-byte aligned. One row: n_keys = n,
// n_removed = 1. Rows: n_keys = rows * (v + 1) (delta and inc in key space,
// column v the sentinel's), n_removed = rows.
long long words_offset(long long n_keys, long long n_removed, bool charge) {
  const long long outs = n_keys + n_removed + (charge ? n_keys : 0);
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

struct Src {  // a chunk's 16 src ids as loaded
  int s[ITEMS];
};

__device__ __forceinline__ unsigned state_of(const unsigned* st, int v) {
  return (st[v >> 4] >> ((v & 15) * 2)) & 3u;
}

// One row (ROWS false): n vertices, keys the dst ids (PlainKeys{n}).
// Rows (ROWS true): G rows of len lanes over n vertices each; the state of
// vertex v of row r is at r * n + v; keys r * (n + 1) + dst (RowKeys).
template <bool ROWS>
using KeysOf = typename std::conditional<ROWS, seg_reduce::RowKeys, seg_reduce::PlainKeys>::type;

template <bool SMEM, bool CHARGE, bool ROWS>
__global__ void __launch_bounds__(threads_of<SMEM>())
peel_kernel(const int* __restrict__ src, const int* __restrict__ dst, long long n_lanes,
            int pad, bool src_vec, long long n_tiles, int n, KeysOf<ROWS> keys,
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
  const int lane = threadIdx.x & 31;
  // removed: one row, a thread's count summed per warp at the end; rows, the
  // count of the row that this warp's whole tiles have been in (acc_row)
  int removed_acc = 0, acc_row = -1;
  auto flush_rows = [&]() {  // warp-uniform
    const int s = __reduce_add_sync(FULL, removed_acc);
    if (lane == 0 && s) atomicAdd(removed + acc_row, s);
    removed_acc = 0;
  };
  auto load = [&](long long l0, Src& r) {
        if (src_vec && l0 >= 0 && l0 + ITEMS <= n_lanes) {
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
      };
  auto work = [&](long long t, const seg_reduce::Chunk<Src>& c) {
        const int (&id)[ITEMS] = c.rows;
        const long long l0 = seg_reduce::chunk_lane(t, lane, pad);
        // rows: the lane's row, advanced lane by lane from the chunk's first
        // (lanes before 0 are in row 0; past the end src reads -1 and the
        // key is n_rows, so those lanes are never live). A tile whose valid
        // lanes lie in one row (whole) adds its removed count to the warp's
        // running count for that row.
        int row = 0;
        long long next = 0;
        bool whole = true;
        if constexpr (ROWS) {
          const long long t0 = t * TILE - pad, t1 = t0 + TILE - 1;
          const int first = static_cast<int>(t0 < 0 ? 0 : t0) / keys.len;
          whole = first == static_cast<int>(t1 < n_lanes ? t1 : n_lanes - 1) / keys.len;
          if (whole && first != acc_row) {
            if (acc_row >= 0) flush_rows();
            acc_row = first;
          }
          row = l0 < 0 ? 0 : static_cast<int>(l0) / keys.len;
          next = static_cast<long long>(row + 1) * keys.len;
        }
        // lane prologue: an invalid end has state 0, so it is never live
        int v[ITEMS];
        unsigned ds = 0;
        int d = -1;      // the dst's vertex id within its row
        int cur = -1, cnt = 0;  // rows, a tile across rows: this thread's run
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          if constexpr (ROWS) {
            if (l0 + j >= next) {
              ++row;
              next += keys.len;
            }
          }
          const int k = id[j];
          if (j == 0 || k != id[j - 1]) {
            if constexpr (ROWS) {
              d = k - row * (n + 1);
              d = k >= 0 && k < keys.n_rows && d >= 0 && d < n ? d : -1;
              ds = d >= 0 ? state_of(st, row * n + d) : 0u;
            } else {
              d = k;
              ds = k >= 0 && k < n ? state_of(st, k) : 0u;
            }
          }
          const int sj = c.extra.s[j];
          int sv = sj >= 0 && sj < n ? sj : -1;
          if constexpr (ROWS) sv = sv >= 0 ? row * n + sv : -1;
          const unsigned ss = sv >= 0 ? state_of(st, sv) : 0u;
          const bool live = (ss & ds & 1u) != 0;
          const bool fs = live && (ss & 2u);
          const bool fd = live && (ds & 2u);
          v[j] = static_cast<int>(fs);
          if (CHARGE && fd && (!fs || d < sj)) v[j] += 1 << 16;
          const int dead = fs || fd;
          if (!ROWS || whole) {
            removed_acc += dead;
          } else {
            if (row != cur) {
              if (cnt) atomicAdd(removed + cur, cnt);
              cur = row;
              cnt = 0;
            }
            cnt += dead;
          }
        }
        if (ROWS && cnt) atomicAdd(removed + cur, cnt);
        const auto carry = seg_reduce::reduce_tile<int>(
            id, v, c.prev, c.next, keys.n_rows, [&](int r, int total) {
              delta[r] = total & 0xffff;
              if (CHARGE) inc[r] = total >> 16;
            });
        if (lane != 0) return;
        const int rows[2] = {carry.head_row, carry.tail_row};
        const int vals[2] = {carry.head_val, carry.tail_val};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (rows[k] < 0) continue;
          if (vals[k] & 0xffff) atomicAdd(delta + rows[k], vals[k] & 0xffff);
          if (CHARGE && (vals[k] >> 16)) atomicAdd(inc + rows[k], vals[k] >> 16);
        }
      };
  seg_reduce::walk_tiles<Src>(dst, n_lanes, pad, n_tiles, keys, WARPS, load, work);
  if constexpr (ROWS) {
    if (acc_row >= 0) flush_rows();
  } else {
    removed_acc = __reduce_add_sync(FULL, removed_acc);
    if (lane == 0 && removed_acc) atomicAdd(removed, removed_acc);
  }
}

template <bool SMEM, bool CHARGE, bool ROWS>
void launch_peel(const int* src, const int* dst, long long n_lanes, int pad, bool src_vec,
                 long long n_tiles, int n, KeysOf<ROWS> keys, const unsigned* words,
                 long long n_words, int* delta, int* removed, int* inc, cudaStream_t stream) {
  auto kernel = peel_kernel<SMEM, CHARGE, ROWS>;
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
  kernel<<<blocks, THREADS, smem, stream>>>(src, dst, n_lanes, pad, src_vec, n_tiles, n, keys,
                                            words, n_words, delta, removed, inc);
}

// Pack the state of n_state vertices and zero the outputs, then the pass over
// the lanes, its shared-memory and charge variants chosen here.
template <bool ROWS>
int run(const void* src, const void* dst, long long n_lanes, int n, KeysOf<ROWS> keys,
        long long n_state, long long n_removed, const void* active, const void* failed,
        int charge, long long smem_max_bytes, void* buf, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n_keys = keys.n_rows;
  int* out = static_cast<int*>(buf);
  int* delta = out;
  int* removed = out + n_keys;
  int* inc = out + n_keys + n_removed;
  const long long n_words = n_words_of(n_state);
  unsigned* words =
      reinterpret_cast<unsigned*>(out + words_offset(n_keys, n_removed, charge != 0));
  const long long n_zero = n_keys + n_removed + (charge ? n_keys : 0);
  const long long count = n_words > n_zero ? n_words : n_zero;
  const long long pack_blocks = (count + PACK_THREADS - 1) / PACK_THREADS;
  pack_kernel<<<static_cast<int>(pack_blocks < 8448 ? pack_blocks : 8448), PACK_THREADS, 0,
                stream>>>(static_cast<const unsigned char*>(active),
                          static_cast<const unsigned char*>(failed), n_state, words, n_words,
                          out, n_zero);
  if (n_lanes > 0) {
    const int* s = static_cast<const int*>(src);
    const int* d = static_cast<const int*>(dst);
    const int pad = seg_reduce::pad_of(d);
    const long long n_tiles = seg_reduce::tiles_of(n_lanes, pad);
    const bool src_vec = (reinterpret_cast<uintptr_t>(s) - 4 * pad) % 16 == 0;
    if constexpr (ROWS) {  // the state through L1/L2 (see the header)
      if (charge)
        launch_peel<false, true, true>(s, d, n_lanes, pad, src_vec, n_tiles, n, keys, words,
                                       n_words, delta, removed, inc, stream);
      else
        launch_peel<false, false, true>(s, d, n_lanes, pad, src_vec, n_tiles, n, keys, words,
                                        n_words, delta, removed, inc, stream);
    } else {
      const bool smem = 4 * n_words <= smem_max_bytes;
      if (smem && charge)
        launch_peel<true, true, false>(s, d, n_lanes, pad, src_vec, n_tiles, n, keys, words,
                                       n_words, delta, removed, inc, stream);
      else if (smem)
        launch_peel<true, false, false>(s, d, n_lanes, pad, src_vec, n_tiles, n, keys, words,
                                        n_words, delta, removed, inc, stream);
      else if (charge)
        launch_peel<false, true, false>(s, d, n_lanes, pad, src_vec, n_tiles, n, keys, words,
                                        n_words, delta, removed, inc, stream);
      else
        launch_peel<false, false, false>(s, d, n_lanes, pad, src_vec, n_tiles, n, keys, words,
                                         n_words, delta, removed, inc, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Ints of the buffer the caller passes for n vertices.
extern "C" long long peel_buffer_ints(int n, int charge) {
  return words_offset(n, 1, charge != 0) + n_words_of(n);
}

// Bytes of packed vertex state (2 bits a vertex) for n vertices: the shared
// memory a block of the peel launch takes when they are kept there.
extern "C" long long peel_state_bytes(long long n) { return 4 * n_words_of(n); }

// The edge stage. buf: peel_buffer_ints(n, charge) int32, 16-byte aligned;
// delta is buf[0:n], removed buf[n], inc buf[n+1:2n+1]. The packed state is
// kept in shared memory when it takes at most smem_max_bytes.
extern "C" int peel_edges(const void* src, const void* dst, long long n_lanes, int n,
                          const void* active, const void* failed, int charge,
                          long long smem_max_bytes, void* buf, void* stream_ptr) {
  if (n <= 0) return 0;
  return run<false>(src, dst, n_lanes, n, seg_reduce::PlainKeys{n}, n, 1, active, failed,
                    charge, smem_max_bytes, buf, stream_ptr);
}

// Ints of the buffer for the row-batched stage: rows of n vertices each.
extern "C" long long peel_rows_buffer_ints(int rows, int n, int charge) {
  const long long n_keys = static_cast<long long>(rows) * (n + 1);
  return words_offset(n_keys, rows, charge != 0) +
         n_words_of(static_cast<long long>(rows) * n);
}

// The edge stage of `rows` independent peels in one pass: src and dst
// [rows, len] int32, each row dst-sorted on its own (ids in [0, n], n the
// sentinel); active and failed bool [rows, n]. buf: peel_rows_buffer_ints
// int32, 16-byte aligned; with K = rows * (n + 1), delta is buf[0:K] as
// [rows, n + 1] (column n the sentinel's, zero), removed buf[K:K+rows], inc
// buf[K+rows:2K+rows] as [rows, n + 1]. The packed state of the rows * n
// vertices is read through L1/L2.
extern "C" int peel_edges_rows(const void* src, const void* dst, int rows, int len, int n,
                               const void* active, const void* failed, int charge, void* buf,
                               void* stream_ptr) {
  if (rows <= 0 || n <= 0) return 0;
  const seg_reduce::RowKeys keys{rows * (n + 1), len, n};
  return run<true>(src, dst, static_cast<long long>(rows) * len, n, keys,
                   static_cast<long long>(rows) * n, rows, active, failed, charge, 0, buf,
                   stream_ptr);
}

// The text of a CUDA error code, for the wrapper's exception.
extern "C" const char* peel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
