// One-pass segmented reduction over dst-sorted lanes, shared by the sorted
// segment-sum (K1, segsum.cu) and the fused peel edge stage (K2, peel.cu).
//
// For lanes whose segment ids ascend, it sums each run of equal ids in one
// pass over the lanes, with no row-offset pass and no second read:
//
//   * Ownership. A warp owns a tile of TILE = 32 x ITEMS consecutive lanes;
//     each thread owns ITEMS = 16 consecutive lanes of it. Tiles are cut by
//     lanes, not by rows, so a 40,000-lane RMAT hub row spans many tiles and
//     every warp does the same work. Persistent blocks walk the tiles
//     grid-stride (tile = warp, warp + n_warps, ...).
//   * Loads. The lane origin is shifted by `pad` lanes (0-3) so that every
//     thread's 16 ids start on a 16-byte boundary: four int4 loads. The
//     caller loads its values the same way (16 bools in one uint4, 4 floats
//     in a float4) when their address allows it, lane by lane otherwise. The
//     partial chunks at the two ends of the lanes are read lane by lane.
//     Lanes before 0 read as row -1 and lanes at or past n_lanes as row
//     n_rows: both are dropped, and both keep the ids sorted.
//   * Keys. A lane's row is computed from its id in registers (Keys):
//     the id itself (PlainKeys), or, for G rows of L lanes each sorted on
//     its own, row * (V + 1) + id (RowKeys), so that one pass reduces a
//     whole batch of rows, [G, L] lanes onto [G, V + 1] keys.
//   * Reduction. A thread sums its runs in registers and stores every run
//     that starts and ends inside it. The run that crosses into the next
//     thread is combined across the warp by a segmented scan on
//     (head flag, partial) pairs with __shfl_up_sync; the head flags come
//     from comparing each thread's first id with its neighbour's last id.
//   * Writes. The thread that ends a row stores it with a plain store. The
//     tile's first row, if it began in an earlier tile, and its last row, if
//     it goes on into the next tile, are returned to the caller as records
//     (TileCarry): the caller adds them with atomicAdd onto an output zeroed
//     beforehand (integers: exact in any order) or writes them to a carry
//     scratch that a second short launch sums in tile order (float32: the
//     sums then depend only on the data, the tile size and the ids'
//     alignment, and two runs are bitwise equal). Rows with no lanes are
//     never touched, so the output must be zeroed before the launch.
//
// The lanes come straight into registers by 16-byte loads. A ring of 1-D
// bulk copies (TMA) into shared memory, three tiles ahead a warp, measured
// slower on the H100 (its shared memory caps the warps an SM holds, and a
// warp's 2.5-4 KB tile is a small copy), as did loading the next tile
// before reducing the current one (twice the registers, half the warps).
//
// Everything here is a device function; nothing allocates or synchronises.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace seg_reduce {

constexpr int ITEMS = 16;                // consecutive lanes a thread owns
constexpr int TILE = 32 * ITEMS;         // lanes a warp tile owns
constexpr unsigned FULL = 0xffffffffu;

// Lanes of padding before lane 0 that put every thread's first id on a
// 16-byte boundary (ids are 4-byte aligned, so 0 to 3).
inline int pad_of(const void* seg) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(seg) / 4 % 4);
}

inline long long tiles_of(long long n_lanes, int pad) {
  return (n_lanes + pad + TILE - 1) / TILE;
}

__device__ __forceinline__ int clamp_row(int s, int n_rows) {
  return s < 0 ? -1 : (s > n_rows ? n_rows : s);
}

// How a lane's id becomes its row (the segment key the reduction runs on).
// Keys give the row of one lane, keys(e, id), and of a chunk's 16 lanes
// from their ids in place, keys.chunk(l0, id) (l0 >= 0, every lane inside
// the lanes); n_rows is the row count, whose rows [0, n_rows) are kept.
//
// PlainKeys: the id itself, -1 below 0 and n_rows at or past it.
struct PlainKeys {
  int n_rows;
  __device__ __forceinline__ int operator()(long long, int id) const {
    return clamp_row(id, n_rows);
  }
  __device__ __forceinline__ void chunk(long long, int (&id)[ITEMS]) const {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) id[j] = clamp_row(id[j], n_rows);
  }
};

// RowKeys: the lanes are rows of `len` lanes, each sorted by its ids in
// [0, v] (v the sentinel). Lane e, of row r = e / len, has key
// r * (v + 1) + id with the id clamped to [-1, v], so the rows are segments
// of one ascending sequence of n_rows = rows * (v + 1) keys: a row's
// sentinel tail (key r * (v + 1) + v) cannot merge with the next row's
// vertex 0, and an id below 0 lands on the row before's sentinel key (or
// -1 in row 0). The caller drops the sentinel keys.
struct RowKeys {
  int n_rows, len, v;
  __device__ __forceinline__ int key(int r, int id) const {
    return r * (v + 1) + (id < 0 ? -1 : (id > v ? v : id));
  }
  __device__ __forceinline__ int operator()(long long e, int id) const {
    return key(static_cast<int>(e) / len, id);
  }
  // Keys of a chunk's 16 lanes from l0 (>= 0): one division a chunk, then
  // the row advanced lane by lane (len >= 1, so a step of one lane crosses
  // at most one row edge).
  __device__ __forceinline__ void chunk(long long l0, int (&id)[ITEMS]) const {
    int row = static_cast<int>(l0) / len;
    long long next = static_cast<long long>(row + 1) * len;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (l0 + j >= next) {
        ++row;
        next += len;
      }
      id[j] = key(row, id[j]);
    }
  }
};

// Row of lane e: -1 before the lanes, n_rows after them, else keys(e, id).
template <typename Keys>
__device__ __forceinline__ int row_at(const int* __restrict__ seg, long long e,
                                      long long n_lanes, const Keys& keys) {
  if (e < 0) return -1;
  if (e >= n_lanes) return keys.n_rows;
  return keys(e, __ldg(seg + e));
}

// First lane of this thread's chunk in tile t (may be negative in tile 0).
__device__ __forceinline__ long long chunk_lane(long long t, int lane, int pad) {
  return t * TILE + static_cast<long long>(lane) * ITEMS - pad;
}

// The 16 rows of a chunk: four 16-byte loads inside the lanes (the chunk is
// aligned by construction), lane by lane at the two ends.
template <typename Keys>
__device__ __forceinline__ void load_rows(const int* __restrict__ seg, long long l0,
                                          long long n_lanes, const Keys& keys,
                                          int (&id)[ITEMS]) {
  if (l0 >= 0 && l0 + ITEMS <= n_lanes) {
    const int4* p = reinterpret_cast<const int4*>(seg + l0);
#pragma unroll
    for (int k = 0; k < ITEMS / 4; ++k) {
      const int4 q = __ldcs(p + k);  // read once: stream past L2
      id[4 * k] = q.x, id[4 * k + 1] = q.y, id[4 * k + 2] = q.z, id[4 * k + 3] = q.w;
    }
    keys.chunk(l0, id);
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) id[j] = row_at(seg, l0 + j, n_lanes, keys);
  }
}

// A thread's share of one warp tile: its chunk's rows, the rows of the
// lanes just before and just after the tile, and Extra (the caller's
// per-lane data: K1's values, K2's src ids).
template <typename Extra>
struct Chunk {
  int rows[ITEMS];
  int prev, next;
  Extra extra;
};

template <typename Extra, typename Keys, typename LoadExtra>
__device__ __forceinline__ void load_chunk(const int* __restrict__ seg, long long t, int pad,
                                           long long n_lanes, const Keys& keys,
                                           LoadExtra&& load_extra, Chunk<Extra>& c) {
  const long long l0 = chunk_lane(t, threadIdx.x & 31, pad);
  load_rows(seg, l0, n_lanes, keys, c.rows);
  load_extra(l0, c.extra);
  const long long t0 = t * TILE - pad;
  c.prev = row_at(seg, t0 - 1, n_lanes, keys);
  c.next = row_at(seg, t0 + TILE, n_lanes, keys);
}

// Walk this warp's tiles grid-stride, each loaded straight into registers.
// reduce(t, chunk) does the work of tile t.
template <typename Extra, typename Keys, typename LoadExtra, typename Reduce>
__device__ __forceinline__ void walk_tiles(const int* __restrict__ seg, long long n_lanes,
                                           int pad, long long n_tiles, const Keys& keys,
                                           int warps_per_block, LoadExtra&& load_extra,
                                           Reduce&& reduce) {
  const long long n_warps = static_cast<long long>(gridDim.x) * warps_per_block;
  for (long long t = blockIdx.x * static_cast<long long>(warps_per_block) + (threadIdx.x >> 5);
       t < n_tiles; t += n_warps) {
    Chunk<Extra> c;
    load_chunk(seg, t, pad, n_lanes, keys, load_extra, c);
    reduce(t, c);
  }
}

// The rows of a tile that cross its edges, the same in every lane of the
// warp. head: the tile's first row, begun in an earlier tile (its partial
// over this tile, which may be the whole tile when the row goes on past
// it); tail: the tile's last row, begun in this tile and going on into the
// next. A row of -1 means none (or a dropped row).
template <typename A>
struct TileCarry {
  int head_row;
  A head_val;
  int tail_row;
  A tail_val;
};

// Reduce one warp tile. id[] and v[] are this thread's 16 lanes (rows
// already clamped, values already in the accumulator's type); tile_prev and
// tile_next are the rows of the lanes just before and just after the tile
// (the same in every lane). store(row, total) is called once for every
// valid row that begins and ends in the tile, by the thread that ends it.
template <typename A, typename Store>
__device__ __forceinline__ TileCarry<A> reduce_tile(const int (&id)[ITEMS],
                                                    const A (&v)[ITEMS], int tile_prev,
                                                    int tile_next, int n_rows,
                                                    Store&& store) {
  const int lane = threadIdx.x & 31;
  const int first = id[0], last = id[ITEMS - 1];
  int prev = __shfl_up_sync(FULL, last, 1);
  if (lane == 0) prev = tile_prev;
  int next = __shfl_down_sync(FULL, first, 1);
  if (lane == 31) next = tile_next;
  const int r0 = __shfl_sync(FULL, first, 0);
  const bool head_cont = tile_prev == r0;  // the tile's first row began earlier

  // runs inside the thread: the first run's sum f, the last run's sum acc;
  // every run between them starts and ends here, so it is stored now (its
  // row is above r0, so it never began in an earlier tile)
  A f = 0, acc = v[0];
  bool single = true;
#pragma unroll
  for (int j = 1; j < ITEMS; ++j) {
    if (id[j] != id[j - 1]) {
      if (single) {
        f = acc;
        single = false;
      } else if (id[j - 1] >= 0 && id[j - 1] < n_rows) {
        store(id[j - 1], acc);
      }
      acc = 0;
    }
    acc += v[j];
  }
  if (single) f = acc;

  // segmented inclusive scan of (h, acc): the partial of the row running at
  // each thread's end, from its first lane in this tile
  A sv = acc;
  bool sh = first != prev || !single;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const A ov = __shfl_up_sync(FULL, sv, off);
    const bool oh = __shfl_up_sync(FULL, sh ? 1 : 0, off) != 0;
    if (lane >= off) {
      if (!sh) sv += ov;
      sh = sh || oh;
    }
  }
  A carry = __shfl_up_sync(FULL, sv, 1);
  if (lane == 0) carry = 0;
  const A tf = (first == prev ? carry : A(0)) + f;  // first run, tile part so far
  const A tl = single ? tf : acc;                   // last run, tile part so far

  bool has_head = false;
  A head_val = 0;
  auto finish = [&](int r, A total) {  // row r ends in this thread
    if (r == r0 && head_cont) {
      has_head = true;
      head_val = total;
    } else if (r >= 0 && r < n_rows) {
      store(r, total);
    }
  };
  if (!single) finish(first, tf);
  bool has_tail = false;
  if (next != last) {
    finish(last, tl);
  } else if (lane == 31) {  // the tile's last row goes on into the next tile
    if (last == r0 && head_cont) {
      has_head = true;
      head_val = tl;
    } else {
      has_tail = true;
    }
  }

  TileCarry<A> c;
  const unsigned heads = __ballot_sync(FULL, has_head);
  c.head_row = heads && r0 >= 0 && r0 < n_rows ? r0 : -1;
  c.head_val = __shfl_sync(FULL, head_val, heads ? __ffs(heads) - 1 : 0);
  const bool tail = __shfl_sync(FULL, has_tail ? 1 : 0, 31) != 0;
  const int tail_row = __shfl_sync(FULL, last, 31);
  c.tail_row = tail && tail_row >= 0 && tail_row < n_rows ? tail_row : -1;
  c.tail_val = __shfl_sync(FULL, tl, 31);
  return c;
}

// float32 carries: tile t wrote its head record at slot 2t and its tail
// record at slot 2t + 1 (row -1 when none). A row that crosses tiles has one
// tail record, in the tile where it begins, and one head record in each
// later tile it reaches; one thread per tail record adds them in tile order.
__global__ void carry_f32_kernel(const int* __restrict__ rows,
                                 const float* __restrict__ vals, long long n_tiles,
                                 float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       t < n_tiles; t += stride) {
    const int r = rows[2 * t + 1];
    if (r < 0) continue;
    float s = vals[2 * t + 1];
    for (long long k = t + 1; k < n_tiles && rows[2 * k] == r; ++k) s += vals[2 * k];
    out[r] = s;
  }
}

// Blocks for a persistent grid of `kernel`: as many as the SMs hold at once,
// and no more than the tiles need (at `threads` threads a block). Host-side
// queries only (no sync, no allocation).
template <typename K>
inline int persistent_blocks(K kernel, int threads, size_t smem, long long n_tiles) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const long long want = (n_tiles + threads / 32 - 1) / (threads / 32);
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (want < blocks) blocks = want;
  return static_cast<int>(blocks > 0 ? blocks : 1);
}

}  // namespace seg_reduce
