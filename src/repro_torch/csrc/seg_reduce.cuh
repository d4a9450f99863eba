// One-pass segmented reduction over dst-sorted lanes, shared by the sorted
// segment-sum (K1, segsum.cu) and the fused peel edge stage (K2, peel.cu).
//
// For lanes whose segment ids ascend, it sums each run of equal ids in one
// pass over the lanes, with no row-offset pass and no second read:
//
//   * Ownership. A warp owns a tile of TILE = 32 x ITEMS consecutive lanes;
//     each thread owns ITEMS = 16 consecutive lanes of it. Tiles are cut by
//     lanes, not by rows, so a 40,000-lane RMAT hub row spans many tiles and
//     every warp does the same work. Two walkers hand out the tiles:
//     walk_tiles, persistent blocks grid-stride over one sequence of lanes
//     (tile = warp, warp + n_warps, ...); walk_span, the row-local walker of
//     the rows entries, where G rows of L lanes, each sorted on its own, are
//     cut into spans of whole tiles of one row and a block walks one span
//     (tile = first + warp, + warps a block, ...), so that it knows its row
//     and keeps that row's state near (row_spans sizes the spans).
//   * Loads. The lane origin is shifted by `pad` lanes (0-3) so that every
//     thread's 16 ids start on a 16-byte boundary: four int4 loads. The
//     caller loads its values the same way (16 bools in one uint4, 4 floats
//     in a float4) when their address allows it, lane by lane otherwise. The
//     partial chunks at the two ends of the lanes are read lane by lane.
//     Lanes before 0 read as row -1 and lanes at or past n_lanes as row
//     n_rows: both are dropped, and both keep the ids sorted.
//   * Keys. A lane's row is computed from its id in registers (Keys,
//     PlainKeys: the id itself, clamped). The row-local walker runs on one
//     row's lanes with the row's own pointers, so its keys are plain too:
//     the caller offsets its output by row * (V + 1) and a row's sentinel
//     tail never meets the next row's vertex 0.
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
// For the row-local walker, staging a warp's next tile in shared memory by
// cp.async, or asking L2 for it ahead, measured no faster either.
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
__host__ __device__ inline int pad_of(const void* seg) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(seg) / 4 % 4);
}

__host__ __device__ inline long long tiles_of(long long n_lanes, int pad) {
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

// Walk the tiles [t_begin, t_end) of one row (its lanes seg[0, n_lanes),
// pad its own), the block's warps in turn: tile = t_begin + warp, + warps a
// block, ..., each loaded straight into registers after prologue() (the
// block's set-up; every thread calls it, so it may hold __syncthreads).
// Lanes at or past n_rows (the row's sentinel tail, sorted last) contribute
// nothing, so a span that starts there returns before the prologue, and a
// warp stops at its first tile that lies wholly past them. reduce(t, chunk)
// does the work of tile t.
template <typename Extra, typename Keys, typename Prologue, typename LoadExtra, typename Reduce>
__device__ __forceinline__ void walk_span(const int* __restrict__ seg, long long n_lanes,
                                          int pad, long long t_begin, long long t_end,
                                          const Keys& keys, int warps_per_block,
                                          Prologue&& prologue, LoadExtra&& load_extra,
                                          Reduce&& reduce) {
  if (row_at(seg, t_begin * TILE - pad, n_lanes, keys) >= keys.n_rows) return;
  prologue();
  for (long long t = t_begin + (threadIdx.x >> 5); t < t_end; t += warps_per_block) {
    Chunk<Extra> c;
    load_chunk(seg, t, pad, n_lanes, keys, load_extra, c);
    if (c.prev >= keys.n_rows) break;
    reduce(t, c);
  }
}

// The tiles of span s of `spans` in a row of n_tiles tiles: [begin, end).
__device__ __forceinline__ void span_of(int s, int spans, long long n_tiles, long long& begin,
                                        long long& end) {
  begin = n_tiles * s / spans;
  end = n_tiles * (s + 1) / spans;
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

// Spans a row is cut into by a row-local kernel (a grid of rows x spans
// blocks of `threads` threads): enough for one wave of the card (as many
// blocks as the SMs hold at once), but, once every SM has a block, no more
// than `cap` a row (a caller whose blocks each read their row's state sets
// it so that this read stays small beside the lanes), and none shorter than
// a tile a warp. The SM count and the blocks an SM holds are host queries
// that cost more than a small launch, so they are kept for the last few
// (kernel, device, shared memory) asked.
template <typename K>
inline int row_spans(K kernel, int threads, size_t smem, long long rows, long long row_tiles,
                     long long cap) {
  struct Entry {
    const void* kernel;
    int dev;
    size_t smem;
    int sms, per_sm;
  };
  static Entry seen[4] = {};
  static int next = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const void* key = reinterpret_cast<const void*>(kernel);
  const Entry* e = nullptr;
  for (const Entry& x : seen)
    if (x.kernel == key && x.dev == dev && x.smem == smem) e = &x;
  if (!e) {
    Entry x{key, dev, smem, 0, 0};
    cudaDeviceGetAttribute(&x.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&x.per_sm, kernel, threads, smem);
    seen[next] = x;
    e = &seen[next];
    next = (next + 1) % 4;
  }
  const long long wave = static_cast<long long>(e->sms) * (e->per_sm > 0 ? e->per_sm : 1);
  long long spans = wave / rows;
  const long long fill = (e->sms + rows - 1) / rows;  // one block an SM
  const long long most = cap > fill ? cap : fill;
  if (spans > most) spans = most;
  if (spans > row_tiles / (threads / 32)) spans = row_tiles / (threads / 32);
  return static_cast<int>(spans > 0 ? spans : 1);
}

}  // namespace seg_reduce
