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
// D > 1 (the GNNs' messages: D = 3, 7, 16, 64 and MACE's 1,152, float32;
// int32 and bool too): bound by the same bytes, E * D values and E ids read
// once and V * D sums written once (2.56 ms at [123.7 M, 16] onto 2.45 M
// rows). The card needs some 20-25 KB in flight on each SM to reach its
// rate, whatever the widths. What the design does about it (namespace dn):
//   - Lanes, not rows, are the unit of work. The lanes are cut into tiles of
//     L consecutive lanes, and each persistent block (two an SM where two
//     stages fit, else one) walks one span of consecutive tiles. A hub row
//     spans many tiles, and a run of empty rows costs no lanes. Tiles are
//     as large as two stages of two blocks an SM allow (784 lanes, 53 KB at
//     D = 16; 8 lanes at D = 1,152), cut so that every block gets the same
//     count: one tile each on a sampled block's 168,960 lanes at D = 16.
//     More stages of smaller tiles measured slower on the H100 at the
//     points of chip_smoke.py phase 16 (e): each tile costs two block
//     barriers and a pass over its chunk edges.
//   - A tile's ids and its [L, D] values are each one contiguous range, so
//     one thread brings both in with 1-D bulk copies (cp.async.bulk, TMA)
//     on an mbarrier into a ring of two shared-memory stages: a tile in
//     flight while the other is summed, about 100 KB an SM, and no
//     registers spent on them. Ids or values off a 16-byte boundary take
//     plain loads into the same stages; the last tile's bytes past a
//     multiple of 16 are read after its copies.
//   - The sums are column-parallel and in lane order: an item of work is
//     one unit of W = 4 columns (one 16-byte read; W = 1 when D % 4 != 0)
//     of one chunk of K consecutive lanes, so at D = 16 a tile is 64 chunks
//     of 8 lanes x 4 units and at D = 1,152 one chunk x 288 units. A run
//     that starts and ends in a chunk is stored at once; a run that crosses
//     chunks is finished by the item where it ends, which adds the partials
//     of the chunks from the one where it began, in lane order; the run
//     open at a tile's end is carried in shared memory into the next tile.
//     Each output row is stored once, with a 16-byte store per unit.
//   - Rows skipped between two lanes are zeroed by the later lane's items.
//     The rows before the first id and after the last (a sampled block's
//     153,600-row tail) are zeroed across the grid by the pass itself,
//     under its first copies, where the first id is at least 0 and the last
//     a valid row; negative or sentinel ids at the ends hide them, and the
//     carry launch zeroes them from the bounds the pass finds. No memset of
//     the [V, D] output.
//   - A run that crosses a span edge leaves a head record (its partial in
//     the span it reaches) and a tail record (in the span where it began).
//     One short carry launch adds each tail and the heads after it in span
//     order, so float32 sums depend only on the data and the grid, and two
//     runs on one card are bitwise equal. int32 takes the same path.
// Launches: the reduction and the carry launch. Offsets are 64-bit: [123.7
// M, 16] is 1.98e9 values. Widths whose one stage of a few lanes does not
// fit in shared memory (D above about 6,000 floats) are refused.
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
// the caller passes the scratch (float32 carries at D = 1, the span records
// at D > 1).
// Each C entry point returns cudaGetLastError() after its launches.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

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

// D > 1: the lanes cut into tiles of L consecutive lanes (a tile's ids and
// its [L, D] values are each one contiguous range of memory), a persistent
// block walking one span of consecutive tiles through a ring of shared-memory
// stages that 1-D bulk copies fill. See the header for the design.
namespace dn {

constexpr int STAGES = 2;               // ring depth of the bulk-copy path
constexpr int STAGE_BYTES = 96 * 1024;  // a stage's ids and values, at most
constexpr int MISC_BYTES = 128;         // the stages' barriers and the block's scalars
constexpr int MAX_THREADS = 1024;
constexpr int MAX_BLOCKS_PER_SM = 8;    // 2,048 threads an SM, at least 256 a block

// How one call cuts its lanes and lays out its threads, the same on the host
// and in the kernel. A thread's work item (p, u) is column unit u (W values)
// of chunk p (K consecutive lanes of the tile), items = P x U.
struct Geometry {
  int d;            // columns
  int units;        // U: column units of W values
  int chunks;       // P: chunks of consecutive lanes a tile is cut into
  int chunk_lanes;  // K: lanes a chunk (P * K >= L)
  int lanes;        // L: lanes a tile (L * 4 and L * D value bytes are multiples of 16)
  int stages;       // ring depth (1 on the plain-load path)
  int ids_bytes;    // L * 4: a stage's ids, then its values
  int stage_bytes;  // L * (4 + D * value bytes)
  int threads;      // a block's threads
  long long n_tiles;
  size_t smem;      // dynamic shared memory a block
};

inline int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// The geometry for units of W values of type T on `blocks` blocks: the most
// stages (up to `stages`) whose tiles of at least `grain` lanes fit in
// max_smem bytes, tiles of at most STAGE_BYTES, and of those the fewest
// tiles that give every block the same count (k tiles a block, L as small
// as k allows). smem = 0 when not even one stage of `grain` lanes fits.
template <typename T, typename A, int W>
Geometry geometry_of(int d, long long n_lanes, int blocks, int stages, size_t max_smem) {
  Geometry g{};
  g.d = d;
  g.units = (d + W - 1) / W;
  g.threads = g.units <= 256 ? 256
              : g.units <= MAX_THREADS ? (g.units + 31) / 32 * 32 : MAX_THREADS;
  g.chunks = g.units <= g.threads ? g.threads / g.units : 1;
  const long long row_bytes = d * static_cast<long long>(sizeof(T));
  const long long lane_bytes = 4 + row_bytes;
  // lanes a tile are a multiple of `grain`, so that both byte counts are
  // multiples of 16 (a stage is then exactly L * lane_bytes)
  const long long m = 16 / gcd(16, static_cast<int>(row_bytes % 16));
  const long long grain = m > 4 ? m : 4;
  const long long fixed = MISC_BYTES + 2 * static_cast<long long>(sizeof(A)) * W *
                          (static_cast<long long>(g.chunks) * g.units + g.units);
  for (; stages >= 1; --stages) {
    long long room = (static_cast<long long>(max_smem) - fixed) / stages;
    if (room > STAGE_BYTES) room = STAGE_BYTES;
    const long long most = room / lane_bytes / grain * grain;
    if (most < grain) continue;
    const long long per_block = (n_lanes + blocks - 1) / blocks;
    const long long k = (per_block + most - 1) / most;  // tiles a block
    long long l = ((per_block + k - 1) / k + grain - 1) / grain * grain;
    if (l > most) l = most;
    g.lanes = static_cast<int>(l);
    g.stages = stages;
    g.ids_bytes = static_cast<int>(l * 4);
    g.stage_bytes = static_cast<int>(l * lane_bytes);
    g.chunk_lanes = static_cast<int>((l + g.chunks - 1) / g.chunks);
    g.n_tiles = (n_lanes + l - 1) / l;
    g.smem = static_cast<size_t>(fixed + stages * l * lane_bytes);
    return g;
  }
  return g;
}

// W values of a column unit, summed in the accumulator's type.
template <typename A, int W>
struct alignas(sizeof(A) * W) Vec {
  A v[W];
};

template <typename A, int W>
__device__ __forceinline__ Vec<A, W> zeros() {
  Vec<A, W> x;
#pragma unroll
  for (int i = 0; i < W; ++i) x.v[i] = 0;
  return x;
}

template <typename A, int W>
__device__ __forceinline__ void add(Vec<A, W>& x, const Vec<A, W>& y) {
#pragma unroll
  for (int i = 0; i < W; ++i) x.v[i] += y.v[i];
}

// A unit's values from a stage (16-byte or 4-byte aligned when W = 4).
template <typename T, typename A, int W>
__device__ __forceinline__ Vec<A, W> load_unit(const T* p) {
  if constexpr (std::is_same<T, A>::value) {
    return *reinterpret_cast<const Vec<A, W>*>(p);
  } else {  // bool bytes -> int32
    Vec<A, W> x;
    if constexpr (W == 4) {
      const uchar4 q = *reinterpret_cast<const uchar4*>(p);
      x.v[0] = q.x, x.v[1] = q.y, x.v[2] = q.z, x.v[3] = q.w;
    } else {
      x.v[0] = static_cast<A>(p[0]);
    }
    return x;
  }
}

template <typename A, int W>
__device__ __forceinline__ void store_unit(A* __restrict__ out, long long row, int d, int u,
                                           const Vec<A, W>& x) {
  *reinterpret_cast<Vec<A, W>*>(out + row * d + u * W) = x;
}

// The 1-D bulk copies (TMA) and their barriers, addressed in the shared
// window: the block's base (shared_base, computed once by every thread at
// the kernel's start) plus offsets, the copies issued from a function that
// is not inlined. Built by nvcc 12.8 with the conversions made inside the
// kernel's thread-0 branches, or with the span's end in an epilogue after
// the tile loop, the kernel faulted on the H100 ("unspecified launch
// failure") at D % 4 == 0, and its CPU emulation did not.
__device__ __forceinline__ unsigned shared_base(const void* smem) {
  return static_cast<unsigned>(__cvta_generic_to_shared(smem));
}

__device__ __forceinline__ void barrier_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void barrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void barrier_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One tile's copies, both completing on `bar`: id_bytes of ids to dst and
// val_bytes of values to dst + val_off (16-byte multiples and addresses),
// after a fence that orders this thread's earlier shared-memory accesses
// before them.
__device__ __noinline__ void issue_tile(unsigned bar, unsigned dst, const void* ids,
                                        unsigned id_bytes, unsigned val_off, const void* vals,
                                        unsigned val_bytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(id_bytes + val_bytes)
               : "memory");
  if (id_bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(dst), "l"(ids), "r"(id_bytes), "r"(bar)
        : "memory");
  if (val_bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(dst + val_off), "l"(vals), "r"(val_bytes), "r"(bar)
        : "memory");
}

// Zeroes out[e0, e1) (4-byte elements; out 16-byte aligned), grid-stride.
template <typename A>
__device__ __forceinline__ void zero_range(A* __restrict__ out, long long e0, long long e1) {
  const long long id = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if (e1 <= e0) return;
  const long long v0 = (e0 + 3) / 4, v1 = e1 / 4;
  if (v1 <= v0) {
    for (long long i = e0 + id; i < e1; i += stride) out[i] = 0;
    return;
  }
  for (long long i = e0 + id; i < 4 * v0; i += stride) out[i] = 0;
  for (long long i = 4 * v1 + id; i < e1; i += stride) out[i] = 0;
  uint4* o = reinterpret_cast<uint4*>(out);
  for (long long i = v0 + id; i < v1; i += stride) o[i] = make_uint4(0, 0, 0, 0);
}

// The block's scalars in shared memory.
struct Misc {
  int row_before;     // row of the lane before the span (-1 before lane 0)
  int row_after;      // row of the lane after the span (-2 past the last lane)
  int lead_end;       // rows [0, lead_end) have no lanes: zeroed by this pass
  int trail_begin;    // rows [trail_begin, n_rows) have no lanes: zeroed by this pass
  int carry_row[2];   // the run open at the end of the last tile, by tile parity
  int carry_head[2];  // whether that run began before the span
};

// The span of block b: tiles [n_tiles * b / nb, n_tiles * (b + 1) / nb).
template <typename T, typename A, int W, bool TMA>
__global__ void __launch_bounds__(MAX_THREADS)
reduce_kernel(const T* __restrict__ vals, const int* __restrict__ seg, long long n_lanes,
              int n_rows, Geometry g, A* __restrict__ out, int* __restrict__ bounds,
              int* __restrict__ carry_rows, A* __restrict__ carry_vals) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned sbase = shared_base(smem);  // barriers at sbase + 8 * stage
  Misc& misc = *reinterpret_cast<Misc*>(smem + 64);
  unsigned char* stage0 = smem + MISC_BYTES;
  const int items = g.chunks * g.units;
  using V = Vec<A, W>;
  V* part_acc = reinterpret_cast<V*>(stage0 + static_cast<size_t>(g.stages) * g.stage_bytes);
  V* part_first = part_acc + items;
  V* carry = part_first + items;  // [2][U]: the open run's partial, by tile parity

  const int tid = threadIdx.x, nt = blockDim.x, d = g.d, K = g.chunk_lanes;
  const int b = blockIdx.x, nb = gridDim.x;
  const long long t_begin = g.n_tiles * b / nb, t_end = g.n_tiles * (b + 1) / nb;
  const int n_k = static_cast<int>(t_end - t_begin);
  const long long span_lo = t_begin * g.lanes;
  const long long span_hi = t_end * g.lanes < n_lanes ? t_end * g.lanes : n_lanes;
  auto row_of = [&](int id) { return seg_reduce::clamp_row(id, n_rows); };
  auto valid = [&](int r) { return r >= 0 && r < n_rows; };

  // tile i of the span into stage i % stages: the 16-byte multiples of its
  // id and value bytes by bulk copies; the few bytes past them (the last
  // tile of the lanes only) are read after the wait
  auto issue = [&](int i) {
    const long long l0 = (t_begin + i) * g.lanes;
    const long long nl = n_lanes - l0 < g.lanes ? n_lanes - l0 : g.lanes;
    const int s = i % g.stages;
    issue_tile(sbase + 8 * s, sbase + MISC_BYTES + s * g.stage_bytes, seg + l0,
               static_cast<unsigned>(nl * 4) & ~15u, g.ids_bytes, vals + l0 * d,
               static_cast<unsigned>(nl * d * sizeof(T)) & ~15u);
  };

  if (tid == 0) {
    if constexpr (TMA) {
#pragma unroll 1
      for (int s = 0; s < g.stages; ++s) barrier_init(sbase + 8 * s);
      barrier_init_fence();
#pragma unroll 1
      for (int i = 0; i < g.stages && i < n_k; ++i) issue(i);
    }
    misc.row_before = span_lo > 0 ? row_of(__ldg(seg + span_lo - 1)) : -1;
    misc.row_after = span_hi < n_lanes ? row_of(__ldg(seg + span_hi)) : -2;
    // where the first id is at least 0 the rows before it have no lanes,
    // and where the last is a valid row the rows after it have none: this
    // pass zeroes both across the grid, under the copies in flight (the
    // carry launch zeroes them where negative or sentinel ids hide them)
    const int first_id = __ldg(seg), last_id = __ldg(seg + n_lanes - 1);
    misc.lead_end = first_id < 0 ? 0 : (first_id < n_rows ? first_id : n_rows);
    misc.trail_begin = last_id >= 0 && last_id < n_rows ? last_id + 1 : n_rows;
    misc.carry_row[0] = misc.row_before;
    misc.carry_head[0] = 1;
  }
  for (int u = tid; u < g.units; u += nt) carry[u] = zeros<A, W>();
  __syncthreads();
  zero_range(out, 0, static_cast<long long>(misc.lead_end) * d);
  zero_range(out, static_cast<long long>(misc.trail_begin) * d, static_cast<long long>(n_rows) * d);

  // what finishes a run: a run that began before the span is the span's
  // head record (the carry launch adds it to the span where the run
  // began); any other valid run is stored
  auto finish = [&](int r, int u, const V& x, bool head) {
    if (head) {
      if (valid(r)) store_unit<A, W>(carry_vals, 2LL * b, d, u, x);
      if (u == 0) carry_rows[2 * b] = valid(r) ? r : -1;
    } else if (valid(r)) {
      store_unit<A, W>(out, r, d, u, x);
    }
  };

  for (int k = 0; k < n_k; ++k) {
    const long long l0 = (t_begin + k) * g.lanes;
    const int nl = static_cast<int>(n_lanes - l0 < g.lanes ? n_lanes - l0 : g.lanes);
    unsigned char* st = stage0 + static_cast<size_t>(k % g.stages) * g.stage_bytes;
    int* ids = reinterpret_cast<int*>(st);
    T* vs = reinterpret_cast<T*>(st + g.ids_bytes);
    const long long n_vals = static_cast<long long>(nl) * d;
    if constexpr (TMA) {
      barrier_wait(sbase + 8 * (k % g.stages), (k / g.stages) & 1);
      const int id_done = (nl * 4 & ~15) / 4;
      const long long val_done = (n_vals * static_cast<long long>(sizeof(T)) & ~15LL) /
                                 static_cast<long long>(sizeof(T));
      if (id_done < nl || val_done < n_vals) {
        for (int i = id_done + tid; i < nl; i += nt) ids[i] = __ldg(seg + l0 + i);
        for (long long i = val_done + tid; i < n_vals; i += nt) vs[i] = vals[l0 * d + i];
        __syncthreads();
      }
    } else {
      for (int i = tid; i < nl; i += nt) ids[i] = __ldg(seg + l0 + i);
      for (long long i = tid; i < n_vals; i += nt) vs[i] = vals[l0 * d + i];
      __syncthreads();
    }
    const int cur = k & 1, nxt = cur ^ 1;
    const int carry_row = misc.carry_row[cur];
    const bool carry_head = misc.carry_head[cur] != 0;
    const V* cin = carry + cur * g.units;
    V* cout = carry + nxt * g.units;

    // 1. each item sums its unit over its chunk's lanes in lane order: the
    //    first run's partial and the last run's go to shared memory, runs
    //    between them are stored; rows skipped between two lanes are
    //    zeroed by the later lane's items, and the rows before the first
    //    valid lane and after the last (zeroed by the carry launch) are
    //    bounded by the lanes where they end
    for (int w = tid; w < items; w += nt) {
      const int p = w / g.units, u = w - p * g.units;
      const int a = p * K;
      if (a >= nl) continue;
      const int e = a + K < nl ? a + K : nl;
      int prev = a == 0 ? carry_row : row_of(ids[a - 1]);
      V acc = zeros<A, W>(), first;
      bool single = true;
      for (int j = a; j < e; ++j) {
        const int r = row_of(ids[j]);
        if (r != prev) {
          if (j > a) {
            if (single) {
              first = acc;
              single = false;
            } else if (valid(prev)) {
              store_unit<A, W>(out, prev, d, u, acc);
            }
            acc = zeros<A, W>();
          }
          if (prev >= 0 && r < n_rows)
            for (int z = prev + 1; z < r; ++z) store_unit<A, W>(out, z, d, u, zeros<A, W>());
          if (u == 0) {
            if (r >= 0 && prev < 0) bounds[0] = r;             // the first valid row
            if (r == n_rows && prev < n_rows) bounds[1] = prev;  // the last, before the sentinels
          }
          prev = r;
        }
        add(acc, load_unit<T, A, W>(vs + static_cast<long long>(j) * d + u * W));
      }
      if (single) first = acc;
      if (u == 0 && l0 + e == n_lanes) {  // the lanes' last lane
        if (prev < 0) bounds[0] = n_rows;    // no valid row
        if (prev < n_rows) bounds[1] = prev;  // no sentinel lane
      }
      part_acc[w] = acc;
      part_first[w] = first;
    }
    __syncthreads();

    // 2. each item finishes the runs that end in its chunk: a run that
    //    began in an earlier chunk adds, in lane order, the open run of the
    //    last tile (if it began there), the last-run partials of the chunks
    //    from the one where it began, and its own first-run partial; the
    //    run open at the tile's end becomes the next tile's carry
    for (int w = tid; w < items; w += nt) {
      const int p = w / g.units, u = w - p * g.units;
      const int a = p * K;
      if (a >= nl) continue;
      const int e = a + K < nl ? a + K : nl;
      const int ra = row_of(ids[a]), rz = row_of(ids[e - 1]);
      const bool single = ra == rz;
      const int prev = a == 0 ? carry_row : row_of(ids[a - 1]);
      V total = part_first[w];
      bool head = false;
      if (ra == prev) {
        int lo = 0, hi = a;  // the tile's first lane of row ra
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (row_of(ids[mid]) < ra) lo = mid + 1; else hi = mid;
        }
        const bool reaches = lo == 0 && carry_row == ra;  // began before this tile
        V sum = reaches ? cin[u] : zeros<A, W>();
        for (int q = lo / K; q < p; ++q) add(sum, part_acc[q * g.units + u]);
        add(sum, total);
        total = sum;
        head = reaches && carry_head;
      }
      const bool last = e == nl;  // the chunk holds the tile's last lane
      const int rn = last ? 0 : row_of(ids[e]);
      if (!single || (!last && rn != ra)) finish(ra, u, total, head);
      if (!single && !last && rn != rz && valid(rz)) store_unit<A, W>(out, rz, d, u, part_acc[w]);
      if (last) {  // the run open at the tile's end
        const V open = single ? total : part_acc[w];
        const bool open_head = single && head;
        if (k + 1 < n_k) {  // carried into the next tile
          cout[u] = open;
          if (u == 0) {
            misc.carry_row[nxt] = rz;
            misc.carry_head[nxt] = open_head;
          }
        } else {  // the span's end: the head record if the run began before the
                  // span, the tail record if it goes on past it, else stored
          const bool tail = !open_head && valid(rz) && misc.row_after == rz;
          if (tail) store_unit<A, W>(carry_vals, 2LL * b + 1, d, u, open);
          else finish(rz, u, open, open_head);
          if (u == 0) carry_rows[2 * b + 1] = tail ? rz : -1;
        }
      }
      if (p == 0 && carry_row != ra) {
        if (k > 0) finish(carry_row, u, cin[u], carry_head);  // the last tile's open run ends
        else if (u == 0) carry_rows[2 * b] = -1;              // no run began before the span
      }
    }
    __syncthreads();
    if constexpr (TMA)
      if (tid == 0 && k + g.stages < n_k) issue(k + g.stages);
  }

}

// After reduce_kernel: each tail record (a run that begins in span b and
// goes on past it) plus the head records of the spans after it that the run
// reaches, in span order, written once; then the rows before the first
// valid row and after the last that the pass left (negative ids first,
// sentinel ids last) are zeroed (all rows when there are no lanes).
template <typename A>
__global__ void carry_kernel(const int* __restrict__ seg, long long n_lanes,
                             const int* __restrict__ bounds, const int* __restrict__ rows,
                             const A* __restrict__ vals, int nb, int d, int n_rows,
                             A* __restrict__ out) {
  const long long id = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = id; i < static_cast<long long>(nb) * d; i += stride) {
    const int b = static_cast<int>(i / d), c = static_cast<int>(i - static_cast<long long>(b) * d);
    const int r = rows[2 * b + 1];
    if (r < 0) continue;
    A s = vals[(2LL * b + 1) * d + c];
    for (int k = b + 1; k < nb && rows[2 * k] == r; ++k) s += vals[2LL * k * d + c];
    out[static_cast<long long>(r) * d + c] = s;
  }
  const int first = n_lanes ? bounds[0] : n_rows, last = n_lanes ? bounds[1] : -1;
  const int after = first > last + 1 ? first : last + 1;
  const int first_id = n_lanes ? __ldg(seg) : -1, last_id = n_lanes ? __ldg(seg + n_lanes - 1) : -1;
  if (first_id < 0) zero_range(out, 0, static_cast<long long>(first) * d);
  if (last_id < 0 || last_id >= n_rows)
    zero_range(out, static_cast<long long>(after) * d, static_cast<long long>(n_rows) * d);
}

// The current device's SMs.
inline int card_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The blocks an SM holds of `kernel` at (threads, smem), kept for the last
// few (kernel, device, threads, shared memory) asked: the host query costs
// more than a small launch.
template <typename K>
int blocks_per_sm(K kernel, int threads, size_t smem) {
  struct Entry {
    const void* kernel;
    int dev, threads;
    size_t smem;
    int per_sm;
  };
  static Entry seen[8] = {};
  static int next = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const void* key = reinterpret_cast<const void*>(kernel);
  for (const Entry& x : seen)
    if (x.kernel == key && x.dev == dev && x.threads == threads && x.smem == smem)
      return x.per_sm;
  Entry x{key, dev, threads, smem, 0};
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&x.per_sm, kernel, threads, smem);
  if (x.per_sm > MAX_BLOCKS_PER_SM) x.per_sm = MAX_BLOCKS_PER_SM;
  if (x.per_sm < 1) x.per_sm = 1;
  seen[next] = x;
  next = (next + 1) % 8;
  return x.per_sm;
}

// The carry launch: records of nb spans (none when seg is null: no lanes).
template <typename A>
void launch_carry(const int* seg, long long n_lanes, const int* scratch, const int* rows,
                  const A* carry_vals, int nb, int d, int n_rows, int sms, A* out,
                  cudaStream_t stream) {
  const long long want = (static_cast<long long>(n_rows) * d / 4 + 255) / 256;
  const long long cb = want < sms * 4LL ? (want > 0 ? want : 1) : sms * 4LL;
  carry_kernel<A><<<static_cast<int>(cb), 256, 0, stream>>>(seg, n_lanes, scratch, rows,
                                                           carry_vals, nb, d, n_rows, out);
}

template <typename T, typename A, int W, bool TMA>
int run(const T* vals, const int* seg, long long n_lanes, int n_rows, int d, A* out,
        int* scratch, cudaStream_t stream) {
  auto kernel = reduce_kernel<T, A, W, TMA>;
  static int most = 0;  // once per instantiation, before any graph capture
  if (most == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  }
  // two blocks an SM where two stages of a tile fit, else one; tiles as
  // large as fit, cut so that every block of the grid gets the same count
  const int sms = card_sms();
  const int stages = TMA ? STAGES : 1;
  Geometry g = geometry_of<T, A, W>(d, n_lanes, 2 * sms, stages, most / 2 - 1024);
  if (g.smem == 0) g = geometry_of<T, A, W>(d, n_lanes, sms, stages, most);
  if (g.smem == 0) return static_cast<int>(cudaErrorInvalidValue);  // d too wide
  long long nb = static_cast<long long>(sms) * blocks_per_sm(kernel, g.threads, g.smem);
  if (nb > g.n_tiles) nb = g.n_tiles;
  // scratch: bounds [2], carry rows [2 * nb], then from the next 16-byte
  // boundary carry values [2 * nb, d]
  int* rows = scratch + 2;
  A* carry_vals = reinterpret_cast<A*>(scratch + (2 + 2 * nb + 3) / 4 * 4);
  kernel<<<static_cast<int>(nb), g.threads, g.smem, stream>>>(vals, seg, n_lanes, n_rows, g,
                                                              out, scratch, rows, carry_vals);
  launch_carry<A>(seg, n_lanes, scratch, rows, carry_vals, static_cast<int>(nb), d, n_rows, sms,
                  out, stream);
  return static_cast<int>(cudaGetLastError());
}

// No lanes: every row is zero (the carry launch alone, with no records).
template <typename A>
int zero_all(int n_rows, int d, A* out, cudaStream_t stream) {
  launch_carry<A>(nullptr, 0, nullptr, nullptr, nullptr, 0, d, n_rows, card_sms(), out, stream);
  return static_cast<int>(cudaGetLastError());
}

// Scratch ints of a call on a card of `sms` SMs: bounds, then a head and a
// tail record (row and d values) for each block.
inline long long scratch_ints(int d, int sms) {
  return 4 + 2LL * MAX_BLOCKS_PER_SM * sms * (d + 1);
}

}  // namespace dn

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
  // D > 1: scratch holds the span records (dn::scratch_ints)
  if (n_lanes == 0) return dn::zero_all<A>(n_rows, d, out, stream);
  int* sc = static_cast<int*>(scratch);
  const bool tma = reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(seg) % 16 == 0;
  if (d % 4 == 0)
    return tma ? dn::run<T, A, 4, true>(vals, seg, n_lanes, n_rows, d, out, sc, stream)
               : dn::run<T, A, 4, false>(vals, seg, n_lanes, n_rows, d, out, sc, stream);
  return tma ? dn::run<T, A, 1, true>(vals, seg, n_lanes, n_rows, d, out, sc, stream)
             : dn::run<T, A, 1, false>(vals, seg, n_lanes, n_rows, d, out, sc, stream);
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
// width d, on a card of `sms` SMs: the float32 carries at d = 1 (for any
// alignment of the ids), none for int32 sums at d = 1; at d > 1 two bounds
// and a head and a tail record (a row and d values) for each block.
extern "C" long long segsum_scratch_ints(long long n_lanes, int n_rows, int d,
                                         int float_sums, int sms) {
  if (d > 1) return dn::scratch_ints(d, sms);
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
