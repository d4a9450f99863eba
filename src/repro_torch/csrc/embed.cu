// Fused gather and segment-sum (K5) for Hopper (sm_90a):
//
//     out[s, t, :] = sum over e with seg[e] == s of w[t, e] * table[t, gather[t, e], :]
//
// for T tables [T, R, D] float32, gather ids of T x E lanes int32, one shared
// seg [E] int32 in ascending order, optional weights [T, E] float32, and out
// [V, T, D] float32 (T = 1 is the single-table [V, D]). Gather ids outside
// [0, R) and segment ids outside [0, V) contribute nothing; sums are float32.
// The ids may be strided: lane e of table t is at
//
//     gather + t * t_stride + (e / cols) * row_stride + e % cols
//
// so a [T, E] array (cols = E) and a [T, E1, E2] view whose last axis is
// contiguous (cols = E2), such as DCN-v2's ids [B, T, M] seen as [T, B, M],
// are read where they lie, without a transposing copy.
//
// Replaces: src/repro/kernels/ops.py:segment_embed (_segment_embed_jit), which
// on the TPU gathers the rows into [E, D] (padded to 128 columns), weights and
// masks them, and hands them to the one-hot segment-sum K1
// (src/repro/kernels/segsum.py, pl.pallas_call). It carries DCN-v2's
// EmbeddingBag (src/repro/models/recsys.py:embedding_bag), once for all 26
// tables.
//
// What bounds it: memory. Each lane reads a 4-byte id and one D-float row,
// chosen at random from a table far larger than L2 (26 x 10^6 x 64 bytes), and
// each bag writes D floats once: at DCN-v2's serving batch (262,144 bags of 4
// ids, 26 tables) about 2.3 GB against 0.44 G adds, so the least time is
// bytes / 3.35 TB/s. Rows are 64 bytes read at random, so the rate that
// counts is the card's for random 64-byte reads: gather_ceiling below
// measures it on the same ids.
//
// What the design does about it: the gathered rows are never written. Done as
// gather then K1, as on the TPU, the [T, E, D] rows (1.74 GB at that batch)
// would be written and read again; here they go from the table into
// registers and only the sums are stored. One launch: a group of G threads
// owns one (table, bag); each thread owns VEC = 4 consecutive floats of the
// row (one 16-byte load; a scalar path takes rows that are not 16-byte
// aligned), so at D = 16 a group is 4 threads and a warp serves 8 bags.
//
//   - The bag's lane range [lower_bound(seg, s), lower_bound(seg, s + 1))
//     comes from seg itself: a guess at s * E / V (exact for bags of equal
//     size, as an EmbeddingBag's are), checked with two loads issued
//     together, then an exponential search from the guess when it misses.
//     No offset pass, no scratch, one launch.
//   - The group reads the bag's ids four at a time (one 16-byte load where
//     four lanes lie in one row and aligned), then issues the four row loads
//     before it adds any, so four rows are in flight per thread.
//   - Lanes are added in order and each output row has one writer: no
//     atomics, and two runs are bitwise equal.
//   - Tables go down the grid's y axis, so the blocks of one table run
//     together and rows read twice can hit L2 (a table is 64 MB against a
//     50 MB L2): the gather ceiling below reads DCN-v2's serve_bulk rows in
//     0.69 ms table by table and in 0.95 ms with all tables interleaved
//     (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 10). Where the ids
//     of neighbouring tables share a 32-byte sector, as in the [T, B, M]
//     view of [B, T, M] ids, tables go in pairs, so both halves of the
//     sector are used while it is in L2.
//
// What was measured and not kept (same card, chip_smoke.py phase 10; PERF.md
// has the numbers): one group walking eight bags with the next chunk's ids
// prefetched, four bags a group with all sixteen ids loaded at once, fewer
// registers forced by __launch_bounds__, L1-bypassing row loads, streaming
// stores, and an L2 evict-first policy on the ids and the stores. Each was
// slower or no faster than the spread between runs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4;  // lanes whose ids and rows are loaded together

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (the divisor's magic
// number is computed once on the host).
struct FastDiv {
  unsigned d, magic, shift;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

FastDiv make_fastdiv(unsigned d) {
  unsigned shift = 0;
  while (shift < 32 && (1ull << shift) < d) ++shift;
  const unsigned long long one = 1;
  const unsigned magic =
      static_cast<unsigned>(((one << 32) * ((one << shift) - d)) / d + 1);
  return {d, magic, shift};
}

// Where the ids of one table lie: lane e at p + (e / cols) * row_stride +
// e % cols.
struct Ids {
  const int* p;
  long long row_stride;
  FastDiv cols;

  __device__ __forceinline__ const int* at(int e) const {
    const unsigned r = cols.div(static_cast<unsigned>(e));
    return p + static_cast<long long>(r) * row_stride + (e - static_cast<int>(r * cols.d));
  }

  // The ids of lanes [e, e + CHUNK), -1 at and past `end`: one 16-byte load
  // where the four lie in one row and aligned.
  __device__ __forceinline__ void chunk(int e, int end, int (&id)[CHUNK]) const {
    const unsigned r = cols.div(static_cast<unsigned>(e));
    const int col = e - static_cast<int>(r * cols.d);
    const int* q = p + static_cast<long long>(r) * row_stride + col;
    if (e + CHUNK <= end && col + CHUNK <= static_cast<int>(cols.d) && aligned16(q)) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(q));
      id[0] = x.x; id[1] = x.y; id[2] = x.z; id[3] = x.w;
      return;
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) id[k] = e + k < end ? __ldg(at(e + k)) : -1;
  }
};

template <int VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) r[j] = __ldg(p + j);
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* p, const float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = r[j];
  }
}

// First e in [0, n) with seg[e] >= v (n if none), for seg ascending, searched
// from the guess g in [0, n]: an exponential search outwards from it, then a
// binary search in the bracket.
__device__ __noinline__ int lower_bound_from(const int* __restrict__ seg, int n, int v, int g) {
  long long lo, hi;  // seg[lo] < v (lo = -1: none), seg[hi] >= v (hi = n: none)
  if (g < n && __ldg(seg + g) < v) {
    lo = g;
    for (long long step = 1;; step *= 2) {
      hi = lo + step;
      if (hi >= n) { hi = n; break; }
      if (__ldg(seg + hi) >= v) break;
      lo = hi;
    }
  } else {
    hi = g;
    for (long long step = 1;; step *= 2) {
      lo = hi - step;
      if (lo < 0) { lo = -1; break; }
      if (__ldg(seg + lo) < v) break;
      hi = lo;
    }
  }
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    if (__ldg(seg + mid) < v) lo = mid;
    else hi = mid;
  }
  return static_cast<int>(hi);
}

// lower_bound(seg, v) for 0 <= v <= n_bags: the guess v * n / n_bags is
// checked with two loads issued together, and searched from when it misses.
__device__ __forceinline__ int bag_start(const int* __restrict__ seg, int n, int n_bags,
                                         int v) {
  const int g = static_cast<int>(static_cast<long long>(v) * n / n_bags);
  const int before = g > 0 ? __ldg(seg + g - 1) : INT32_MIN;
  const int at = g < n ? __ldg(seg + g) : INT32_MAX;
  if (before < v && at >= v) return g;
  return lower_bound_from(seg, n, v, g);
}

struct Problem {
  const float* tables;
  long long n_rows;
  int d, n_tables, group, tg;  // tg: tables a pass (grid y = ceil(n_tables / tg))
  const int* gather;
  long long t_stride, row_stride;
  FastDiv cols;
  const float* weights;  // [n_tables, n_lanes] or null
  const int* seg;
  int n_lanes, n_bags;
  float* out;
};

// The group's unit of work (a bag; the ceiling's 16 lanes) and table from its
// place in the grid: tg tables a pass on the grid's y axis, the table
// fastest within a pass.
__device__ __forceinline__ bool group_place(const Problem& P, int& unit, int& t) {
  const long long q =
      static_cast<long long>(blockIdx.x) * (THREADS / P.group) + threadIdx.x / P.group;
  unit = static_cast<int>(q / P.tg);
  t = blockIdx.y * P.tg + static_cast<int>(q % P.tg);
  return t < P.n_tables;
}

// One (table, bag) a group: its bounds, then its ids, then its rows.
template <int VEC, bool WEIGHTED>
__global__ void __launch_bounds__(THREADS) embed_kernel(const Problem P) {
  int bag, t;
  if (!group_place(P, bag, t) || bag >= P.n_bags) return;
  const int lane = threadIdx.x % P.group;
  const int a = bag_start(P.seg, P.n_lanes, P.n_bags, bag);
  const int b = bag_start(P.seg, P.n_lanes, P.n_bags, bag + 1);
  const Ids ids{P.gather + t * P.t_stride, P.row_stride, P.cols};
  const float* __restrict__ w = WEIGHTED ? P.weights + static_cast<long long>(t) * P.n_lanes
                                         : nullptr;
  const float* __restrict__ tab = P.tables + t * P.n_rows * P.d;
  float* dst = P.out + (static_cast<long long>(bag) * P.n_tables + t) * P.d;
  for (int c = lane; c < P.d / VEC; c += P.group) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int e = a; e < b; e += CHUNK) {
      int id[CHUNK];
      float r[CHUNK][VEC];
      ids.chunk(e, b, id);
#pragma unroll
      for (int k = 0; k < CHUNK; ++k)
        if (id[k] >= 0 && id[k] < P.n_rows)
          load_row<VEC>(tab + static_cast<long long>(id[k]) * P.d + c * VEC, r[k]);
#pragma unroll
      for (int k = 0; k < CHUNK; ++k)
        if (id[k] >= 0 && id[k] < P.n_rows) {
          const float wt = WEIGHTED ? __ldg(w + e + k) : 1.f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += wt * r[k][j];
        }
    }
    store_row<VEC>(dst + c * VEC, acc);
  }
}

template <int VEC>
void launch_embed(Problem P, cudaStream_t stream) {
  P.group = 1;  // threads per (table, bag): enough for the row, at most a warp
  while (P.group < P.d / VEC && P.group < 32) P.group *= 2;
  const long long per_block = THREADS / P.group;
  const long long blocks = (static_cast<long long>(P.n_bags) * P.tg + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(blocks), (P.n_tables + P.tg - 1) / P.tg);
  if (P.weights) embed_kernel<VEC, true><<<grid, THREADS, 0, stream>>>(P);
  else embed_kernel<VEC, false><<<grid, THREADS, 0, stream>>>(P);
}

// The ceiling of the gather: the same lanes' rows read with the same ids in
// the same order (tg tables a pass), with no bag structure. A group of 4
// threads reads 16 consecutive lanes of one table, each thread its 16-byte
// quarter of each row, eight rows in flight; each thread folds its rows into
// one register and writes one word. With `out`, it also stores each four
// lanes' sum to out[(lane / 4) * T + t] as K5 stores a bag of 4 (the same
// [B, T, 16] writes), so the two show what the bag bounds cost on top.
constexpr int CEIL_LANES = 16;

template <bool OUT>
__global__ void __launch_bounds__(THREADS) gather_ceiling_kernel(const Problem P, float* sink) {
  int chunk, t;
  if (!group_place(P, chunk, t) || chunk >= P.n_lanes / CEIL_LANES) return;
  const int quarter = threadIdx.x % 4;
  const Ids ids{P.gather + t * P.t_stride, P.row_stride, P.cols};
  const float* tab = P.tables + t * P.n_rows * 16 + quarter * 4;
  float acc = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int e = chunk * CEIL_LANES + 8 * half;
    const int4 i0 = __ldg(reinterpret_cast<const int4*>(ids.at(e)));
    const int4 i1 = __ldg(reinterpret_cast<const int4*>(ids.at(e + 4)));
    const int id[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
    float4 r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      r[k] = __ldg(reinterpret_cast<const float4*>(tab + static_cast<long long>(id[k]) * 16));
    if constexpr (OUT) {
#pragma unroll
      for (int bag = 0; bag < 2; ++bag) {
        float4 s = r[4 * bag];
#pragma unroll
        for (int k = 1; k < 4; ++k) {
          s.x += r[4 * bag + k].x; s.y += r[4 * bag + k].y;
          s.z += r[4 * bag + k].z; s.w += r[4 * bag + k].w;
        }
        const long long row = static_cast<long long>(e / 4 + bag) * P.n_tables + t;
        *reinterpret_cast<float4*>(P.out + row * 16 + quarter * 4) = s;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += r[k].x + r[k].y + r[k].z + r[k].w;
    }
  }
  if constexpr (!OUT)
    sink[(static_cast<long long>(t) * (P.n_lanes / CEIL_LANES) + chunk) * 4 + quarter] = acc;
}

Problem make_problem(const void* tables, long long n_rows, int d, int n_tables,
                     const void* gather, long long t_stride, long long row_stride,
                     long long cols, long long n_lanes, const void* seg, const void* weights,
                     int n_bags, void* out, int tg) {
  // tg <= 0: pair the tables when a bag's ids of neighbouring tables share a
  // 32-byte sector, else one table a pass
  Problem P;
  P.tables = static_cast<const float*>(tables);
  P.n_rows = n_rows;
  P.d = d;
  P.n_tables = n_tables;
  P.group = 4;
  if (tg <= 0) tg = t_stride > 0 && t_stride * sizeof(int) < 32 ? 2 : 1;
  P.tg = tg > n_tables ? n_tables : tg;
  P.gather = static_cast<const int*>(gather);
  P.t_stride = t_stride;
  P.row_stride = row_stride;
  P.cols = make_fastdiv(static_cast<unsigned>(cols < 1 ? 1 : cols));
  P.weights = static_cast<const float*>(weights);
  P.seg = static_cast<const int*>(seg);
  P.n_lanes = static_cast<int>(n_lanes);
  P.n_bags = n_bags;
  P.out = static_cast<float*>(out);
  return P;
}

}  // namespace

// tables [n_tables, n_rows, d]; lane e of table t's gather id at gather +
// t * t_stride + (e / cols) * row_stride + e % cols; weights (nullable)
// [n_tables, n_lanes] contiguous; seg [n_lanes] ascending; out [n_bags,
// n_tables, d]; all float32 or int32; n_lanes, n_bags < 2^31.
extern "C" int segment_embed_f32(const void* tables, long long n_rows, int d, int n_tables,
                                 const void* gather, long long t_stride, long long row_stride,
                                 long long cols, long long n_lanes, const void* seg,
                                 const void* weights, int n_bags, void* out,
                                 void* stream_ptr) {
  if (n_bags <= 0 || d <= 0 || n_tables <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Problem P = make_problem(tables, n_rows, d, n_tables, gather, t_stride, row_stride,
                                 cols, n_lanes, seg, weights, n_bags, out, 0);
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(tables) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) launch_embed<4>(P, stream);
  else launch_embed<1>(P, stream);
  return static_cast<int>(cudaGetLastError());
}

// Diagnostic: gather_ceiling over tables [n_tables, n_rows, 16] and ids
// addressed as segment_embed_f32's (cols a multiple of 4, rows 16-byte
// aligned, n_lanes a multiple of 16, every id in [0, n_rows)), tg tables a
// pass (0: as segment_embed_f32 chooses); sink [n_tables * n_lanes / 4]
// floats, or, with out (nullable, [n_lanes / 4, n_tables, 16]), the sums of
// each four lanes.
extern "C" int gather_ceiling_f32(const void* tables, long long n_rows, int n_tables,
                                  const void* gather, long long t_stride, long long row_stride,
                                  long long cols, long long n_lanes, int tg, void* sink,
                                  void* out, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_lanes < CEIL_LANES || n_tables <= 0) return 0;
  const Problem P = make_problem(tables, n_rows, 16, n_tables, gather, t_stride, row_stride,
                                 cols, n_lanes, nullptr, nullptr, 1, out, tg);
  const long long per_block = THREADS / 4;
  const long long blocks = (n_lanes / CEIL_LANES * P.tg + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(blocks), (n_tables + P.tg - 1) / P.tg);
  if (out) gather_ceiling_kernel<true><<<grid, THREADS, 0, stream>>>(P, nullptr);
  else gather_ceiling_kernel<false><<<grid, THREADS, 0, stream>>>(P, static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}

// The text of a CUDA error code, for the wrapper's exception.
extern "C" const char* embed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
