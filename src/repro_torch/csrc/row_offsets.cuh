// Row offsets of sorted segment ids, for the segment-sum's [E, D] path (K1,
// segsum.cu).
//
// For seg ascending over n_lanes lanes, fills off[r] = lower_bound(seg, r)
// for every r in [0, n_rows], so the lanes of row r are [off[r], off[r+1]).
// Ids below 0 sort before every row and ids at or past n_rows after every
// row: both fall outside every run and contribute nothing.
//
// One thread per lane, coalesced: lane e starts the rows (id[e-1], id[e]],
// so it writes off[r] = e for them and every off[r] is written exactly once.

#pragma once

#include <cuda_runtime.h>

namespace row_offsets {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 8448;  // 64 blocks on each of 132 SMs, grid-stride beyond

// Row of lane e for the offset pass: ids below 0 sort before every row
// (-1), ids at or past the end after every row (n_rows).
__device__ __forceinline__ int row_of(const int* __restrict__ seg, long long e,
                                      long long n_lanes, int n_rows) {
  if (e < 0) return -1;
  if (e >= n_lanes) return n_rows;
  const int s = seg[e];
  return s < 0 ? -1 : (s > n_rows ? n_rows : s);
}

__global__ void __launch_bounds__(THREADS)
row_offsets_kernel(const int* __restrict__ seg, long long n_lanes, int n_rows,
                   int* __restrict__ off) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long e = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
       e <= n_lanes; e += stride) {
    const int cur = row_of(seg, e, n_lanes, n_rows);
    const int prev = row_of(seg, e - 1, n_lanes, n_rows);
    for (int r = prev + 1; r <= cur; ++r) off[r] = static_cast<int>(e);
  }
}

// Launches the pass on `stream` (n_lanes + 1 threads, grid-stride past
// MAX_BLOCKS blocks). The caller checks cudaGetLastError().
inline void launch(const int* seg, long long n_lanes, int n_rows, int* off,
                   cudaStream_t stream) {
  const long long blocks = (n_lanes + THREADS) / THREADS;
  row_offsets_kernel<<<static_cast<int>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS), THREADS,
                       0, stream>>>(seg, n_lanes, n_rows, off);
}

}  // namespace row_offsets
