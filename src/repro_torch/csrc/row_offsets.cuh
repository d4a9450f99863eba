// Row offsets of sorted segment ids, for the segment-sum's [E, D] path (K1,
// segsum.cu).
//
// For seg ascending over n_lanes lanes, fills off[r] = lower_bound(seg, r)
// for every r in [0, n_rows], so the lanes of row r are [off[r], off[r+1]).
// Ids below 0 sort before every row and ids at or past n_rows after every
// row: both fall outside every run and contribute nothing.
//
// One thread per row, each a binary search over the ids. Every row costs the
// same whether it has lanes or not, so a run of empty rows (the rows past a
// sampled block's last destination: 153,600 of its 169,984) is filled in
// parallel, not by the one lane that ends it. A warp's 32 consecutive rows
// walk the same upper levels of the search, so those loads are shared and
// cached; only the last few levels diverge.

#pragma once

#include <cuda_runtime.h>

namespace row_offsets {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 8448;  // 64 blocks on each of 132 SMs, grid-stride beyond

__global__ void __launch_bounds__(THREADS)
row_offsets_kernel(const int* __restrict__ seg, long long n_lanes, int n_rows,
                   int* __restrict__ off) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long r = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
       r <= n_rows; r += stride) {
    long long lo = 0, hi = n_lanes;  // the first lane with seg >= r is in [lo, hi]
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (seg[mid] < r) lo = mid + 1; else hi = mid;
    }
    off[r] = static_cast<int>(lo);
  }
}

// Launches the pass on `stream` (n_rows + 1 threads, grid-stride past
// MAX_BLOCKS blocks). The caller checks cudaGetLastError().
inline void launch(const int* seg, long long n_lanes, int n_rows, int* off,
                   cudaStream_t stream) {
  const long long blocks = (static_cast<long long>(n_rows) + THREADS) / THREADS;
  row_offsets_kernel<<<static_cast<int>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS), THREADS,
                       0, stream>>>(seg, n_lanes, n_rows, off);
}

}  // namespace row_offsets
