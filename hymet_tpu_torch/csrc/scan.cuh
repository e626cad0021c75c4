// Block-wide exclusive scan and the single-block scan of per-block counts,
// shared by the align kernels' compactions (minimizers.cu, anchors.cu,
// chains.cu). Each compaction runs as three launches on one stream: a pass
// that counts each block's items, scan_block_counts, and a pass that
// writes each item at its block's offset plus its rank in the block. The
// order of the output is therefore the row-major order of the input, as
// the JAX package's stable (flag, iota) sorts give it. Each file defines
// its scan kernel with HYMET_SCAN_KERNEL inside its anonymous namespace.

#pragma once

#include <cstdint>

namespace hymet {

constexpr int kScanThreads = 1024;

// Exclusive prefix of v over the block's threads (blockDim.x = NT, a
// multiple of 32); *total receives the block's sum. Every thread of the
// block must call it.
template <int NT>
__device__ __forceinline__ long long block_exclusive_scan(long long v, long long* total) {
  __shared__ long long warp_sums[NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < NT / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < NT / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  const long long before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[NT / 32 - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return before + x - v;
}

// The body of the single-block scan of per-block counts (one block of
// kScanThreads threads): offsets[b] = counts[0] + ... + counts[b - 1] for
// b < nb, and *total = the sum of all nb counts. Each kernel file wraps it
// in its own __global__ (a kernel defined in a header would be defined
// once per file that includes it).
__device__ __forceinline__ void scan_block_counts_body(const int* __restrict__ counts, int nb,
                                                       long long* __restrict__ offsets,
                                                       long long* __restrict__ total) {
  long long carry = 0;
  for (int base = 0; base < nb; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const long long v = i < nb ? counts[i] : 0;
    long long chunk;
    const long long ex = block_exclusive_scan<kScanThreads>(v, &chunk);
    if (i < nb) offsets[i] = carry + ex;
    carry += chunk;
  }
  if (threadIdx.x == 0) *total = carry;
}

}  // namespace hymet

#define HYMET_SCAN_KERNEL                                                              \
  __global__ void __launch_bounds__(hymet::kScanThreads)                              \
  scan_block_counts(const int* __restrict__ counts, int nb,                            \
                    long long* __restrict__ offsets, long long* __restrict__ total) {  \
    hymet::scan_block_counts_body(counts, nb, offsets, total);                         \
  }
