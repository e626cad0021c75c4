// Chains of sorted anchors, written by hand for Hopper.
//
// Replaces hymet_tpu/models/aligner.py::_chain_reduce_sorted and
// _chain_core (segmented min/max scans, counts from a cummax of start
// indices, the score's segmented cumsum, the good-chain filter and the
// (not good, iota) argsort compaction). Input: A anchors sorted by key
// (key = (k1 << 32 | k2) ^ (1 << 63), k1 = qid << 26 | seq,
// k2 = rel << 24 | band; padding anchors have k1 = k2 = 0xFFFFFFFF) with
// their qpos and rpos. Anchor i + 1 continues anchor i's chain when k1 is
// equal, rel is equal and band[i + 1] - band[i] <= 1 (uint32). Per chain of
// valid anchors (k2 != 0xFFFFFFFF):
//   cnt, min and max of qpos and rpos (unsigned);
//   score = k + sum over its later anchors of clip(qpos[i] - qpos[i-1], 0, k);
//   good  = cnt >= min_cnt and min(cnt * k, maxq - minq + k) >= min_mlen.
// The good chains' rows (qid, seq, rel, cnt, minq, maxq, minr, maxr,
// score) go to rows 0, 1, ... of a [ccap, 9] int32 table in anchor order;
// the rest of the table is zero, and n_chains counts every good chain
// (> ccap means overflow).
//
// Design: a flag pass in which the thread of each chain's first anchor
// walks its chain (the segments are data-dependent and may be thousands of
// anchors long, so one thread a chain needs no carries across blocks; the
// walk reads consecutive anchors, which stay in L1), keeps the good
// chains' numbers in a scratch row at its first anchor and flags it;
// scan_block_counts over the blocks' flags; and a write pass that places
// each flagged row at its block's offset plus a block scan. What bounds it
// on an H100: bytes (each anchor's 16 bytes read once, 36 bytes a good
// chain written; chip_smoke.py::chain_bound_ms); a long chain serialises
// on its one thread, which the bound does not see.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using namespace hymet;

HYMET_SCAN_KERNEL

constexpr int kChainThreads = 256;
constexpr uint32_t kBig = 0xFFFFFFFFu;
constexpr int kStats = 6;  // cnt, minq, maxq, minr, maxr, score

__device__ __forceinline__ uint64_t raw_key(const int64_t* __restrict__ key, long long i) {
  return static_cast<uint64_t>(key[i]) ^ 0x8000000000000000ull;
}

// anchor b continues anchor a's chain (keys in raw form)
__device__ __forceinline__ bool same_chain(uint64_t a, uint64_t b) {
  const uint32_t k1a = static_cast<uint32_t>(a >> 32), k1b = static_cast<uint32_t>(b >> 32);
  const uint32_t k2a = static_cast<uint32_t>(a), k2b = static_cast<uint32_t>(b);
  return k1a == k1b && ((k2a >> 24) & 0xFu) == ((k2b >> 24) & 0xFu) &&
         (k2b & 0xFFFFFFu) - (k2a & 0xFFFFFFu) <= 1u;
}

__global__ void __launch_bounds__(kChainThreads)
chain_flag_kernel(const int64_t* __restrict__ key, const int* __restrict__ s_p,
                  const int* __restrict__ s_r, long long A, int k, int min_cnt, int min_mlen,
                  int* __restrict__ flags, int* __restrict__ stats,
                  int* __restrict__ block_sums) {
  const long long i = static_cast<long long>(blockIdx.x) * kChainThreads + threadIdx.x;
  int good = 0;
  if (i < A) {
    const uint64_t ki = raw_key(key, i);
    const bool start = i == 0 || !same_chain(raw_key(key, i - 1), ki);
    if (start && static_cast<uint32_t>(ki) != kBig) {
      uint32_t minq = static_cast<uint32_t>(s_p[i]), maxq = minq;
      uint32_t minr = static_cast<uint32_t>(s_r[i]), maxr = minr;
      int cnt = 1, score = k, prev_q = s_p[i];
      uint64_t prev = ki;
      for (long long j = i + 1; j < A; ++j) {
        const uint64_t kj = raw_key(key, j);
        if (!same_chain(prev, kj)) break;
        const int qp = s_p[j];
        const uint32_t uq = static_cast<uint32_t>(qp), ur = static_cast<uint32_t>(s_r[j]);
        minq = min(minq, uq);
        maxq = max(maxq, uq);
        minr = min(minr, ur);
        maxr = max(maxr, ur);
        score += min(max(qp - prev_q, 0), k);
        ++cnt;
        prev_q = qp;
        prev = kj;
      }
      const int span_q = static_cast<int>(maxq - minq) + k;
      good = cnt >= min_cnt && min(cnt * k, span_q) >= min_mlen;
      if (good) {
        int* st = stats + kStats * i;
        st[0] = cnt;
        st[1] = static_cast<int>(minq);
        st[2] = static_cast<int>(maxq);
        st[3] = static_cast<int>(minr);
        st[4] = static_cast<int>(maxr);
        st[5] = score;
      }
    }
    flags[i] = good;
  }
  long long total;
  block_exclusive_scan<kChainThreads>(good, &total);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = static_cast<int>(total);
}

__global__ void __launch_bounds__(kChainThreads)
chain_write_kernel(const int64_t* __restrict__ key, long long A, const int* __restrict__ flags,
                   const int* __restrict__ stats, const long long* __restrict__ offsets,
                   const long long* __restrict__ n_chains, long long ccap,
                   int* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kChainThreads + threadIdx.x;
  const int good = i < A ? flags[i] : 0;
  long long total;
  const long long slot = offsets[blockIdx.x] + block_exclusive_scan<kChainThreads>(good, &total);
  if (good && slot < ccap) {
    const uint64_t ki = raw_key(key, i);
    const uint32_t k1 = static_cast<uint32_t>(ki >> 32), k2 = static_cast<uint32_t>(ki);
    const int* st = stats + kStats * i;
    int* row = out + 9 * slot;
    row[0] = static_cast<int>(k1 >> 26);
    row[1] = static_cast<int>(k1 & ((1u << 26) - 1u));
    row[2] = static_cast<int>((k2 >> 24) & 0xFu);
#pragma unroll
    for (int c = 0; c < kStats; ++c) row[3 + c] = st[c];
  }
  // rows past the last good chain hold zeros
  const long long stride = static_cast<long long>(gridDim.x) * kChainThreads;
  for (long long p = *n_chains + i; p < ccap; p += stride) {
#pragma unroll
    for (int c = 0; c < 9; ++c) out[9 * p + c] = 0;
  }
}

}  // namespace

// Launches the flag pass, the scan and the write pass on `stream`; returns
// the first launch error (0 = launched). nb must equal ceil(A / 256); flags
// [A], stats [A, 6] and block_sums [nb] int32, offsets [nb] and n_chains [1]
// int64 are scratch and output. The caller checks dtypes, shapes,
// contiguity and A, ccap below 2^31.
extern "C" int chains_launch(const int64_t* key, const int* s_p, const int* s_r, long long A, int k,
                             int min_cnt, int min_mlen, int nb, int* flags, int* stats,
                             int* block_sums, long long* offsets, long long* n_chains,
                             long long ccap, int* out, void* stream) {
  if (A < 1 || nb != (A + kChainThreads - 1) / kChainThreads) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  chain_flag_kernel<<<nb, kChainThreads, 0, s>>>(key, s_p, s_r, A, k, min_cnt, min_mlen, flags,
                                                 stats, block_sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_block_counts<<<1, kScanThreads, 0, s>>>(block_sums, nb, offsets, n_chains);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_write_kernel<<<nb, kChainThreads, 0, s>>>(key, A, flags, stats, offsets, n_chains, ccap,
                                                  out);
  return static_cast<int>(cudaGetLastError());
}
