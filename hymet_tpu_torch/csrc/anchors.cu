// Anchors of a batch's kept minimizers, written by hand for Hopper: the
// index search and the anchor expansion with its sort keys.
//
// Replaces hymet_tpu/models/aligner.py::_search_occ (the lower-bound
// search of each minimizer's 64-bit hash in the index's unique-hash table,
// then (left, occ) from the run-offset table) and the default branch of
// _collect_anchors_slots (the occurrence filter, the slot compaction of
// every kept occurrence by exclusive cumsum, slot_fill_mono and
// slot_fill_delta, the gather of the index payload and the packed keys).
// For minimizer n < n_kept, with hash q:
//   lo = first u with uniq[u] >= q (unsigned); occ = end - start of row lo
//   of roff when uniq[lo] == q, else 0; keep = 1 <= occ <= max_occ;
// minimizer n's occurrences j < occ go to slots basex[n] + j (basex the
// exclusive prefix of the kept occ) below acap, each with, from
// ps[start + j] = (rpos, seq << 1 | strand):
//   rel  = minimizer strand ^ index strand;
//   diag = rpos - qpos, or rpos + qpos when rel = 1;
//   band = (diag + 2^28) >> band_bits;
//   key  = ((qid << 26 | seq) << 32 | rel << 24 | band) ^ (1 << 63)
// (the JAX package's two uint32 sort keys k1, k2 as one int64 whose signed
// order is their lexicographic unsigned order), qpos and rpos. Slots from
// min(n_anchors, acap) on hold key = INT64_MAX (k1 = k2 = 0xFFFFFFFF) and
// zeros; n_anchors counts every kept occurrence (> acap means overflow).
//
// Design: a search pass (one thread a minimizer, a binary search of about
// log2(U) = 23 dependent 8-byte loads at U = 8 M unique hashes; the JAX
// package's top-bits bucket table confines nothing at 2k = 38-bit hashes,
// where every hash falls in bucket 0), scan_block_counts over the blocks'
// kept occurrences, and an expansion pass (one thread a minimizer writes
// its <= max_occ anchors; its slot base is the block's offset plus a
// block scan). What bounds it on an H100: the search's dependent loads,
// one chain a minimizer, hidden only by the number of minimizers in
// flight; they hit L2, which holds the whole table (8 bytes a unique hash).
// In bytes: 25 a minimizer, each table entry the searches touch once, 24 an
// anchor and the 8-byte sentinel key of each empty slot
// (chip_smoke.py::anchor_bound_ms counts them).

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using namespace hymet;

HYMET_SCAN_KERNEL

constexpr int kAncThreads = 256;
constexpr long long kKeyPad = 0x7FFFFFFFFFFFFFFFLL;

__global__ void __launch_bounds__(kAncThreads)
anchor_search_kernel(const int64_t* __restrict__ hash, const long long* __restrict__ n_kept,
                     int cap, const int64_t* __restrict__ uniq, int U,
                     const int* __restrict__ roff, int max_occ, int* __restrict__ occk,
                     int* __restrict__ left, int* __restrict__ block_sums) {
  const int n = blockIdx.x * kAncThreads + threadIdx.x;
  int occ = 0, start = 0;
  if (n < cap && n < *n_kept) {
    const uint64_t q = static_cast<uint64_t>(hash[n]);
    int lo = 0, hi = U;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (static_cast<uint64_t>(__ldg(uniq + mid)) < q) lo = mid + 1; else hi = mid;
    }
    if (lo < U && static_cast<uint64_t>(__ldg(uniq + lo)) == q) {
      start = __ldg(roff + 2 * lo);
      const int o = __ldg(roff + 2 * lo + 1) - start;
      if (o >= 1 && o <= max_occ) occ = o;
    }
  }
  if (n < cap) {
    occk[n] = occ;
    left[n] = start;
  }
  long long total;
  block_exclusive_scan<kAncThreads>(occ, &total);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = static_cast<int>(total);
}

__global__ void __launch_bounds__(kAncThreads)
anchor_expand_kernel(const int* __restrict__ pos, const uint8_t* __restrict__ strand,
                     const int* __restrict__ rows, int cap, const int* __restrict__ occk,
                     const int* __restrict__ left, const long long* __restrict__ offsets,
                     const long long* __restrict__ n_anchors, const int* __restrict__ ps,
                     int band_bits, long long acap, int64_t* __restrict__ key,
                     int* __restrict__ qpos, int* __restrict__ rpos) {
  const int n = blockIdx.x * kAncThreads + threadIdx.x;
  const int occ = n < cap ? occk[n] : 0;
  long long total;
  const long long base = offsets[blockIdx.x] + block_exclusive_scan<kAncThreads>(occ, &total);
  if (occ) {
    const int qp = pos[n], qs = strand[n], qid = rows[n], a = left[n];
    for (int j = 0; j < occ && base + j < acap; ++j) {
      const int rp = __ldg(ps + 2 * (a + j));
      const int sv = __ldg(ps + 2 * (a + j) + 1);
      const uint32_t rel = static_cast<uint32_t>(qs ^ sv) & 1u;
      const int diag = rel ? rp + qp : rp - qp;
      const uint32_t band = static_cast<uint32_t>((diag + (1 << 28)) >> band_bits);
      const uint32_t k1 = static_cast<uint32_t>(qid) << 26 | static_cast<uint32_t>(sv >> 1);
      const uint32_t k2 = rel << 24 | band;
      const uint64_t packed = static_cast<uint64_t>(k1) << 32 | k2;
      key[base + j] = static_cast<int64_t>(packed ^ 0x8000000000000000ull);
      qpos[base + j] = qp;
      rpos[base + j] = rp;
    }
  }
  // slots past the last anchor: the sentinel key, zeros
  const long long stride = static_cast<long long>(gridDim.x) * kAncThreads;
  for (long long p = *n_anchors + n; p < acap; p += stride) {
    key[p] = kKeyPad;
    qpos[p] = 0;
    rpos[p] = 0;
  }
}

}  // namespace

// Launches the search pass, the scan and the expansion pass on `stream`;
// returns the first launch error (0 = launched). nb must equal
// ceil(cap / 256); occk, left [cap] and block_sums [nb] int32, offsets [nb]
// and n_anchors [1] int64 are scratch and output. The caller checks dtypes,
// shapes, contiguity and that cap, U and acap are below 2^31.
extern "C" int anchors_launch(const int64_t* hash, const int* pos, const uint8_t* strand,
                              const int* rows, const long long* n_kept, int cap,
                              const int64_t* uniq, int U, const int* roff, const int* ps,
                              int max_occ, int band_bits, int nb, int* occk, int* left,
                              int* block_sums, long long* offsets, long long* n_anchors,
                              long long acap, int64_t* key, int* qpos, int* rpos, void* stream) {
  if (cap < 1 || nb != (cap + kAncThreads - 1) / kAncThreads) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  anchor_search_kernel<<<nb, kAncThreads, 0, s>>>(hash, n_kept, cap, uniq, U, roff, max_occ, occk,
                                                  left, block_sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_block_counts<<<1, kScanThreads, 0, s>>>(block_sums, nb, offsets, n_anchors);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  anchor_expand_kernel<<<nb, kAncThreads, 0, s>>>(pos, strand, rows, cap, occk, left, offsets,
                                                  n_anchors, ps, band_bits, acap, key, qpos, rpos);
  return static_cast<int>(cudaGetLastError());
}
