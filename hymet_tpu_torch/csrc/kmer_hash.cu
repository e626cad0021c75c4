// Canonical k-mer MurmurHash3 for the sketch screen, written by hand for Hopper.
//
// Replaces hymet_tpu/ops/pallas_kernels.py::_hash_tile_kernel (kmer_hashes_pallas).
// For every k-window of a [B, L] uint8 code batch (0-3 = ACGT, >= 4 invalid):
//   valid  = no code >= 4 in the window;
//   canon  = min(forward, reverse complement) of the 2-bit packed k-mer
//            (codes taken & 3, so invalid windows still get a defined hash);
//   hash   = MurmurHash3_x64_128 h1, seed 42, of canon's ASCII bytes
//            (A=65 C=67 G=71 T=84), stored as the uint64 bit pattern in int64.
// Output covers exactly the L - k + 1 windows of each row; no tile padding.
//
// What bounds it on an H100. The function needs about 170 64-bit integer
// operations per window at k=21 (a rolling update of the packed words, the
// ASCII bytes, Murmur) against 10 bytes of traffic (1 code in, 8 hash + 1 valid
// out): just under the card's ~20 operations per byte balance point, so its
// least time is set by memory. This kernel instead repacks every window from its
// k codes (about 330 operations per window), which puts it over the balance
// point: its own integer work bounds it. The design spends nothing on memory
// tricks beyond reading each code from device memory once: a block stages its
// blockDim + k - 1 codes in shared memory, and each thread (one per window)
// reads its k codes from there. The TPU kernel's lane rolls and uint32 limb
// arithmetic are gone: the card has native 64-bit shifts, compares and
// multiplies. A rolling update across windows, reading 2-bit packed input and
// fusing the count are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 32;
constexpr uint64_t kSeed = 42;
constexpr uint64_t kC1 = 0x87C37B91114253D5ull;
constexpr uint64_t kC2 = 0x4CF5AD432745937Full;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xFF51AFD7ED558CCDull;
  k ^= k >> 33;
  k *= 0xC4CEB9FE1A85EC53ull;
  k ^= k >> 33;
  return k;
}

__global__ void __launch_bounds__(kThreads)
kmer_hash_kernel(const uint8_t* __restrict__ codes, int64_t* __restrict__ hash,
                 bool* __restrict__ valid, int L, int k) {
  __shared__ uint8_t slab[kThreads + kMaxK - 1];
  const int n = L - k + 1;
  const int row = blockIdx.y;
  const int base = blockIdx.x * kThreads;
  const uint8_t* src = codes + static_cast<size_t>(row) * L;
  for (int i = threadIdx.x; i < kThreads + k - 1; i += kThreads) {
    const int p = base + i;
    slab[i] = p < L ? src[p] : 4;
  }
  __syncthreads();

  const int w = base + threadIdx.x;
  if (w >= n) return;
  const uint8_t* s = slab + threadIdx.x;

  // Forward k-mer packed most-significant base first; the reverse complement
  // packed so that base j lands at bits 2j. k <= 32 keeps every shift < 64.
  uint64_t fwd = 0, rc = 0;
  bool ok = true;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) {
      uint32_t c = s[j];
      ok &= c < 4;
      c &= 3u;
      fwd = (fwd << 2) | c;
      rc |= static_cast<uint64_t>(3u - c) << (2 * j);
    }
  }
  const uint64_t canon = fwd <= rc ? fwd : rc;

  // The k ASCII bytes of canon, little-endian into four 64-bit words
  // (bytes past k stay zero, which is how Murmur reads its tail).
  uint64_t word[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) {
      const uint32_t b = static_cast<uint32_t>(canon >> (2 * (k - 1 - j))) & 3u;
      const uint64_t ch = b == 0 ? 65u : b == 1 ? 67u : b == 2 ? 71u : 84u;
      word[j >> 3] |= ch << (8 * (j & 7));
    }
  }

  uint64_t h1 = kSeed, h2 = kSeed;
  const int nblocks = k >> 4;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if (b < nblocks) {
      uint64_t k1 = word[2 * b], k2 = word[2 * b + 1];
      k1 *= kC1;
      k1 = rotl64(k1, 31);
      k1 *= kC2;
      h1 ^= k1;
      h1 = rotl64(h1, 27);
      h1 += h2;
      h1 = h1 * 5 + 0x52DCE729;
      k2 *= kC2;
      k2 = rotl64(k2, 33);
      k2 *= kC1;
      h2 ^= k2;
      h2 = rotl64(h2, 31);
      h2 += h1;
      h2 = h2 * 5 + 0x38495AB5;
    }
  }
  const int tail = k & 15;
  const uint64_t t1 = nblocks == 0 ? word[0] : word[2];
  const uint64_t t2 = nblocks == 0 ? word[1] : word[3];
  if (tail > 8) {
    uint64_t k2 = t2 * kC2;
    k2 = rotl64(k2, 33);
    h2 ^= k2 * kC1;
  }
  if (tail > 0) {
    uint64_t k1 = t1 * kC1;
    k1 = rotl64(k1, 31);
    h1 ^= k1 * kC2;
  }
  h1 ^= static_cast<uint64_t>(k);
  h2 ^= static_cast<uint64_t>(k);
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1) + fmix64(h2);

  const size_t out = static_cast<size_t>(row) * n + w;
  hash[out] = static_cast<int64_t>(h1);
  valid[out] = ok;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// The caller checks 1 <= k <= 32, L >= k, 1 <= B <= 65535 and contiguity.
extern "C" int kmer_hash_launch(const uint8_t* codes, int64_t* hash, bool* valid,
                                int B, int L, int k, void* stream) {
  const int n = L - k + 1;
  const dim3 grid((n + kThreads - 1) / kThreads, B);
  kmer_hash_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      codes, hash, valid, L, k);
  return static_cast<int>(cudaGetLastError());
}
