// hymetio: native host-side helpers for hymet_tpu_torch's CPU path.
//
// Speeds up the host paths that run when the port runs on the CPU
// (device="cpu"): sequence encoding, canonical k-mer MurmurHash3
// (Mash-compatible: ASCII bytes of the lexicographically smaller strand,
// seed 42, first 64 bits) for the DB build, and minimizer extraction
// (minimap2 hash64 over 2k-bit packed canonical k-mers, leftmost-min
// winnowing) for the index build — the same semantics as the numpy
// versions in hymet_tpu_torch/ops/{hashing,minimizer}.py, checked against
// them in tests/test_torch_native_io.py. The card's paths keep their CUDA
// kernels.
//
// Built at first use by hymet_tpu_torch/io/native_io.py with the host
// compiler (c++ -O3 -std=c++17 -fPIC -shared) into build/, and loaded
// with ctypes.

#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

constexpr uint64_t kSeed = 42;

inline uint64_t rotl64(uint64_t x, int8_t r) {
  return (x << r) | (x >> (64 - r));
}

inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

// MurmurHash3_x64_128, first 64 bits (h1).
uint64_t murmur3_h1(const uint8_t* data, int len, uint64_t seed) {
  const int nblocks = len / 16;
  uint64_t h1 = seed, h2 = seed;
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;

  for (int i = 0; i < nblocks; i++) {
    uint64_t k1, k2;
    std::memcpy(&k1, data + i * 16, 8);
    std::memcpy(&k2, data + i * 16 + 8, 8);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
  }

  const uint8_t* tail = data + nblocks * 16;
  uint64_t k1 = 0, k2 = 0;
  switch (len & 15) {
    case 15: k2 ^= uint64_t(tail[14]) << 48; [[fallthrough]];
    case 14: k2 ^= uint64_t(tail[13]) << 40; [[fallthrough]];
    case 13: k2 ^= uint64_t(tail[12]) << 32; [[fallthrough]];
    case 12: k2 ^= uint64_t(tail[11]) << 24; [[fallthrough]];
    case 11: k2 ^= uint64_t(tail[10]) << 16; [[fallthrough]];
    case 10: k2 ^= uint64_t(tail[9]) << 8; [[fallthrough]];
    case 9:
      k2 ^= uint64_t(tail[8]);
      k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
      [[fallthrough]];
    case 8: k1 ^= uint64_t(tail[7]) << 56; [[fallthrough]];
    case 7: k1 ^= uint64_t(tail[6]) << 48; [[fallthrough]];
    case 6: k1 ^= uint64_t(tail[5]) << 40; [[fallthrough]];
    case 5: k1 ^= uint64_t(tail[4]) << 32; [[fallthrough]];
    case 4: k1 ^= uint64_t(tail[3]) << 24; [[fallthrough]];
    case 3: k1 ^= uint64_t(tail[2]) << 16; [[fallthrough]];
    case 2: k1 ^= uint64_t(tail[1]) << 8; [[fallthrough]];
    case 1:
      k1 ^= uint64_t(tail[0]);
      k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
      break;
    case 0: break;
  }

  h1 ^= uint64_t(len);
  h2 ^= uint64_t(len);
  h1 += h2; h2 += h1;
  h1 = fmix64(h1); h2 = fmix64(h2);
  h1 += h2;
  return h1;
}

// minimap2's invertible hash64 under a bit mask.
inline uint64_t mm_hash64(uint64_t key, uint64_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ key >> 24;
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ key >> 14;
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ key >> 28;
  key = (key + (key << 31)) & mask;
  return key;
}

constexpr uint8_t kInvalid = 4;

uint8_t g_code_lut[256];
struct LutInit {
  LutInit() {
    std::memset(g_code_lut, kInvalid, sizeof(g_code_lut));
    g_code_lut['A'] = 0; g_code_lut['a'] = 0;
    g_code_lut['C'] = 1; g_code_lut['c'] = 1;
    g_code_lut['G'] = 2; g_code_lut['g'] = 2;
    g_code_lut['T'] = 3; g_code_lut['t'] = 3;
  }
} g_lut_init;

const char kCodeChar[4] = {'A', 'C', 'G', 'T'};

}  // namespace

extern "C" {

// ASCII sequence -> 2-bit codes (A=0 C=1 G=2 T=3, other=4).
void hymet_encode(const uint8_t* seq, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) out[i] = g_code_lut[seq[i]];
}

// Canonical k-mer Mash hashes of all valid windows. Returns the number
// of valid k-mers written to `out` (caller allocates n - k + 1 slots).
int64_t hymet_kmer_hashes(const uint8_t* codes, int64_t n, int k,
                          uint64_t* out) {
  if (n < k || k < 1 || k > 32) return 0;
  const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  uint64_t fwd = 0, rc = 0;
  int run = 0;  // consecutive valid bases ending at i
  int64_t n_out = 0;
  uint8_t buf[32];
  for (int64_t i = 0; i < n; i++) {
    const uint8_t c = codes[i];
    if (c >= 4) {
      run = 0;
      fwd = rc = 0;
      continue;
    }
    fwd = ((fwd << 2) | c) & mask;
    rc = (rc >> 2) | (uint64_t(3 - c) << (2 * (k - 1)));
    if (++run < k) continue;
    const uint64_t canon = fwd < rc ? fwd : rc;
    for (int j = 0; j < k; j++)
      buf[j] = kCodeChar[(canon >> (2 * (k - 1 - j))) & 3];
    out[n_out++] = murmur3_h1(buf, k, kSeed);
  }
  return n_out;
}

// Minimizer extraction: minimap2 hash64 over packed canonical k-mers,
// leftmost-min winnowing over windows of w, consecutive dedup. Writes up
// to n entries (caller allocates n slots each). Returns the count.
int64_t hymet_minimizers(const uint8_t* codes, int64_t n, int k, int w,
                         uint64_t* out_h, int32_t* out_pos,
                         int8_t* out_strand) {
  if (n < k || k < 1 || k > 31 || w < 1) return 0;
  const int64_t n_kmers = n - k + 1;
  if (n_kmers < w) return 0;
  const uint64_t mask = (1ULL << (2 * k)) - 1;
  const uint64_t kBad = ~0ULL;

  std::vector<uint64_t> hashes(n_kmers);
  std::vector<int8_t> strands(n_kmers);
  {
    uint64_t fwd = 0, rc = 0;
    int run = 0;
    for (int64_t i = 0; i < n; i++) {
      const uint8_t c = codes[i];
      const int64_t kpos = i - k + 1;
      if (c >= 4) {
        run = 0;
        fwd = rc = 0;
      } else {
        fwd = ((fwd << 2) | c) & mask;
        rc = (rc >> 2) | (uint64_t(3 - c) << (2 * (k - 1)));
        run++;
      }
      if (kpos < 0) continue;
      if (run >= k) {
        const bool use_fwd = fwd <= rc;
        hashes[kpos] = mm_hash64(use_fwd ? fwd : rc, mask);
        strands[kpos] = use_fwd ? 0 : 1;
      } else {
        hashes[kpos] = kBad;
        strands[kpos] = 0;
      }
    }
  }

  // monotonic deque sliding-window min with leftmost tie-break
  std::deque<int64_t> dq;
  int64_t n_out = 0;
  int64_t last_pos = -1;
  for (int64_t i = 0; i < n_kmers; i++) {
    // strictly-greater pop keeps the earliest index among equals
    while (!dq.empty() && hashes[dq.back()] > hashes[i]) dq.pop_back();
    dq.push_back(i);
    if (dq.front() <= i - w) dq.pop_front();
    if (i >= w - 1) {
      const int64_t p = dq.front();
      if (p != last_pos && hashes[p] != kBad) {
        out_h[n_out] = hashes[p];
        out_pos[n_out] = int32_t(p);
        out_strand[n_out] = strands[p];
        n_out++;
        last_pos = p;
      }
    }
  }
  return n_out;
}

}  // extern "C"
