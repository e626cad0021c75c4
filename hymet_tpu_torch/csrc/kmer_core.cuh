// Device core shared by the k-mer kernels: a run of canonical k-mer windows
// per thread, MurmurHash3_x64_128 h1 (seed 42) of each window's canonical
// ASCII bytes, as Mash hashes them.
//
// A thread owns a run of R = kRun = 16 consecutive windows. Their
// R + k - 1 <= 47 bases arrive as four 32-bit words of 2-bit codes (base i
// at word i / 16, bits 2 (i % 16)) and a 64-bit word of validity bits
// (bit i = base i). From them the thread builds, once per run:
//   - the forward stream s (the 2-bit codes) and the reverse-complement
//     stream x: x holds base q = 3 - base[R + k - 2 - q], so that the
//     reverse complement of window j starts at x's base R - 1 - j;
//   - both streams as ASCII bytes, 16 little-endian 32-bit words each.
// Window j is then made of shifts by compile-time amounts (the loop over
// the run is unrolled): its forward and reverse-complement 2-bit words are
// bits [2j, 2j + 2k) of s and [2(R-1-j), ...) of x, and its two ASCII
// strings are funnel shifts of the ASCII words at byte offsets j and
// R - 1 - j. Nothing is repacked per window and nothing is warmed up. A
// shorter run costs more set-up per window and gives more threads; the
// screen's launches hold few valid windows beside the card's threads.
//
// Canonical rule: Mash takes the lexicographically smaller of the k-mer and
// its reverse complement. With the first base in the lowest bits (as here),
// fwd_msb = ~x_window & kmask and rc_msb = ~s_window & kmask, so
// fwd_msb <= rc_msb exactly when s_window <= x_window.
//
// Work per window at k = 21, in 32-bit instructions: the two 2-bit words
// and their compare about 10, the ASCII words about 20, Murmur's one block,
// 5-byte tail and finalization 74, of them 34 multiply-adds.
// The card has no 64-bit integer unit: a 64-bit shift, add or logic op is
// two 32-bit instructions, a 64-bit multiply by a constant about three.

#pragma once

#include <cstdint>

namespace hymet {

constexpr int kRun = 16;                       // windows per thread
constexpr int kThreads = 128;                  // threads per block
constexpr int kBlockWindows = kRun * kThreads;
// A block's slab: its windows' bases plus a halo of 64 (k - 1 <= 31 are
// needed), as code words of 16 bases and as 16-bit mask words.
constexpr int kSlabWords = kBlockWindows / 16 + 4;

// Four code bytes -> their four 2-bit codes (& 3) in the low byte.
__device__ __forceinline__ uint32_t pack4(uint32_t w) {
  uint32_t x = w & 0x03030303u;
  x |= x >> 6;
  return (x & 0xFu) | ((x >> 12) & 0xF0u);
}

// Four code bytes -> four validity bits (code < 4).
__device__ __forceinline__ uint32_t valid4(uint32_t w) {
  uint32_t v = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) v |= static_cast<uint32_t>(((w >> (8 * q)) & 0xFCu) == 0) << q;
  return v;
}

// A slab of a row of L codes (0-3 = ACGT, >= 4 invalid), bases b0 ..
// b0 + 16 * words - 1, as one code word and 16 validity bits a 16 bases;
// past the row, code 4 (invalid). The block's threads share the words;
// vec: the row may be read 16 bytes at a time (L % 16 == 0, aligned base).
__device__ __forceinline__ void load_code_slab(const uint8_t* __restrict__ src, long long L,
                                               long long b0, int words, bool vec,
                                               uint32_t* code_slab, uint16_t* mask16) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const long long p = b0 + 16LL * i;
    uint32_t w[4];
    if (vec && p + 16 <= L) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + p));
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t x = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const long long pos = p + 4 * q + b;
          x |= static_cast<uint32_t>(pos < L ? src[pos] : 4) << (8 * b);
        }
        w[q] = x;
      }
    }
    uint32_t cw = 0, mw = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cw |= pack4(w[q]) << (8 * q);
      mw |= valid4(w[q]) << (4 * q);
    }
    code_slab[i] = cw;
    mask16[i] = static_cast<uint16_t>(mw);
  }
}

// Thread `tid`'s run out of the block's slab (bases kRun * tid ...): its
// 64 validity bits, and its four code words.
__device__ __forceinline__ uint64_t run_valid_bits(const uint16_t* mask16, int tid) {
  uint64_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) m |= static_cast<uint64_t>(mask16[tid + i]) << (16 * i);
  return m;
}

__device__ __forceinline__ void run_codes(const uint32_t* code_slab, int tid, uint32_t (&code)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) code[i] = code_slab[tid + i];
}

constexpr uint64_t kSeed = 42;
constexpr uint64_t kC1 = 0x87C37B91114253D5ull;
constexpr uint64_t kC2 = 0x4CF5AD432745937Full;
constexpr uint32_t kAsciiLut = 0x54474341u;  // bytes 'A' 'C' 'G' 'T'

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

// Reverse the order of the 32 2-bit fields of v.
__device__ __forceinline__ uint64_t rev2(uint64_t v) {
  const uint64_t b = __brevll(v);
  return ((b >> 1) & 0x5555555555555555ull) | ((b & 0x5555555555555555ull) << 1);
}

// The four 2-bit codes in the low byte of x as four ASCII bytes, first
// code in the lowest byte: spread the codes to nibbles, then one byte
// permute picks each letter from kAsciiLut.
__device__ __forceinline__ uint32_t ascii4(uint32_t x) {
  x &= 0xFFu;
  x = (x | (x << 4)) & 0x0F0Fu;
  x = (x | (x << 2)) & 0x3333u;
  return __byte_perm(kAsciiLut, 0u, x);
}

// 64 bits of the 128-bit value (hi:lo) starting at bit b, 0 <= b < 64.
__device__ __forceinline__ uint64_t bits64(uint64_t lo, uint64_t hi, int b) {
  return b == 0 ? lo : (lo >> b) | (hi << (64 - b));
}

// Bits 0 .. kRun-1 for the windows of a run whose first `left` windows lie
// in the row.
__device__ __forceinline__ uint32_t run_mask(long long left) {
  return left >= kRun ? (1u << kRun) - 1u : left <= 0 ? 0u : (1u << left) - 1u;
}

// Bit j set when validity bits j .. j + k - 1 of m are all set (j < 32;
// bits past 63 count as unset).
__device__ __forceinline__ uint32_t window_valid(uint64_t m, int k) {
  uint64_t v = ~0ull;  // AND of the runs taken so far, shifted into place
  uint64_t p = m;      // bit i: bits i .. i + len - 1 all set
  int off = 0;
#pragma unroll
  for (int len = 1; len <= 32; len <<= 1) {
    if (k & len) {
      v &= p >> off;
      off += len;
    }
    p &= p >> len;
  }
  return static_cast<uint32_t>(v);
}

// MurmurHash3_x64_128 h1 of k bytes held in w[0 .. NW-1] (NW = ceil(k/8);
// bytes past k zero).
template <int NW>
__device__ __forceinline__ uint64_t murmur_h1(const uint64_t (&w)[4], int k) {
  uint64_t h1 = kSeed, h2 = kSeed;
  // whole 16-byte blocks: none below k = 16, two only at k = 32
  const int nblocks = NW == 1 ? 0 : NW == 3 ? 1 : (k >> 4);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if (2 * b + 1 < NW && b < nblocks) {
      uint64_t k1 = w[2 * b], k2 = w[2 * b + 1];
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
  // the tail words follow the blocks (with two blocks there is no tail)
  const int tail = k & 15;
  const uint64_t t1 = w[NW >= 3 ? 2 : 0];
  const uint64_t t2 = w[NW >= 3 ? 3 : 1];
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
  return fmix64(h1) + fmix64(h2);
}

// Hash every window of one run; emit(j, h1) for each. code: the run's bases
// as 2-bit codes (see the top of this file). Windows with an invalid base
// hash their codes as given (the caller packs code & 3), so every window
// has a defined hash; the caller drops what it does not need. No branch
// per window, so the compiler may interleave independent windows.
template <int NW, class Emit>
__device__ __forceinline__ void hash_run(const uint32_t (&code)[4], int k, Emit emit) {
  const uint64_t s0 = code[0] | static_cast<uint64_t>(code[1]) << 32;
  const uint64_t s1 = code[2] | static_cast<uint64_t>(code[3]) << 32;
  // complement of the 64 bases reversed: base q = 3 - base[63 - q] ...
  const uint64_t r0 = ~rev2(s1), r1 = ~rev2(s0);
  // ... moved down by 65 - R - k bases: base q = 3 - base[R + k - 2 - q]
  constexpr int R = kRun;
  const int sh = 2 * (65 - R - k);  // 34 .. 96
  const uint64_t x0 = sh >= 64 ? r1 >> (sh - 64) : (r0 >> sh) | (r1 << (64 - sh));
  const uint64_t x1 = sh >= 64 ? 0 : r1 >> sh;

  uint32_t a[16], v[16];  // ASCII bytes of s and of x
  const uint32_t xw[4] = {static_cast<uint32_t>(x0), static_cast<uint32_t>(x0 >> 32),
                          static_cast<uint32_t>(x1), static_cast<uint32_t>(x1 >> 32)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      a[4 * i + b] = ascii4(code[i] >> (8 * b));
      v[4 * i + b] = ascii4(xw[i] >> (8 * b));
    }
  }
  const uint64_t kmask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  const uint64_t topmask = (k & 7) ? (1ull << (8 * (k & 7))) - 1 : ~0ull;

#pragma unroll
  for (int j = 0; j < R; ++j) {
    const uint64_t f = bits64(s0, s1, 2 * j) & kmask;
    const uint64_t r = bits64(x0, x1, 2 * (R - 1 - j)) & kmask;
    const bool forward = f <= r;
    // the canonical string's k bytes, NW words, bytes past k cleared
    const int fo = j >> 2, fs = 8 * (j & 3);
    const int ro = (R - 1 - j) >> 2, rs = 8 * ((R - 1 - j) & 3);
    uint64_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const uint32_t flo = __funnelshift_r(a[fo + 2 * i], a[fo + 2 * i + 1], fs);
      const uint32_t fhi = __funnelshift_r(a[fo + 2 * i + 1], a[fo + 2 * i + 2], fs);
      const uint32_t rlo = __funnelshift_r(v[ro + 2 * i], v[ro + 2 * i + 1], rs);
      const uint32_t rhi = __funnelshift_r(v[ro + 2 * i + 1], v[ro + 2 * i + 2], rs);
      w[i] = forward ? (flo | static_cast<uint64_t>(fhi) << 32)
                     : (rlo | static_cast<uint64_t>(rhi) << 32);
    }
    w[NW - 1] &= topmask;
    emit(j, murmur_h1<NW>(w, k));
  }
}

}  // namespace hymet
