// Chains of sorted anchors, written by hand for Hopper.
//
// Replaces hymet_tpu/models/aligner.py::_chain_reduce_sorted (:709) and
// _chain_core (:849): segmented min/max scans, counts from a cummax of
// start indices, the score's segmented cumsum, the good-chain filter and
// the (not good, iota) argsort compaction. Input: A anchors sorted by key
// (key = (k1 << 32 | k2) ^ (1 << 63), k1 = qid << 26 | seq,
// k2 = rel << 24 | band; padding anchors have k1 = k2 = 0xFFFFFFFF and sort
// to the tail) with their qpos and rpos. Anchor i + 1 continues anchor i's
// chain when k1 is equal, rel is equal and band[i + 1] - band[i] <= 1
// (uint32). Per chain whose first anchor is valid (k2 != 0xFFFFFFFF):
//   cnt, min and max of qpos and rpos (unsigned);
//   score = k + sum over its later anchors of clip(qpos[i] - qpos[i-1], 0, k);
//   good  = cnt >= min_cnt and min(cnt * k, maxq - minq + k) >= min_mlen.
// The good chains' rows (qid, seq, rel, cnt, minq, maxq, minr, maxr,
// score) go to rows 0, 1, ... of a [ccap, 9] int32 table in anchor order;
// the rest of the table is zero, and n_chains counts every good chain
// (> ccap means overflow).
//
// Design: a tiled segmented reduction, the parallel form of _chain_core's
// segmented associative scan (_seg_comb, :757) and of its blocked form's
// open-chain carry (_seg_scans_blocked, :783). A block of 256 threads owns
// a tile of 2048 consecutive anchors, 8 a thread. Each anchor is a
// one-anchor fragment (start flag, cnt 1, its qpos and rpos as extents, its
// score term); fragments combine as _seg_comb does: (fa, a) + (fb, b) =
// (fa | fb, fb ? b : a (x) b), (x) adding cnt and score and taking min/max.
// A thread folds its 8 anchors, and warp shuffles plus one step across the
// 8 warps give the block's segmented scan. Four launches a call:
//   1. chain_tile_kernel: each tile's aggregate, the fragment of its
//      trailing open chain (from its last start on, or the whole tile if
//      no chain starts in it);
//   2. chain_flag_kernel: each tile's carry-in, the preceding tiles'
//      aggregates combined back to the nearest tile with a start (256
//      tiles a round; almost always the tile before), then the in-tile
//      scan seeded with it; at each chain's end anchor the good filter, and
//      the good rows in the tile's slab of scratch at their rank in the
//      tile (a block scan); the tile's count;
//   3. scan_block_counts: each tile's offset, and n_chains;
//   4. chain_write_kernel: each tile's rows at its offset; zeros past
//      n_chains (every block takes its share, padding tiles too).
// Rows are placed at chain ends: chains do not overlap, so end order is
// start order (the JAX reference flags ends too).
//
// What bounds it on an H100: bytes, each anchor's 16 bytes read once and
// 36 bytes a good chain written (chip_smoke.py::chain_bound_ms), and below
// that the floor of four launches a call. Against the bytes: a tile is
// read coalesced into shared memory (one spare word every 8, so that a
// thread's 8 consecutive anchors fall on 32 distinct banks) and its second
// read, in launch 2, finds it in L2; no thread walks a chain, so a chain of
// thousands of anchors costs what a short one does; and a tile whose first
// key is padding leaves after that one load in launches 1 and 2 (launch 4
// reads no anchor), so only the valid prefix of the [A] slots is read (a
// valid anchor's k2 is below 2^28, so no chain runs from a valid anchor
// into the padding). The rows' scratch is written only for good chains.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using namespace hymet;

HYMET_SCAN_KERNEL

constexpr int kChainThreads = 256;
constexpr int kWarps = kChainThreads / 32;
constexpr int kPer = 8;                             // anchors a thread
constexpr int kTile = kChainThreads * kPer;         // anchors a block
constexpr int kSlots = kTile + kTile / kPer;        // one spare word every kPer
constexpr int kAgg = 8;                             // int32 words of a tile's aggregate
constexpr int kRow = 8;                             // int32 words of a good row in scratch
constexpr uint32_t kBig = 0xFFFFFFFFu;
constexpr uint64_t kPadKey = ~0ull;                 // raw key of a padding anchor

// shared-memory word of the tile's anchor i: thread t's anchors 8t .. 8t + 7
// sit at 9t .. 9t + 7, 32 distinct banks across a warp
__device__ __forceinline__ int slot(int i) { return i + i / kPer; }

__device__ __forceinline__ uint64_t raw_key(const int64_t* __restrict__ key, long long i) {
  return static_cast<uint64_t>(key[i]) ^ 0x8000000000000000ull;
}

// anchor b continues anchor a's chain
__device__ __forceinline__ bool same_chain(uint32_t k1a, uint32_t k2a, uint32_t k1b, uint32_t k2b) {
  return k1a == k1b && ((k2a >> 24) & 0xFu) == ((k2b >> 24) & 0xFu) &&
         (k2b & 0xFFFFFFu) - (k2a & 0xFFFFFFu) <= 1u;
}

// A chain fragment. flags bit 0: a chain starts in it; bit 1: the latest
// start's anchor is valid. The other fields cover the fragment from its
// latest start on (all of it if none starts in it).
struct Seg {
  uint32_t flags, cnt, minq, maxq, minr, maxr, score;
};

__device__ __forceinline__ Seg seg_identity() { return {0u, 0u, kBig, 0u, kBig, 0u, 0u}; }

__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
  if (b.flags & 1u) return b;
  return {a.flags,           a.cnt + b.cnt,     min(a.minq, b.minq), max(a.maxq, b.maxq),
          min(a.minr, b.minr), max(a.maxr, b.maxr), a.score + b.score};
}

__device__ __forceinline__ Seg shfl_up(const Seg& v, int o) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  return {__shfl_up_sync(kAll, v.flags, o), __shfl_up_sync(kAll, v.cnt, o),
          __shfl_up_sync(kAll, v.minq, o),  __shfl_up_sync(kAll, v.maxq, o),
          __shfl_up_sync(kAll, v.minr, o),  __shfl_up_sync(kAll, v.maxr, o),
          __shfl_up_sync(kAll, v.score, o)};
}

__device__ __forceinline__ void store_seg(int* __restrict__ dst, const Seg& v) {
  reinterpret_cast<int4*>(dst)[0] = make_int4(static_cast<int>(v.flags), static_cast<int>(v.cnt),
                                              static_cast<int>(v.minq), static_cast<int>(v.maxq));
  reinterpret_cast<int4*>(dst)[1] = make_int4(static_cast<int>(v.minr), static_cast<int>(v.maxr),
                                              static_cast<int>(v.score), 0);
}

__device__ __forceinline__ Seg load_seg(const int* __restrict__ src) {
  const int4 a = reinterpret_cast<const int4*>(src)[0], b = reinterpret_cast<const int4*>(src)[1];
  return {static_cast<uint32_t>(a.x), static_cast<uint32_t>(a.y), static_cast<uint32_t>(a.z),
          static_cast<uint32_t>(a.w), static_cast<uint32_t>(b.x), static_cast<uint32_t>(b.y),
          static_cast<uint32_t>(b.z)};
}

// Exclusive segmented scan of the threads' fragments in thread order,
// seeded with `carry`; *total receives carry + every fragment. Every thread
// of the block calls it.
__device__ __forceinline__ Seg block_seg_scan(const Seg& v, const Seg& carry, Seg* total) {
  __shared__ Seg warp_total[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Seg x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Seg y = shfl_up(x, o);
    if (lane >= o) x = combine(y, x);
  }
  const Seg left = shfl_up(x, 1);
  if (lane == 31) warp_total[warp] = x;
  __syncthreads();
  Seg acc = carry, before = carry;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) before = acc;
    acc = combine(acc, warp_total[w]);
  }
  *total = acc;
  __syncthreads();  // warp_total may be reused by the next call
  return lane ? combine(before, left) : before;
}

// A tile's anchors in shared memory, at slot(i).
struct Tile {
  uint32_t k1[kSlots], k2[kSlots];
  int p[kSlots], r[kSlots];
};

// the n anchors of the tile from `base` on, read coalesced
__device__ __forceinline__ void load_tile(Tile& t, const int64_t* __restrict__ key,
                                          const int* __restrict__ s_p, const int* __restrict__ s_r,
                                          long long base, int n) {
  for (int m = threadIdx.x; m < n; m += kChainThreads) {
    const uint64_t kr = raw_key(key, base + m);
    const int s = slot(m);
    t.k1[s] = static_cast<uint32_t>(kr >> 32);
    t.k2[s] = static_cast<uint32_t>(kr);
    t.p[s] = s_p[base + m];
    t.r[s] = s_r[base + m];
  }
  __syncthreads();
}

// Start bits of the thread's anchors i0 + j, j = 0 .. kPer (bit kPer: the
// anchor after its last, which is the next thread's or the next tile's),
// with a bit set too where no anchor is; *p_before receives the qpos of the
// anchor before i0 (0 if none).
__device__ __forceinline__ uint32_t thread_starts(const Tile& t, const int64_t* __restrict__ key,
                                                  const int* __restrict__ s_p, long long A,
                                                  long long base, int n, int* p_before) {
  const int i0 = static_cast<int>(threadIdx.x) * kPer;
  *p_before = 0;
  if (i0 >= n) return ~0u;
  uint32_t pk1 = 0, pk2 = 0;
  bool prev = true;
  if (i0 > 0) {
    const int s = slot(i0 - 1);
    pk1 = t.k1[s];
    pk2 = t.k2[s];
    *p_before = t.p[s];
  } else if (base > 0) {
    const uint64_t kr = raw_key(key, base - 1);
    pk1 = static_cast<uint32_t>(kr >> 32);
    pk2 = static_cast<uint32_t>(kr);
    *p_before = s_p[base - 1];
  } else {
    prev = false;  // anchor 0 starts a chain
  }
  uint32_t starts = 0;
#pragma unroll
  for (int j = 0; j <= kPer; ++j) {
    const int i = i0 + j;
    uint32_t k1, k2;
    if (i < n) {
      k1 = t.k1[slot(i)];
      k2 = t.k2[slot(i)];
    } else if (base + i < A) {  // i == kTile: the next tile's first anchor
      const uint64_t kr = raw_key(key, base + i);
      k1 = static_cast<uint32_t>(kr >> 32);
      k2 = static_cast<uint32_t>(kr);
    } else {
      starts |= ~0u << j;  // past the last anchor
      break;
    }
    if (!prev || !same_chain(pk1, pk2, k1, k2)) starts |= 1u << j;
    pk1 = k1;
    pk2 = k2;
    prev = true;
  }
  return starts;
}

// the one-anchor fragment of the tile's anchor i
__device__ __forceinline__ Seg anchor_seg(const Tile& t, int i, bool start, int p_prev, int k) {
  const int s = slot(i);
  const int p = t.p[s];
  const uint32_t up = static_cast<uint32_t>(p), ur = static_cast<uint32_t>(t.r[s]);
  const uint32_t flags = start ? (t.k2[s] != kBig ? 3u : 1u) : 0u;
  const int c = start ? k : min(max(p - p_prev, 0), k);
  return {flags, 1u, up, up, ur, ur, static_cast<uint32_t>(c)};
}

// Combines the thread's anchors (those below n) one by one into s, calling
// f(i, j, s) after anchor i = i0 + j; returns s.
template <typename F>
__device__ __forceinline__ Seg walk(const Tile& t, int n, uint32_t starts, int p_prev, int k, Seg s,
                                    F f) {
  const int i0 = static_cast<int>(threadIdx.x) * kPer;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = i0 + j;
    if (i >= n) break;
    s = combine(s, anchor_seg(t, i, (starts >> j) & 1u, p_prev, k));
    p_prev = t.p[slot(i)];
    f(i, j, s);
  }
  return s;
}

__device__ __forceinline__ bool good_chain(const Seg& s, int k, int min_cnt, int min_mlen) {
  const long long cnt = s.cnt;
  const long long mlen = min(cnt * k, static_cast<long long>(s.maxq - s.minq) + k);
  return (s.flags & 2u) && cnt >= min_cnt && mlen >= min_mlen;
}

__global__ void __launch_bounds__(kChainThreads)
chain_tile_kernel(const int64_t* __restrict__ key, const int* __restrict__ s_p,
                  const int* __restrict__ s_r, long long A, int k, int* __restrict__ agg) {
  __shared__ Tile t;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  if (raw_key(key, base) == kPadKey) {  // the padding tail: no chain starts here or after
    if (threadIdx.x == 0) store_seg(agg + kAgg * blockIdx.x, {1u, 0u, kBig, 0u, kBig, 0u, 0u});
    return;
  }
  const int n = static_cast<int>(min(static_cast<long long>(kTile), A - base));
  load_tile(t, key, s_p, s_r, base, n);
  int p_before;
  const uint32_t starts = thread_starts(t, key, s_p, A, base, n, &p_before);
  const Seg fold = walk(t, n, starts, p_before, k, seg_identity(), [](int, int, const Seg&) {});
  Seg total;
  block_seg_scan(fold, seg_identity(), &total);
  if (threadIdx.x == 0) store_seg(agg + kAgg * blockIdx.x, total);
}

__global__ void __launch_bounds__(kChainThreads)
chain_flag_kernel(const int64_t* __restrict__ key, const int* __restrict__ s_p,
                  const int* __restrict__ s_r, long long A, int k, int min_cnt, int min_mlen,
                  const int* __restrict__ agg, int* __restrict__ block_sums,
                  int* __restrict__ rows) {
  __shared__ Tile t;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  if (raw_key(key, base) == kPadKey) {
    if (threadIdx.x == 0) block_sums[blockIdx.x] = 0;
    return;
  }
  const int n = static_cast<int>(min(static_cast<long long>(kTile), A - base));
  load_tile(t, key, s_p, s_r, base, n);
  // carry-in: the preceding tiles' aggregates, oldest first, kChainThreads
  // tiles a round, back to the nearest tile in which a chain starts (tile 0
  // has one: anchor 0 starts a chain)
  Seg carry = seg_identity();
  for (long long hi = static_cast<long long>(blockIdx.x) - 1; hi >= 0; hi -= kChainThreads) {
    const long long j = hi - (kChainThreads - 1) + threadIdx.x;
    Seg older;
    block_seg_scan(j >= 0 ? load_seg(agg + kAgg * j) : seg_identity(), seg_identity(), &older);
    carry = combine(older, carry);
    if (older.flags & 1u) break;
  }
  int p_before;
  const uint32_t starts = thread_starts(t, key, s_p, A, base, n, &p_before);
  const Seg fold = walk(t, n, starts, p_before, k, seg_identity(), [](int, int, const Seg&) {});
  Seg unused;
  const Seg before = block_seg_scan(fold, carry, &unused);
  // the good chains that end at the thread's anchors (anchor i0 + j ends a
  // chain when anchor i0 + j + 1 starts one): count, rank in the tile, write
  auto good_end = [&](int j, const Seg& s) {
    return ((starts >> (j + 1)) & 1u) && good_chain(s, k, min_cnt, min_mlen);
  };
  int n_good = 0;
  walk(t, n, starts, p_before, k, before, [&](int, int j, const Seg& s) { n_good += good_end(j, s); });
  long long total;
  const long long rank = block_exclusive_scan<kChainThreads>(n_good, &total);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = static_cast<int>(total);
  if (n_good == 0) return;
  int4* out = reinterpret_cast<int4*>(rows + kRow * (base + rank));
  walk(t, n, starts, p_before, k, before, [&](int i, int j, const Seg& s) {
    if (!good_end(j, s)) return;
    const int sl = slot(i);
    out[0] = make_int4(static_cast<int>(t.k1[sl]), static_cast<int>((t.k2[sl] >> 24) & 0xFu),
                       static_cast<int>(s.cnt), static_cast<int>(s.minq));
    out[1] = make_int4(static_cast<int>(s.maxq), static_cast<int>(s.minr),
                       static_cast<int>(s.maxr), static_cast<int>(s.score));
    out += kRow / 4;
  });
}

__global__ void __launch_bounds__(kChainThreads)
chain_write_kernel(const int* __restrict__ block_sums, const int* __restrict__ rows,
                   const long long* __restrict__ offsets, const long long* __restrict__ n_chains,
                   long long ccap, int* __restrict__ out) {
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int count = block_sums[blockIdx.x];
  const long long off = offsets[blockIdx.x];
  for (int m = threadIdx.x; m < count && off + m < ccap; m += kChainThreads) {
    const int4* src = reinterpret_cast<const int4*>(rows + kRow * (base + m));
    const int4 a = src[0], b = src[1];
    int* row = out + 9 * (off + m);
    row[0] = static_cast<int>(static_cast<uint32_t>(a.x) >> 26);
    row[1] = static_cast<int>(static_cast<uint32_t>(a.x) & ((1u << 26) - 1u));
    row[2] = a.y;
    row[3] = a.z;
    row[4] = a.w;
    row[5] = b.x;
    row[6] = b.y;
    row[7] = b.z;
    row[8] = b.w;
  }
  // words of the rows past the last good chain hold zeros
  const long long stride = static_cast<long long>(gridDim.x) * kChainThreads;
  const long long end = 9 * ccap;
  for (long long w = 9 * *n_chains + static_cast<long long>(blockIdx.x) * kChainThreads + threadIdx.x;
       w < end; w += stride)
    out[w] = 0;
}

}  // namespace

// Launches the tile pass, the flag pass, the scan and the write pass on
// `stream`; returns the first launch error (0 = launched). nb must equal
// ceil(A / 2048); agg [nb, 8], block_sums [nb] and rows [A, 8] int32 (16-byte
// aligned), offsets [nb] and n_chains [1] int64 are scratch and output. The
// caller checks dtypes, shapes, contiguity and A, ccap below 2^31.
extern "C" int chains_launch(const int64_t* key, const int* s_p, const int* s_r, long long A, int k,
                             int min_cnt, int min_mlen, int nb, int* agg, int* block_sums,
                             long long* offsets, long long* n_chains, int* rows, long long ccap,
                             int* out, void* stream) {
  if (A < 1 || nb != (A + kTile - 1) / kTile) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  chain_tile_kernel<<<nb, kChainThreads, 0, s>>>(key, s_p, s_r, A, k, agg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_flag_kernel<<<nb, kChainThreads, 0, s>>>(key, s_p, s_r, A, k, min_cnt, min_mlen, agg,
                                                 block_sums, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_block_counts<<<1, kScanThreads, 0, s>>>(block_sums, nb, offsets, n_chains);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_write_kernel<<<nb, kChainThreads, 0, s>>>(block_sums, rows, offsets, n_chains, ccap, out);
  return static_cast<int>(cudaGetLastError());
}
