// Sorted anchors of a batch's kept minimizers, written by hand for Hopper:
// the index search, the anchor expansion with its sort keys, and the sort.
//
// Replaces hymet_tpu/models/aligner.py::_search_occ (the lower-bound
// search of each minimizer's hash in the index's unique-hash table, then
// (left, occ) from the run-offset table) and _collect_anchors_slots' default
// branch (the occurrence filter, the slot compaction of every kept
// occurrence, the payload gather, the packed keys, and the stable 2-key
// lax.sort with the payload gathered by its permutation).
// For minimizer n < n_kept, with hash q:
//   lo = first u with uniq[u] >= q (unsigned); occ = end - start of row lo
//   of roff when uniq[lo] == q, else 0; keep = 1 <= occ <= max_occ;
// minimizer n's occurrences j < occ are anchors number basex[n] + j (basex
// the exclusive prefix of the kept occ), each with, from
// ps[start + j] = (rpos, seq << 1 | strand):
//   rel  = minimizer strand ^ index strand;
//   diag = rpos - qpos, or rpos + qpos when rel = 1;
//   band = (diag + 2^28) >> band_bits;
//   key  = ((qid << 26 | seq) << 32 | rel << 24 | band) ^ (1 << 63)
// (the JAX package's two uint32 sort keys k1, k2 as one int64 whose signed
// order is their lexicographic unsigned order), qpos and rpos. The first
// min(n_anchors, acap) anchors, in emission order, are written sorted by
// key, ties in emission order; the slots after them hold key = INT64_MAX
// (k1 = k2 = 0xFFFFFFFF) and zeros; n_anchors counts every kept occurrence
// (> acap means overflow).
//
// Design, in 3 + P launches on one stream, no host sync:
// 1. anchor_search_kernel, one thread a minimizer: a lower-bound search
//    confined to the hash's bucket, the top `bits` bits of the 2k-bit hash
//    (bucket[t] = first u whose top bits are >= t; at 4.17 M unique hashes
//    and 2^22 buckets at most 25 entries a bucket, 5 loads, about 3 on
//    average, in place of 22), and each block's count of kept occurrences.
//    Blocks past n_kept leave after one load of it.
// 2. scan_block_counts: each block's first anchor, and n_anchors.
// 3. anchor_expand_kernel: a block's anchors are spread over its threads
//    (a block scan of occ, then each thread finds its anchor's minimizer
//    by an 8-step search in that scan), so that writes are coalesced and
//    no thread walks a minimizer's occurrences. Each anchor's key, qpos
//    and rpos go to slot-ordered scratch, with a compact sort key: only
//    the key bits that can vary, known on the host before the launch
//    (qid < B, seq < n_seq, rel, band from L and the longest reference),
//    packed in the key's order into 32 bits or 64. The block counts the
//    8-bit digits of every sort pass in shared memory and adds them to
//    the passes' totals. The same launch clears the sort's tile counters
//    and published counts.
// 4. P = ceil(compact bits / 8) passes of a stable LSD radix sort over
//    the filled prefix only (min(n_anchors, acap) read on the device;
//    tiles past it leave after one load), with the slot index as the
//    value, one anchor_digit_scatter_kernel a pass: a tile takes its id
//    from a counter (so every tile before it is running), ranks its items
//    stably (__match_any_sync within a warp, warps in order), publishes
//    its digit counts (a ready flag in the same word), stages the tile in
//    digit order in shared memory, sums the counts the tiles before it
//    published, and writes the tile out; the last pass writes key, qpos
//    and rpos gathered by the slot index, and its tiles past the filled
//    prefix write the sentinel and zeros in their slots, beside the
//    working tiles.
// What bounds it on an H100: the bytes of the sentinel past the filled
// prefix (16 a slot, 70-98 % of a gut batch's slots) and, for the work
// itself, the launches and the dependent loads of the search; the sort's
// passes read and write 8 bytes (12 with 64-bit compact keys) an anchor
// each. chip_smoke.py::anchor_bound_ms counts what the function needs.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using namespace hymet;

HYMET_SCAN_KERNEL

constexpr int kAncThreads = 256;  // minimizers a block of the search and the expansion
constexpr int kSortThreads = 256;  // threads of a sort tile, one a digit
constexpr int kRadix = 256;  // 8-bit digits
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kMaxPasses = 8;
constexpr unsigned kNoDigit = 0xFFFFFFFFu;  // an item past the filled prefix
constexpr unsigned kReady = 0x80000000u;  // a tile's published digit count
constexpr long long kKeyPad = 0x7FFFFFFFFFFFFFFFLL;

// Items a thread and a tile of the sort: 4096 a tile with 32-bit compact
// keys, 2048 with 64-bit ones (the tile, its slot indices and the warps'
// digit counts stay within 48 KB of static shared memory).
template <typename K>
struct SortTile {
  static constexpr int kItems = sizeof(K) == 4 ? 16 : 8;
  static constexpr int kSize = kSortThreads * kItems;
};

__global__ void __launch_bounds__(kAncThreads)
anchor_search_kernel(const int64_t* __restrict__ hash, const long long* __restrict__ n_kept,
                     int cap, const int64_t* __restrict__ uniq, const int* __restrict__ bucket,
                     int n_buckets, int shift, const int* __restrict__ roff, int max_occ,
                     int* __restrict__ occk, int* __restrict__ left, int* __restrict__ block_sums,
                     int* __restrict__ totals, int n_totals) {
  // the sort passes' digit totals, added to by anchor_expand_kernel
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < n_totals; i += kAncThreads) totals[i] = 0;
  const long long live = min(static_cast<long long>(cap), *n_kept);
  const long long n0 = static_cast<long long>(blockIdx.x) * kAncThreads;
  if (n0 >= live) {  // the whole block: past the last kept minimizer
    if (threadIdx.x == 0) block_sums[blockIdx.x] = 0;
    return;
  }
  const int n = static_cast<int>(n0) + threadIdx.x;
  int occ = 0;
  if (n < live) {
    const uint64_t q = static_cast<uint64_t>(hash[n]);
    // bucket n_buckets holds no entry: a hash above every 2k-bit hash
    const uint64_t top = q >> shift;
    const int t = top < static_cast<uint64_t>(n_buckets) ? static_cast<int>(top) : n_buckets;
    int lo = __ldg(bucket + t);
    const int end = __ldg(bucket + t + 1);
    int hi = end;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (static_cast<uint64_t>(__ldg(uniq + mid)) < q) lo = mid + 1; else hi = mid;
    }
    if (lo < end && static_cast<uint64_t>(__ldg(uniq + lo)) == q) {
      const int start = __ldg(roff + 2 * lo);
      const int o = __ldg(roff + 2 * lo + 1) - start;
      if (o >= 1 && o <= max_occ) {
        occ = o;
        left[n] = start;
      }
    }
    occk[n] = occ;
  }
  long long total;
  block_exclusive_scan<kAncThreads>(occ, &total);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = static_cast<int>(total);
}

// The compact sort key's layout: ck = qid << (sbits + vbits) | seq << vbits
// | vpart, where vpart = rel << bw | (band - bmin) when every band is below
// 2^24 (bw >= 0), else (rel << 24 | band) - bmin (bw = -1). Either is
// monotone in k2 = rel << 24 | band, and seq < 2^26, so the compact keys
// order and tie as the full keys do.
struct KeyLayout {
  int sbits, vbits, bw, bmin;
};

template <typename K>
__global__ void __launch_bounds__(kAncThreads)
anchor_expand_kernel(const int* __restrict__ pos, const uint8_t* __restrict__ strand,
                     const int* __restrict__ rows, int cap, const long long* __restrict__ n_kept,
                     const int* __restrict__ occk, const int* __restrict__ left,
                     const long long* __restrict__ offsets, const long long* __restrict__ n_anchors,
                     const int* __restrict__ ps, int band_bits, KeyLayout lay, long long acap,
                     int passes, int* __restrict__ totals, unsigned* __restrict__ published,
                     int* __restrict__ tile_counter, int64_t* __restrict__ key_u,
                     int* __restrict__ qpos_u, int* __restrict__ rpos_u, K* __restrict__ ck) {
  __shared__ int s_base[kAncThreads];
  __shared__ int s_left[kAncThreads];
  __shared__ int s_qpos[kAncThreads];
  __shared__ int s_meta[kAncThreads];  // qid << 1 | strand
  __shared__ int s_digits[kMaxPasses][kRadix];
  const long long m = min(*n_anchors, acap);
  // the sort's counts of its working tiles, and its tile counters: zero
  const long long gid = static_cast<long long>(blockIdx.x) * kAncThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kAncThreads;
  const long long row = (m + SortTile<K>::kSize - 1) / SortTile<K>::kSize * kRadix;
  const long long tiles = (acap + SortTile<K>::kSize - 1) / SortTile<K>::kSize;
  for (long long i = gid; i < passes * row; i += stride)
    published[i / row * tiles * kRadix + i % row] = 0;
  if (gid < passes) tile_counter[gid] = 0;
  const long long live = min(static_cast<long long>(cap), *n_kept);
  const long long n0 = static_cast<long long>(blockIdx.x) * kAncThreads;
  if (n0 >= live) return;
  const long long base = offsets[blockIdx.x];
  if (base >= acap) return;
  const int n = static_cast<int>(n0) + threadIdx.x;
  const int occ = n < live ? occk[n] : 0;
  for (int p = 0; p < passes; ++p) s_digits[p][threadIdx.x] = 0;
  long long total;
  s_base[threadIdx.x] = static_cast<int>(block_exclusive_scan<kAncThreads>(occ, &total));
  if (occ) {
    s_left[threadIdx.x] = left[n];
    s_qpos[threadIdx.x] = pos[n];
    s_meta[threadIdx.x] = rows[n] << 1 | (strand[n] & 1);
  }
  __syncthreads();
  const int count = static_cast<int>(min(total, acap - base));
  const int lane = threadIdx.x & 31;
  // every thread takes as many turns, so that a warp's lanes count their
  // digits together
  for (int i0 = 0; i0 < count; i0 += kAncThreads) {
    const int i = i0 + threadIdx.x;
    K c = 0;
    if (i < count) {
      // the anchor's minimizer: the last r with s_base[r] <= i (it has occ > 0)
      int r = 0;
#pragma unroll
      for (int s = kAncThreads / 2; s; s >>= 1)
        if (s_base[r + s] <= i) r += s;
      const int a = s_left[r] + i - s_base[r];
      const int rp = __ldg(ps + 2 * a);
      const int sv = __ldg(ps + 2 * a + 1);
      const int qp = s_qpos[r], meta = s_meta[r];
      const uint32_t rel = static_cast<uint32_t>((meta ^ sv) & 1);
      const int diag = rel ? rp + qp : rp - qp;
      const uint32_t band = static_cast<uint32_t>((diag + (1 << 28)) >> band_bits);
      const uint32_t qid = static_cast<uint32_t>(meta >> 1), seq = static_cast<uint32_t>(sv >> 1);
      const uint32_t k2 = rel << 24 | band;
      const uint64_t packed = static_cast<uint64_t>(qid << 26 | seq) << 32 | k2;
      const uint64_t vpart = lay.bw >= 0
          ? (static_cast<uint64_t>(rel) << lay.bw | (band - static_cast<uint32_t>(lay.bmin)))
          : static_cast<uint64_t>(k2 - static_cast<uint32_t>(lay.bmin));
      c = static_cast<K>(static_cast<uint64_t>(qid) << (lay.sbits + lay.vbits) |
                         static_cast<uint64_t>(seq) << lay.vbits | vpart);
      const long long slot = base + i;
      key_u[slot] = static_cast<int64_t>(packed ^ 0x8000000000000000ull);
      qpos_u[slot] = qp;
      rpos_u[slot] = rp;
      ck[slot] = c;
    }
    for (int p = 0; p < passes; ++p) {
      const unsigned d = i < count ? static_cast<unsigned>((c >> (8 * p)) & (kRadix - 1)) : kNoDigit;
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
      if (d != kNoDigit && lane == __ffs(peers) - 1) atomicAdd(&s_digits[p][d], __popc(peers));
    }
  }
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    const int c = s_digits[p][threadIdx.x];
    if (c) atomicAdd(totals + p * kRadix + threadIdx.x, c);
  }
}

// The tile's items, warp-striped: item j of lane l in warp w is tile item
// w * 32 * kItems + j * 32 + l, so that a warp's items in (j, lane) order
// are in position order.
template <typename K>
__device__ __forceinline__ int tile_item(int j) {
  return (threadIdx.x >> 5) * 32 * SortTile<K>::kItems + j * 32 + (threadIdx.x & 31);
}

// One stable pass: each item goes to (items of smaller digits in the pass)
// + (items of its digit in earlier tiles) + (its rank among its digit's
// items in the tile). vals_in null: the first pass, the value is the slot.
// keys_out null: the last pass, which writes key, qpos and rpos gathered
// from the slot-ordered scratch by the value, and the sentinel and zeros
// in the slots of its tile past the filled prefix. published [tiles, 256]: each
// tile's digit counts, kReady | count once published (zeroed by the
// expansion for the working tiles).
template <typename K>
__global__ void __launch_bounds__(kSortThreads)
anchor_digit_scatter_kernel(const K* __restrict__ keys_in, const unsigned* __restrict__ vals_in,
                            const long long* __restrict__ n_anchors, long long acap, int shift,
                            int* __restrict__ tile_counter, unsigned* published,
                            const int* __restrict__ totals, K* __restrict__ keys_out,
                            unsigned* __restrict__ vals_out, const int64_t* __restrict__ key_u,
                            const int* __restrict__ qpos_u, const int* __restrict__ rpos_u,
                            int64_t* __restrict__ key, int* __restrict__ qpos,
                            int* __restrict__ rpos) {
  constexpr int IPT = SortTile<K>::kItems, T = SortTile<K>::kSize;
  __shared__ int s_warp[kSortWarps][kRadix];  // per warp and digit: its items, then the prefix
  __shared__ int s_start[kRadix];  // the digit's first place in the tile's digit order
  __shared__ int s_dst[kRadix];  // the digit's output slot minus s_start
  __shared__ K s_key[T];
  __shared__ unsigned s_val[T];
  __shared__ int s_tile;
  // tile ids in the order blocks start: the tiles before this one run
  if (threadIdx.x == 0) s_tile = atomicAdd(tile_counter, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long m = min(*n_anchors, acap);
  const long long t0 = static_cast<long long>(tile) * T;
  if (!keys_out) {  // the last pass: slots past the filled prefix
    for (long long p = max(t0, m) + threadIdx.x; p < min(t0 + T, acap); p += kSortThreads) {
      key[p] = kKeyPad;
      qpos[p] = 0;
      rpos[p] = 0;
    }
  }
  if (t0 >= m) return;
  const int n = static_cast<int>(min(static_cast<long long>(T), m - t0));
  const int d = threadIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) s_warp[w][d] = 0;
  __syncthreads();
  K k[IPT];
  unsigned v[IPT], dg[IPT];
  int rank[IPT];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int i = tile_item<K>(j);
    const bool ok = i < n;
    k[j] = ok ? keys_in[t0 + i] : K(0);
    v[j] = ok ? (vals_in ? vals_in[t0 + i] : static_cast<unsigned>(t0 + i)) : 0u;
    dg[j] = ok ? static_cast<unsigned>((k[j] >> shift) & (kRadix - 1)) : kNoDigit;
  }
  // ranks within the warp, in (j, lane) order: the lowest lane of each
  // group of equal digits reads and bumps the warp's count
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, dg[j]);
    const int leader = __ffs(peers) - 1;
    int r0 = 0;
    if (lane == leader && dg[j] != kNoDigit) {
      r0 = s_warp[warp][dg[j]];
      s_warp[warp][dg[j]] = r0 + __popc(peers);
    }
    r0 = __shfl_sync(peers, r0, leader);
    rank[j] = r0 + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
  }
  __syncthreads();
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const int c = s_warp[w][d];
    s_warp[w][d] = cnt;
    cnt += c;
  }
  // publish this tile's count of digit d (flag and count in one word)
  reinterpret_cast<volatile unsigned*>(published)[tile * kRadix + d] = kReady | static_cast<unsigned>(cnt);
  long long all;
  const int start = static_cast<int>(block_exclusive_scan<kSortThreads>(cnt, &all));
  s_start[d] = start;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    if (dg[j] != kNoDigit) {
      const int at = s_start[dg[j]] + s_warp[warp][dg[j]] + rank[j];
      s_key[at] = k[j];
      s_val[at] = v[j];
    }
  }
  const int below = static_cast<int>(block_exclusive_scan<kSortThreads>(totals[d], &all));
  // digit d's items in the tiles before this one, 32 counts in flight
  const volatile unsigned* col = published + d;
  int before = 0;
  for (int b = 0; b < tile; b += 32) {
    unsigned c[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) c[j] = b + j < tile ? col[(b + j) * kRadix] : kReady;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      while (!(c[j] & kReady)) c[j] = col[(b + j) * kRadix];
      before += static_cast<int>(c[j] & ~kReady);
    }
  }
  s_dst[d] = below + before - start;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kSortThreads) {
    const K kk = s_key[i];
    const long long dst = static_cast<long long>(s_dst[static_cast<int>((kk >> shift) & (kRadix - 1))]) + i;
    const unsigned src = s_val[i];
    if (keys_out) {
      keys_out[dst] = kk;
      vals_out[dst] = src;
    } else {
      key[dst] = key_u[src];
      qpos[dst] = qpos_u[src];
      rpos[dst] = rpos_u[src];
    }
  }
}

// The passes' keys go ck -> kbuf -> ck -> ..., their values vbuf[0] ->
// vbuf[1] -> vbuf[0] -> ...; the last pass writes the outputs.
template <typename K>
int launch_sort(K* ck, K* kbuf, unsigned* vbuf, int passes, int tiles,
                const long long* n_anchors, long long acap, int* tile_counter,
                unsigned* published, const int* totals, const int64_t* key_u, const int* qpos_u,
                const int* rpos_u, int64_t* key, int* qpos, int* rpos, cudaStream_t s) {
  const K* kin = ck;
  const unsigned* vin = nullptr;
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    K* kout = last ? nullptr : (p & 1 ? ck : kbuf);
    unsigned* vout = last ? nullptr : vbuf + static_cast<long long>(p & 1) * acap;
    anchor_digit_scatter_kernel<K><<<tiles, kSortThreads, 0, s>>>(
        kin, vin, n_anchors, acap, 8 * p, tile_counter + p,
        published + static_cast<long long>(p) * tiles * kRadix, totals + p * kRadix, kout, vout,
        key_u, qpos_u, rpos_u, key, qpos, rpos);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    kin = kout;
    vin = vout;
  }
  return 0;
}

}  // namespace

// Launches the search, the scan, the expansion and `passes` sort passes on
// `stream`; returns the first launch error (0 = launched). nb must equal
// ceil(cap / 256) and tiles ceil(acap / tile), tile = 4096 for key_bytes
// 4 and 2048 for 8; passes = ceil((qid bits + sbits + vbits) / 8) with
// the compact key in key_bytes. Scratch: occk, left [cap] and block_sums
// [nb] int32, offsets [nb] int64; key_u [acap] int64, qpos_u, rpos_u
// [acap] int32, ck and kbuf [acap] keys of key_bytes, vbuf [2, acap]
// uint32, published [passes, tiles, 256] uint32, totals [passes, 256] and
// tile_counter [passes] int32. Outputs: n_anchors [1] int64, key [acap]
// int64, qpos, rpos [acap] int32. The caller checks dtypes, shapes,
// contiguity, the layout, and that cap, U and acap are below 2^31.
extern "C" int anchors_launch(const int64_t* hash, const int* pos, const uint8_t* strand,
                              const int* rows, const long long* n_kept, int cap,
                              const int64_t* uniq, const int* bucket, int n_buckets, int shift,
                              const int* roff, const int* ps, int max_occ, int band_bits,
                              int sbits, int vbits, int bw, int bmin, int key_bytes, int passes,
                              int nb, int tiles, int* occk, int* left, int* block_sums,
                              long long* offsets, long long* n_anchors, long long acap,
                              int64_t* key_u, int* qpos_u, int* rpos_u, void* ck, void* kbuf,
                              unsigned* vbuf, unsigned* published, int* totals,
                              int* tile_counter, int64_t* key, int* qpos, int* rpos,
                              void* stream) {
  const int tile = key_bytes == 4 ? SortTile<uint32_t>::kSize : SortTile<uint64_t>::kSize;
  if (cap < 1 || nb != (cap + kAncThreads - 1) / kAncThreads || (key_bytes != 4 && key_bytes != 8) ||
      passes < 1 || passes > key_bytes || tiles != (acap + tile - 1) / tile)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  anchor_search_kernel<<<nb, kAncThreads, 0, s>>>(hash, n_kept, cap, uniq, bucket, n_buckets, shift,
                                                  roff, max_occ, occk, left, block_sums, totals,
                                                  passes * kRadix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_block_counts<<<1, kScanThreads, 0, s>>>(block_sums, nb, offsets, n_anchors);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const KeyLayout lay{sbits, vbits, bw, bmin};
  if (key_bytes == 4) {
    anchor_expand_kernel<uint32_t><<<nb, kAncThreads, 0, s>>>(
        pos, strand, rows, cap, n_kept, occk, left, offsets, n_anchors, ps, band_bits, lay, acap,
        passes, totals, published, tile_counter, key_u, qpos_u, rpos_u,
        static_cast<uint32_t*>(ck));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_sort<uint32_t>(static_cast<uint32_t*>(ck), static_cast<uint32_t*>(kbuf), vbuf,
                                 passes, tiles, n_anchors, acap, tile_counter, published, totals,
                                 key_u, qpos_u, rpos_u, key, qpos, rpos, s);
  }
  anchor_expand_kernel<uint64_t><<<nb, kAncThreads, 0, s>>>(
      pos, strand, rows, cap, n_kept, occk, left, offsets, n_anchors, ps, band_bits, lay, acap,
      passes, totals, published, tile_counter, key_u, qpos_u, rpos_u,
      static_cast<uint64_t*>(ck));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sort<uint64_t>(static_cast<uint64_t*>(ck), static_cast<uint64_t*>(kbuf), vbuf,
                               passes, tiles, n_anchors, acap, tile_counter, published, totals,
                               key_u, qpos_u, rpos_u, key, qpos, rpos, s);
}
