// Minimizers of a staged batch, compacted, written by hand for Hopper.
//
// Replaces hymet_tpu/ops/minimizer.py:241 extract_minimizers_jax (with
// hash64_jax and _window_min_pairs) and the keep-flag compaction of
// hymet_tpu/models/aligner.py:1007-1012 (a stable sort of (not keep, iota)
// over all B x NW windows, cut to `cap`). Input: a batch as StagedContigs
// holds it, packed [B, W] uint8 (four 2-bit codes a byte) and mask [B, M]
// uint8 (one validity bit a position), rows of L positions. For every
// window g < NW = L - k - w + 2 of w k-mers:
//   h(i) = minimap2's hash64 of k-mer i's canonical 2k-bit value (masked
//          to 2k bits), or all ones where the k-mer holds a position the
//          mask marks invalid;
//   m(g) = the leftmost i in [g, g + w) with the least h(i) (unsigned);
//   keep = m(g) != m(g - 1) and h(m(g)) != all ones.
// The kept windows' (hash, position m, strand, row) go to slots 0, 1, ...
// in row-major window order, as far as `cap`; the rest of the slots are
// zero, and n_kept counts every kept window (the caller retries with a
// larger cap when it exceeds it). An optional row_len[B] ends row r's
// windows at row_len[r] - k - w + 2 (the index build's unpadded rows).
//
// Design: a single-pass compaction with a decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016). A block owns a tile of 2048 consecutive windows of one row and
// takes its tile id from an atomic counter, so every tile before it is
// resident or finished and the look-back cannot wait on a tile that never
// runs; tiles are numbered row-major. The block
//   1. reads the tile's codes and mask bits (plus a halo of one window to
//      the left and w - 1 k-mers to the right) into shared memory, as one
//      aligned 32-bit code word and 16-bit mask word a thread, testing
//      bounds only at a row's two ends; zeroes the codes of invalid
//      positions (the JAX package unpacks them to code 4, whose low bits
//      are 0);
//   2. hashes every k-mer of the tile once, a run of 16 a thread with
//      kmer_core.cuh's rolling 2-bit words (the forward and
//      reverse-complement words of each k-mer are shifts of the run's two
//      streams): 160 threads cover the up to 145 runs of a tile at
//      w <= 256, so there is no second round;
//   3. finds the leftmost minimum of 16 windows a thread by a van Herk /
//      Gil-Werman decomposition (suffix minima of one block of w k-mers,
//      prefix minima of the next), the same shared loads in every thread
//      and no rescans that diverge a warp; the keep bits and each window's
//      k-mer stay in registers;
//   4. ranks its kept windows by a block scan, publishes the tile's count
//      as an aggregate, walks back over the preceding tiles' status words
//      (one warp, 32 tiles a step) to the nearest inclusive prefix and
//      publishes its own;
//   5. writes its kept windows at prefix + rank.
// A status word holds flag and value in one 64-bit word, written with one
// store. A tile past row_len leaves without loading, and a tile whose mask
// words are all zero (80 % of the staged screen's positions) leaves after
// its load; both publish a count of 0, inclusive at once where the tile
// before is already inclusive, so a row's later tiles need not walk back
// over a long run of them. The last tile's inclusive prefix is n_kept. A
// second kernel zeroes the [cap] slots past n_kept with 16-byte stores.
// A call: one memset of the status words and tile counter, two kernels.
//
// What bounds it on an H100. At full occupancy the integer pipes: per
// k-mer about 60 32-bit instructions (the two 2-bit words, their compare
// and select, hash64's 64-bit shifts, adds and masks), per window about 8
// more for the sliding minimum, against 0.375 bytes of input a position
// (chip_smoke.py::minimizer_bound_ms counts it). A staged batch holds only
// about 390 working tiles, about 3 an SM, so what sets the time is latency:
// each tile's critical path (load, one hashing round, the slide, the
// look-back, the writes), the padding tiles' turnover before the last
// working tiles start, and the launches. The design hashes each k-mer
// once, in one round, slides without divergence, makes one pass over the
// batch, and keeps a block at 64 registers or fewer so that 6 blocks of
// 160 threads fit an SM.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_core.cuh"
#include "scan.cuh"

namespace {

using namespace hymet;

constexpr int kSlideThreads = 128;                 // threads that slide, 16 windows each
constexpr int kMinTile = kSlideThreads * kRun;     // windows a tile
constexpr int kMaxW = 256;
// k-mers a tile hashes: from b0 - kRun (window b0 - 1 starts at k-mer
// b0 - 1) through b0 + kMinTile + w - 2
constexpr int kMaxRuns = (kRun + kMinTile + kMaxW - 1 + kRun - 1) / kRun;
constexpr int kCodeWords = kMaxRuns + 3;  // a run reads 4 words of 16 bases
constexpr int kMinThreads = 160;          // one run a thread, one word a thread
static_assert(kMinThreads >= kCodeWords && kMinThreads % 32 == 0, "a thread a run and a word");
constexpr int kMinBlocks = 6;              // blocks an SM (at most 64 registers a thread)
constexpr int kTailThreads = 256;
constexpr uint64_t kBad = ~0ull;

// A tile's status word: flag in the top two bits, value (a count of kept
// windows) below. 0 = not yet published.
constexpr unsigned long long kAggregate = 1ull << 62;  // the tile's own count
constexpr unsigned long long kInclusive = 2ull << 62;  // count of this tile and all before
constexpr unsigned long long kValue = kAggregate - 1;
constexpr unsigned kAll = 0xFFFFFFFFu;

// Shared tables hold one spare entry after every 16 (hix): a thread's 16
// k-mers start 17 entries after its neighbour's, so a warp's accesses fall
// on different banks instead of all on one.
constexpr int kPad = kRun + 1;

__device__ __forceinline__ int hix(int e) { return e + e / kRun; }

struct Tile {
  uint64_t hash[kMaxRuns * kPad];  // k-mer b0 - kRun + e at hix(e)
  uint16_t strand[kMaxRuns];       // bit j of word r: k-mer 16 r + j
  uint32_t code[kCodeWords];       // 2-bit codes, 16 bases a word
  uint16_t mask[kCodeWords];       // validity bits, 16 a word
};

__device__ __forceinline__ uint64_t hash64(uint64_t key, uint64_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ key >> 24;
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ key >> 14;
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ key >> 28;
  return (key + (key << 31)) & mask;
}

// bit i of m16 -> bits 2i and 2i + 1
__device__ __forceinline__ uint32_t spread2(uint32_t x) {
  x &= 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x | (x << 1);
}

__device__ __forceinline__ uint32_t load_bytes(const uint8_t* __restrict__ row, long long at,
                                               int n, long long avail) {
  uint32_t v = 0;
  for (int b = 0; b < n; ++b) {
    const long long i = at + b;
    if (i >= 0 && i < avail) v |= static_cast<uint32_t>(row[i]) << (8 * b);
  }
  return v;
}

// The status words are read past L1 (not coherent across SMs) and written
// with one 64-bit store after a fence.
__device__ __forceinline__ unsigned long long peek(const unsigned long long* word) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(word) : "memory");
  return v;
}

__device__ __forceinline__ void publish(unsigned long long* word, unsigned long long v) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(word) = v;
}

// Warp 0 of tile `tile` (all 32 lanes): publishes the tile's aggregate,
// sums the preceding tiles' counts back to the nearest inclusive prefix
// (waiting only on tiles up to that one), publishes the tile's inclusive
// prefix and returns the count of every kept window before the tile.
__device__ long long look_back(unsigned long long* status, int tile, long long total) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) publish(status + tile, kAggregate | static_cast<unsigned long long>(total));
  long long before = 0;
  for (int hi = tile - 1;; hi -= 32) {
    const int j = hi - lane;  // lane 0 the nearest tile
    unsigned long long s;
    unsigned inclusive, upto;
    for (;;) {
      s = j >= 0 ? peek(status + j) : kInclusive;  // before tile 0: an inclusive 0
      inclusive = __ballot_sync(kAll, s >= kInclusive);
      const unsigned pending = __ballot_sync(kAll, s < kAggregate);
      upto = inclusive ? inclusive ^ (inclusive - 1) : kAll;  // lanes through the nearest inclusive
      if (!(pending & upto)) break;
    }
    long long v = (upto >> lane) & 1u ? static_cast<long long>(s & kValue) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
    before += v;
    if (inclusive) break;
  }
  if (lane == 0)
    publish(status + tile, kInclusive | static_cast<unsigned long long>(before + total));
  return before;
}

// Warp 0 of a tile that keeps nothing. The last tile walks back, since its
// inclusive prefix is n_kept; any other publishes 0 as its aggregate and,
// where the tile before is already inclusive, that prefix as its own.
__device__ __forceinline__ void publish_empty(unsigned long long* status, int tile, int ntiles,
                                              long long* n_kept) {
  if (tile == ntiles - 1) {
    const long long before = look_back(status, tile, 0);
    if (threadIdx.x == 0) *n_kept = before;
  } else if (threadIdx.x == 0) {
    publish(status + tile, kAggregate);
    const unsigned long long prev = tile > 0 ? peek(status + tile - 1) : kInclusive;
    if (prev >= kInclusive) publish(status + tile, prev);
  }
}

// Thread tid's word of the tile's codes and mask bits into shared memory,
// with the invalid positions' codes zeroed; true in every thread when any
// mask bit of the tile is set.
__device__ __forceinline__ bool load_tile(Tile& t, const uint8_t* __restrict__ prow,
                                          const uint8_t* __restrict__ mrow, int W, int M,
                                          bool aligned, long long a0, int nwords) {
  const int tid = threadIdx.x;
  uint32_t m16 = 0;
  if (tid < nwords) {
    const long long p = a0 + 16LL * tid;  // a multiple of 16
    uint32_t c;
    if (aligned && p >= 0 && p + 16 <= 8LL * M) {  // a whole word inside the row
      m16 = *reinterpret_cast<const uint16_t*>(mrow + (p >> 3));
      c = *reinterpret_cast<const uint32_t*>(prow + (p >> 2));
    } else {
      m16 = load_bytes(mrow, p >> 3, 2, M);
      c = load_bytes(prow, p >> 2, 4, W);
    }
    t.mask[tid] = static_cast<uint16_t>(m16);
    t.code[tid] = c & spread2(m16);
  }
  return __syncthreads_or(m16 != 0);
}

// Hash run r of the tile (k-mers 16 r .. 16 r + 15 from b0 - kRun) into
// t.hash and t.strand.
__device__ __forceinline__ void hash_tile_run(Tile& t, int r, int k) {
  const uint64_t kmask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  const int sh = 2 * (65 - kRun - k);  // 34 .. 96, as in hash_run
  uint32_t code[4];
  run_codes(t.code, r, code);
  const uint32_t vb = window_valid(run_valid_bits(t.mask, r), k);
  const uint64_t s0 = code[0] | static_cast<uint64_t>(code[1]) << 32;
  const uint64_t s1 = code[2] | static_cast<uint64_t>(code[3]) << 32;
  const uint64_t r0 = ~rev2(s1), r1 = ~rev2(s0);
  const uint64_t x0 = sh >= 64 ? r1 >> (sh - 64) : (r0 >> sh) | (r1 << (64 - sh));
  const uint64_t x1 = sh >= 64 ? 0 : r1 >> sh;
  uint32_t sb = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    // LSB-first windows of the two streams: the forward k-mer read
    // MSB-first is ~x, its reverse complement ~f
    const uint64_t f = bits64(s0, s1, 2 * j) & kmask;
    const uint64_t x = bits64(x0, x1, 2 * (kRun - 1 - j)) & kmask;
    const bool forward = f <= x;
    sb |= static_cast<uint32_t>(!forward) << j;
    const uint64_t canon = (forward ? ~x : ~f) & kmask;
    t.hash[kPad * r + j] = (vb >> j) & 1u ? hash64(canon, kmask) : kBad;
  }
  t.strand[r] = static_cast<uint16_t>(sb);
}

__global__ void __launch_bounds__(kMinThreads, kMinBlocks)
minimizer_tile_kernel(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ mask, int W,
                      int M, int k, int w, const int* __restrict__ row_len, long long nw,
                      int tiles_per_row, int ntiles, int aligned,
                      unsigned long long* __restrict__ status, long long* __restrict__ n_kept,
                      long long cap, int64_t* __restrict__ hash, int* __restrict__ pos,
                      uint8_t* __restrict__ strand, int* __restrict__ rows) {
  __shared__ Tile t;
  __shared__ int s_tile;
  __shared__ long long s_before;
  const int tid = threadIdx.x;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(status + ntiles, 1ull));
  __syncthreads();
  const int tile = s_tile;
  const int row = tile / tiles_per_row;
  const long long b0 = static_cast<long long>(tile % tiles_per_row) * kMinTile;
  const long long a0 = b0 - kRun;  // the tile's first k-mer and base
  long long nw_row = nw;
  if (row_len != nullptr) nw_row = min(nw, static_cast<long long>(row_len[row]) - k - w + 2);
  const int nruns = (kRun + kMinTile + w - 1 + kRun - 1) / kRun;
  // a tile past row_len loads nothing; a tile of padding leaves after its load
  if (b0 >= nw_row || !load_tile(t, packed + static_cast<size_t>(row) * W,
                                 mask + static_cast<size_t>(row) * M, W, M, aligned != 0, a0,
                                 nruns + 3)) {
    if (tid < 32) publish_empty(status, tile, ntiles, n_kept);
    return;
  }
  if (tid < nruns) hash_tile_run(t, tid, k);
  __syncthreads();

  // windows b0 + i0 + q, q = 0 .. 15; sel[q] the local k-mer of window q's
  // minimum
  uint32_t keep = 0;
  int sel[kRun];
  const int i0 = kRun * tid;
  const long long g0 = b0 + i0;
  if (tid < kSlideThreads && g0 < nw_row) {
    const uint64_t* h = t.hash;
    // Leftmost minima of windows g0 - 1 .. g0 + 15 (window q - 1 starts at
    // local k-mer e0 - 1 + q), by the van Herk / Gil-Werman decomposition
    // into blocks of w k-mers, one of which ends at e0 + 15: a window is a
    // suffix of one block and a prefix of the next, or one whole block. 17
    // suffix minima (from e0 + 15 down) and 17 prefix minima (streamed up
    // from the block of the first window's last k-mer) give every window
    // with w + 34 or fewer shared loads, the same for every thread.
    const int e0 = i0 + kRun;
    uint64_t suf_h[kRun + 1];
    int suf_i[kRun + 1];
    {
      uint64_t rh = 0;
      int ri = 0, c = 0;  // c: k-mers of the current block taken so far
#pragma unroll
      for (int q = kRun; q >= 0; --q) {
        const int e = e0 - 1 + q;
        const uint64_t he = h[hix(e)];
        if (c == 0 || he <= rh) {  // a block's last k-mer, or a leftmost minimum
          rh = he;
          ri = e;
        }
        if (++c == w) c = 0;
        suf_h[q] = rh;
        suf_i[q] = ri;
      }
    }
    const int x0 = e0 + w - 2;  // the last k-mer of window g0 - 1
    int off = (w - kRun - 2) % w;  // x0's place in its block: x0 - (e0 + kRun) mod w
    if (off < 0) off += w;
    uint64_t ph = 0;
    int pi = 0, c = 0;
    auto take = [&](int e) {  // the next k-mer into the block's prefix minimum
      const uint64_t he = h[hix(e)];
      if (c == 0 || he < ph) {
        ph = he;
        pi = e;
      }
      if (++c == w) c = 0;
    };
    for (int e = x0 - off; e < x0; ++e) take(e);
    long long prev = -1;
#pragma unroll
    for (int q = 0; q <= kRun; ++q) {
      take(x0 + q);
      // window g0 - 1 + q: the suffix part wins ties (its k-mers lie left)
      const bool left = suf_h[q] <= ph;
      const uint64_t mh = left ? suf_h[q] : ph;
      const int m = left ? suf_i[q] : pi;
      if (q == 0) {
        prev = g0 == 0 ? -1 : m;  // window g0 - 1, the previous window's minimum
        continue;
      }
      if (g0 + q - 1 < nw_row && m != prev && mh != kBad) keep |= 1u << (q - 1);
      prev = m;
      sel[q - 1] = m;
    }
  }

  long long total;
  const long long rank = block_exclusive_scan<kMinThreads>(__popc(keep), &total);
  if (tid < 32) {
    const long long before = look_back(status, tile, total);
    if (tid == 0) {
      s_before = before;
      if (tile == ntiles - 1) *n_kept = before + total;
    }
  }
  __syncthreads();
  if (!keep) return;
  long long slot = s_before + rank;
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    if (!((keep >> q) & 1u)) continue;
    if (slot < cap) {
      const int e = sel[q];
      hash[slot] = static_cast<int64_t>(t.hash[hix(e)]);
      pos[slot] = static_cast<int>(a0 + e);
      strand[slot] = static_cast<uint8_t>((t.strand[e / kRun] >> (e % kRun)) & 1u);
      rows[slot] = row;
    }
    ++slot;
  }
}

// Bytes [from, to) of p set to zero: 16-byte stores over the aligned middle,
// byte stores at the two ends; thread i of `stride` takes every stride-th.
__device__ __forceinline__ void zero_bytes(uint8_t* p, long long from, long long to, long long i,
                                           long long stride) {
  if (from >= to) return;
  const uintptr_t b = reinterpret_cast<uintptr_t>(p + from), e = reinterpret_cast<uintptr_t>(p + to);
  const uintptr_t ab = (b + 15) & ~static_cast<uintptr_t>(15), ae = e & ~static_cast<uintptr_t>(15);
  if (ab >= ae) {
    for (long long x = from + i; x < to; x += stride) p[x] = 0;
    return;
  }
  const long long head = static_cast<long long>(ab - b), tail = static_cast<long long>(e - ae);
  for (long long x = i; x < head; x += stride) p[from + x] = 0;
  for (long long x = i; x < tail; x += stride) p[to - tail + x] = 0;
  int4* q = reinterpret_cast<int4*>(ab);
  const long long n = static_cast<long long>(ae - ab) / 16;
  for (long long x = i; x < n; x += stride) q[x] = make_int4(0, 0, 0, 0);
}

// The [cap] slots past the last kept window hold zeros.
__global__ void __launch_bounds__(kTailThreads)
minimizer_tail_kernel(const long long* __restrict__ n_kept, long long cap,
                      int64_t* __restrict__ hash, int* __restrict__ pos,
                      uint8_t* __restrict__ strand, int* __restrict__ rows) {
  const long long n = min(*n_kept, cap);
  const long long i = static_cast<long long>(blockIdx.x) * kTailThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kTailThreads;
  zero_bytes(reinterpret_cast<uint8_t*>(hash), 8 * n, 8 * cap, i, stride);
  zero_bytes(reinterpret_cast<uint8_t*>(pos), 4 * n, 4 * cap, i, stride);
  zero_bytes(strand, n, cap, i, stride);
  zero_bytes(reinterpret_cast<uint8_t*>(rows), 4 * n, 4 * cap, i, stride);
}

}  // namespace

// Zeroes the status words, then launches the tile kernel and the tail
// kernel on `stream`; returns the first error (0 = launched). nb must equal
// B * ceil(NW / 2048) and be below 2^31; status [nb + 1] (8-byte words:
// the tiles' status, then the tile counter) is scratch, n_kept [1] int64
// output. The caller checks dtypes, shapes, contiguity, 1 <= k <= 32,
// 1 <= B <= 65535 and L < 2^31.
extern "C" int minimizers_launch(const uint8_t* packed, const uint8_t* mask, int B, int W, int M,
                                 int L, int k, int w, const int* row_len, int nb,
                                 unsigned long long* status, long long* n_kept, long long cap,
                                 int64_t* hash, int* pos, uint8_t* strand, int* rows,
                                 void* stream) {
  const long long nw = static_cast<long long>(L) - k - w + 2;
  const long long tiles = (nw + kMinTile - 1) / kMinTile;
  if (nw < 1 || w < 1 || w > kMaxW || nb < 1 || tiles * B != nb)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // whole 32-bit code words and 16-bit mask words lie aligned in every row
  const int aligned = W % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(mask) % 2 == 0;
  cudaError_t err = cudaMemsetAsync(status, 0, sizeof(unsigned long long) * (nb + 1LL), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  minimizer_tile_kernel<<<nb, kMinThreads, 0, s>>>(packed, mask, W, M, k, w, row_len, nw,
                                                   static_cast<int>(tiles), nb, aligned, status,
                                                   n_kept, cap, hash, pos, strand, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long chunks = (8 * cap + 16LL * kTailThreads - 1) / (16LL * kTailThreads);
  const int grid = static_cast<int>(chunks < 1024 ? chunks : 1024);
  minimizer_tail_kernel<<<grid, kTailThreads, 0, s>>>(n_kept, cap, hash, pos, strand, rows);
  return static_cast<int>(cudaGetLastError());
}
