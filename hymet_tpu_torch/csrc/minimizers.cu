// Minimizers of a staged batch, compacted, written by hand for Hopper.
//
// Replaces hymet_tpu/ops/minimizer.py::extract_minimizers_jax (with
// hash64_jax and _window_min_pairs) and the keep-flag compaction of
// hymet_tpu/models/aligner.py::_collect_sorted_impl (a stable sort of
// (not keep, iota) over all B x NW windows, cut to `cap`). Input: a batch
// as StagedContigs holds it, packed [B, W] uint8 (four 2-bit codes a byte)
// and mask [B, M] uint8 (one validity bit a position), rows of L
// positions. For every window g < NW = L - k - w + 2 of w k-mers:
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
// Design. A block owns a tile of 2048 consecutive windows of one row. It
// reads the tile's codes and mask bits (plus a halo of one window to the
// left and w - 1 k-mers to the right) into shared memory, leaves at once if
// they are all padding (80 % of the staged screen's positions), zeroes the codes
// of invalid positions (the JAX package unpacks them to code 4, whose low
// bits are 0), and hashes the tile's k-mers in runs of 16 with
// kmer_core.cuh's rolling 2-bit words: the forward and reverse-complement
// words of each k-mer are shifts of the run's two streams, so nothing is
// repacked per k-mer. Each thread then slides over 16 windows, keeping the
// current minimum and scanning a window again only when its minimum leaves
// it. The shared tables are padded so that the 16-entry stretches of
// neighbouring threads fall on different banks. The compaction is a count
// pass, scan_block_counts and a write pass that computes the tile again
// (hashing is cheaper than keeping the windows in device memory between
// the passes).
//
// What bounds it on an H100: the integer pipes. Per k-mer about 60 32-bit
// instructions (the two 2-bit words, their compare and select, hash64's
// 64-bit shifts, adds and masks), per window about 8 more for the sliding
// minimum, done twice (count and write pass), against 0.375 bytes of input
// a position (chip_smoke.py::minimizer_bound_ms counts it).

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_core.cuh"
#include "scan.cuh"

namespace {

using namespace hymet;

HYMET_SCAN_KERNEL

constexpr int kMinThreads = 128;
constexpr int kMinTile = kMinThreads * kRun;  // windows a block
constexpr int kMaxW = 256;
// k-mers a tile hashes: from b0 - kRun (window b0 - 1 starts at k-mer
// b0 - 1) through b0 + kMinTile + w - 2
constexpr int kMaxRuns = (kRun + kMinTile + kMaxW - 1 + kRun - 1) / kRun;
constexpr int kCodeWords = kMaxRuns + 3;  // a run reads 4 words of 16 bases
constexpr uint64_t kBad = ~0ull;

// Shared tables hold one spare entry after every 16 (hix): a thread's 16
// k-mers (or windows) then start 17 entries after its neighbour's, so a
// warp's accesses fall on different banks instead of all on one.
constexpr int kPad = kRun + 1;

__device__ __forceinline__ int hix(int e) { return e + e / kRun; }

struct Tile {
  uint64_t hash[kMaxRuns * kPad];  // k-mer b0 - kRun + e at hix(e)
  uint16_t strand[kMaxRuns];       // bit j of word r: k-mer 16 r + j
  uint32_t code[kCodeWords];       // 2-bit codes, 16 bases a word
  uint16_t mask[kCodeWords];       // validity bits, 16 a word
  int sel[kMinThreads * kPad];     // the write pass: each window's k-mer
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

// Load, hash and slide one tile; returns the thread's keep bits (bit q:
// window b0 + kRun * tid + q). kWrite: record each window's k-mer in sel.
// A tile whose mask bits are all zero keeps nothing and returns 0 in every
// thread right after the load.
template <bool kWrite>
__device__ __forceinline__ uint32_t tile_windows(Tile& t, const uint8_t* __restrict__ packed,
                                                 const uint8_t* __restrict__ mask, int W, int M,
                                                 int k, int w, long long nw_row, long long b0) {
  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const long long a0 = b0 - kRun;  // the tile's first k-mer and base
  const int nruns = (kRun + kMinTile + w - 1 + kRun - 1) / kRun;
  const uint8_t* prow = packed + static_cast<size_t>(row) * W;
  const uint8_t* mrow = mask + static_cast<size_t>(row) * M;
  uint32_t any = 0;
  for (int i = tid; i < nruns + 3; i += kMinThreads) {
    const long long p = a0 + 16LL * i;  // a multiple of 16
    const uint32_t m16 = load_bytes(mrow, p >> 3, 2, M);
    any |= m16;
    t.mask[i] = static_cast<uint16_t>(m16);
    t.code[i] = load_bytes(prow, p >> 2, 4, W) & spread2(m16);
  }
  if (!__syncthreads_or(any != 0)) return 0;  // all padding

  const uint64_t kmask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  const int sh = 2 * (65 - kRun - k);  // 34 .. 96, as in hash_run
  for (int r = tid; r < nruns; r += kMinThreads) {
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
  __syncthreads();

  // windows b0 + i0 + q, local k-mer start e = i0 + q + kRun
  const int i0 = kRun * tid;
  const long long g0 = b0 + i0;
  if (g0 >= nw_row) return 0;
  const uint64_t* h = t.hash;
  auto leftmost_min = [&](int e) {
    int best = e;
    uint64_t hb = h[hix(e)];
    for (int q = 1; q < w; ++q) {
      const uint64_t hq = h[hix(e + q)];
      if (hq < hb) {
        hb = hq;
        best = e + q;
      }
    }
    return best;
  };
  int cur = leftmost_min(i0 + kRun - 1);  // window g0 - 1
  uint64_t hcur = h[hix(cur)];
  long long prev = g0 == 0 ? -1 : a0 + cur;
  uint32_t keep = 0;
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    const int e = i0 + kRun + q;
    const uint64_t hn = h[hix(e + w - 1)];
    if (hn < hcur) {
      cur = e + w - 1;
      hcur = hn;
    } else if (cur < e) {
      cur = leftmost_min(e);
      hcur = h[hix(cur)];
    }
    const long long m = a0 + cur;
    if (g0 + q < nw_row && m != prev && hcur != kBad) keep |= 1u << q;
    prev = m;
    if (kWrite) t.sel[kPad * tid + q] = cur;
  }
  return keep;
}

__device__ __forceinline__ long long row_windows(const int* __restrict__ row_len, int L, int k,
                                                 int w) {
  const long long nw = static_cast<long long>(L) - k - w + 2;
  if (row_len == nullptr) return nw;
  const long long own = static_cast<long long>(row_len[blockIdx.y]) - k - w + 2;
  return own < nw ? own : nw;
}

__global__ void __launch_bounds__(kMinThreads)
minimizer_count_kernel(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ mask,
                       int W, int M, int L, int k, int w, const int* __restrict__ row_len,
                       int* __restrict__ counts) {
  __shared__ Tile t;
  const long long b0 = static_cast<long long>(blockIdx.x) * kMinTile;
  const uint32_t keep =
      tile_windows<false>(t, packed, mask, W, M, k, w, row_windows(row_len, L, k, w), b0);
  long long total;
  block_exclusive_scan<kMinThreads>(__popc(keep), &total);
  if (threadIdx.x == 0) counts[blockIdx.y * gridDim.x + blockIdx.x] = static_cast<int>(total);
}

__global__ void __launch_bounds__(kMinThreads)
minimizer_write_kernel(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ mask,
                       int W, int M, int L, int k, int w, const int* __restrict__ row_len,
                       const long long* __restrict__ offsets, const long long* __restrict__ n_kept,
                       long long cap, int64_t* __restrict__ hash, int* __restrict__ pos,
                       uint8_t* __restrict__ strand, int* __restrict__ rows) {
  __shared__ Tile t;
  const int tid = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * kMinTile;
  const long long blk = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  const uint32_t keep =
      tile_windows<true>(t, packed, mask, W, M, k, w, row_windows(row_len, L, k, w), b0);
  long long total;
  long long slot = offsets[blk] + block_exclusive_scan<kMinThreads>(__popc(keep), &total);
  const long long a0 = b0 - kRun;
  for (int q = 0; q < kRun; ++q) {
    if (!((keep >> q) & 1u)) continue;
    if (slot < cap) {
      const int e = t.sel[kPad * tid + q];
      hash[slot] = static_cast<int64_t>(t.hash[hix(e)]);
      pos[slot] = static_cast<int>(a0 + e);
      strand[slot] = static_cast<uint8_t>((t.strand[e / kRun] >> (e % kRun)) & 1u);
      rows[slot] = blockIdx.y;
    }
    ++slot;
  }
  // slots past the last kept window hold zeros
  const long long nblk = static_cast<long long>(gridDim.x) * gridDim.y;
  for (long long p = *n_kept + blk * kMinThreads + tid; p < cap; p += nblk * kMinThreads) {
    hash[p] = 0;
    pos[p] = 0;
    strand[p] = 0;
    rows[p] = 0;
  }
}

}  // namespace

// Launches the count pass, the scan and the write pass on `stream`; returns
// the first launch error (0 = launched). nb must equal B * ceil(NW / 2048);
// counts [nb] int32, offsets [nb] int64 and n_kept [1] int64 are scratch and
// output. The caller checks dtypes, shapes, contiguity, 1 <= k <= 32,
// 1 <= B <= 65535 and L < 2^31.
extern "C" int minimizers_launch(const uint8_t* packed, const uint8_t* mask, int B, int W, int M,
                                 int L, int k, int w, const int* row_len, int nb, int* counts,
                                 long long* offsets, long long* n_kept, long long cap,
                                 int64_t* hash, int* pos, uint8_t* strand, int* rows,
                                 void* stream) {
  const long long nw = static_cast<long long>(L) - k - w + 2;
  const long long tiles = (nw + kMinTile - 1) / kMinTile;
  if (nw < 1 || w < 1 || w > kMaxW || tiles * B != nb) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(tiles), B);
  minimizer_count_kernel<<<grid, kMinThreads, 0, s>>>(packed, mask, W, M, L, k, w, row_len, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_block_counts<<<1, kScanThreads, 0, s>>>(counts, nb, offsets, n_kept);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  minimizer_write_kernel<<<grid, kMinThreads, 0, s>>>(packed, mask, W, M, L, k, w, row_len, offsets,
                                                      n_kept, cap, hash, pos, strand, rows);
  return static_cast<int>(cudaGetLastError());
}
