// Bottom-s distinct sketch of rows (or groups of rows) of k-mer hashes,
// written by hand for Hopper.
//
// Replaces hymet_tpu/ops/sketch.py::sketch_batch (:919), an XLA program
// (hash every window, a 2-key lax.sort, duplicate marks, a 3-key re-sort,
// slice s), and its TPU-shaped approximation sketch_batch_topk (:852) +
// finish_bottom_sketch (:873): for each segment (one row, or a run of
// consecutive rows) the s smallest *distinct* valid hashes in uint64
// order, PAD_HASH (all ones) padded, and their count n = min(#distinct, s).
// Hashes travel as int64 holding the uint64 bit pattern; inside, keys are
// hash ^ (1 << 63), whose signed order is the hashes' unsigned order.
//
// Three kernels, one stream, 2 + R launches a call:
//   bottom_tile_kernel   one block a tile of kTile windows of a row: loads
//                        the valid keys into shared memory (invalid and
//                        past-the-row slots as the PAD key), bitonic-sorts
//                        them, drops duplicates and writes its c0 =
//                        min(s, kTile) smallest distinct keys as a sorted
//                        candidate list with its count;
//   bottom_merge_kernel  round r of a pairwise merge of a segment's lists:
//                        the list of leaf slot p (p - first leaf of the
//                        segment a multiple of 2^r) merges slot p and
//                        p + 2^(r-1), drops keys the two share and keeps the
//                        first min(s, c0 * 2^r); a list lives at its first
//                        leaf's slot, in the room of the leaves it covers,
//                        which always holds it; lists ping-pong between
//                        two buffers;
//   bottom_emit_kernel   each segment's final list as hashes, PAD padded
//                        to s, and its count.
// A real hash equal to PAD_HASH is a value like any other: a tile counts
// it when one of its valid windows has it, and the lists carry counts, not
// sentinels.
//
// What bounds it on an H100: bytes. The function reads 9 bytes a window
// (hash and valid) and writes 8 * s + 4 a segment, and does little
// arithmetic a window. This first design sorts every tile whole (78
// compare-exchange stages over 4096 keys) and merges about log2(tiles)
// rounds of lists of up to s keys with binary searches, so it does far
// more work than the bound counts; a threshold pre-filter (windows above a
// segment's running s-th key cannot matter) and the hash fused into the
// tile load are the redesign's work (ROADMAP B).

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using namespace hymet;

constexpr int kTile = 4096;          // windows a tile block sorts (32 KiB of keys)
constexpr int kTileThreads = 512;
constexpr int kPerThread = kTile / kTileThreads;  // consecutive keys a thread compacts
constexpr int kMergeThreads = 256;
constexpr int kEmitThreads = 256;
constexpr long long kPadKey = 0x7FFFFFFFFFFFFFFFLL;  // PAD_HASH ^ (1 << 63)
constexpr unsigned long long kSign = 0x8000000000000000ULL;

// Number of keys of a[0, n) below x (a sorted ascending).
__device__ __forceinline__ int lower_bound(const long long* __restrict__ a, int n, long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// grid (tpr, B): tile blockIdx.x of row blockIdx.y -> leaf list
// row * tpr + tile at cand[leaf * c0], its count at cnt[leaf].
__global__ void __launch_bounds__(kTileThreads)
bottom_tile_kernel(const int64_t* __restrict__ hash, const bool* __restrict__ valid, long long n,
                   int tpr, int c0, long long* __restrict__ cand, int* __restrict__ cnt) {
  __shared__ long long keys[kTile];
  __shared__ int real_max;  // a valid window of the tile has the PAD key
  const int tid = threadIdx.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  if (tid == 0) real_max = 0;
  __syncthreads();
  bool saw_max = false;
  for (int i = tid; i < kTile; i += kTileThreads) {
    const long long w = t0 + i;
    long long key = kPadKey;
    if (w < n && valid[base + w]) {
      key = static_cast<long long>(static_cast<unsigned long long>(hash[base + w]) ^ kSign);
      saw_max |= key == kPadKey;
    }
    keys[i] = key;
  }
  if (saw_max) real_max = 1;
  __syncthreads();

  // bitonic sort, ascending
  for (int size = 2; size <= kTile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = tid; q < kTile / 2; q += kTileThreads) {
        const int lo = 2 * q - (q & (stride - 1));
        const int hi = lo + stride;
        const long long a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & size) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  // the first of each run of equal keys is a distinct key; PAD keys count
  // once, and only if a valid window had one
  const int first = tid * kPerThread;
  unsigned keep = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = first + j;
    const long long x = keys[i];
    const bool head = i == 0 || keys[i - 1] != x;
    keep |= static_cast<unsigned>(head && (x != kPadKey || real_max)) << j;
  }
  long long total;
  long long pos = block_exclusive_scan<kTileThreads>(__popc(keep), &total);
  const size_t leaf = static_cast<size_t>(blockIdx.y) * tpr + blockIdx.x;
  long long* out = cand + leaf * c0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if ((keep >> j) & 1u) {
      if (pos < c0) out[pos] = keys[first + j];
      ++pos;
    }
  }
  if (tid == 0) cnt[leaf] = static_cast<int>(total < c0 ? total : c0);
}

// Round `level` (>= 1) of the merge: one block a leaf slot p; it works only
// if p starts a list of this level in its segment (lstart[g] <= p <
// lstart[g + 1], segment g of row p / tpr).
__global__ void __launch_bounds__(kMergeThreads)
bottom_merge_kernel(const long long* __restrict__ in, const int* __restrict__ in_cnt,
                    long long* __restrict__ out, int* __restrict__ out_cnt,
                    int* __restrict__ drops, const int* __restrict__ row_group,
                    const int* __restrict__ lstart, int tpr, int c0, int level, int cap) {
  const long long p = blockIdx.x;
  const int g = row_group[p / tpr];
  const long long first = lstart[g], end = lstart[g + 1];
  const long long half = 1LL << (level - 1);
  if (((p - first) & (2 * half - 1)) != 0) return;
  const long long* A = in + static_cast<size_t>(p) * c0;
  long long* O = out + static_cast<size_t>(p) * c0;
  const int na = in_cnt[p];
  if (p + half >= end) {  // no partner: the list goes up as it is, cut to cap
    const int m = na < cap ? na : cap;
    for (int i = threadIdx.x; i < m; i += kMergeThreads) O[i] = A[i];
    if (threadIdx.x == 0) out_cnt[p] = m;
    return;
  }
  const long long* Bl = in + static_cast<size_t>(p + half) * c0;
  const int nb = in_cnt[p + half];
  // D[j]: the keys of Bl[0, j) that A also holds (each list is distinct,
  // so a key is at most in both); they are dropped
  int* D = drops + static_cast<size_t>(p) * c0;
  long long carry = 0;
  for (int j0 = 0; j0 < nb; j0 += kMergeThreads) {
    const int j = j0 + threadIdx.x;
    int dup = 0;
    if (j < nb) {
      const long long y = Bl[j];
      const int l = lower_bound(A, na, y);
      dup = l < na && A[l] == y;
    }
    long long chunk;
    const long long ex = block_exclusive_scan<kMergeThreads>(dup, &chunk);
    if (j < nb) D[j] = static_cast<int>(carry + ex);
    carry += chunk;
  }
  if (threadIdx.x == 0) D[nb] = static_cast<int>(carry);
  __syncthreads();
  // a key's place: the keys of A before it, plus those of Bl before it
  // that are kept
  for (int i = threadIdx.x; i < na; i += kMergeThreads) {
    const long long x = A[i];
    const int l = lower_bound(Bl, nb, x);
    const int pos = i + l - D[l];
    if (pos < cap) O[pos] = x;
  }
  for (int j = threadIdx.x; j < nb; j += kMergeThreads) {
    const long long y = Bl[j];
    const int l = lower_bound(A, na, y);
    if (l < na && A[l] == y) continue;
    const int pos = j + l - D[j];
    if (pos < cap) O[pos] = y;
  }
  if (threadIdx.x == 0) {
    const int total = na + nb - static_cast<int>(carry);
    out_cnt[p] = total < cap ? total : cap;
  }
}

// grid G: segment g's list (at its first leaf slot) -> out[g, :s] as
// hashes, PAD_HASH past its count, and out_n[g].
__global__ void __launch_bounds__(kEmitThreads)
bottom_emit_kernel(const long long* __restrict__ in, const int* __restrict__ in_cnt,
                   const int* __restrict__ lstart, int c0, int s, int64_t* __restrict__ out,
                   int* __restrict__ out_n) {
  const int g = blockIdx.x;
  const size_t p = lstart[g];
  const int n = in_cnt[p];
  const long long* A = in + p * c0;
  int64_t* o = out + static_cast<size_t>(g) * s;
  for (int i = threadIdx.x; i < s; i += kEmitThreads)
    o[i] = i < n ? static_cast<int64_t>(static_cast<unsigned long long>(A[i]) ^ kSign) : -1;
  if (threadIdx.x == 0) out_n[g] = n;
}

}  // namespace

// Launches on `stream`; returns the first cudaGetLastError() that is not
// 0 (0 = all launched). The caller checks the shapes and allocates:
// hash int64 and valid bool [B, n]; row_group int32 [B] (a row's segment,
// rows of a segment consecutive); lstart int32 [G + 1] (segment g's leaves
// are [lstart[g], lstart[g + 1]), lstart[g] = its first row * tpr); buf0,
// buf1 int64 and drops int32 [B * tpr * c0]; cnt0, cnt1 int32 [B * tpr];
// out int64 [G, s], out_n int32 [G]. tpr = ceil(n / 4096), c0 = min(s,
// 4096), rounds = ceil(log2(the most leaves a segment has)).
extern "C" int bottom_sketch_launch(const int64_t* hash, const bool* valid, int B, long long n,
                                    const int* row_group, const int* lstart, int G, int tpr,
                                    int c0, int s, int rounds, long long* buf0, long long* buf1,
                                    int* cnt0, int* cnt1, int* drops, int64_t* out, int* out_n,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bottom_tile_kernel<<<dim3(tpr, B), kTileThreads, 0, st>>>(hash, valid, n, tpr, c0, buf0, cnt0);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  long long *in = buf0, *nxt = buf1;
  int *in_cnt = cnt0, *nxt_cnt = cnt1;
  long long cap = c0;
  const unsigned leaves = static_cast<unsigned>(B) * static_cast<unsigned>(tpr);
  for (int level = 1; level <= rounds; ++level) {
    cap = cap * 2 < s ? cap * 2 : s;
    bottom_merge_kernel<<<leaves, kMergeThreads, 0, st>>>(in, in_cnt, nxt, nxt_cnt, drops,
                                                          row_group, lstart, tpr, c0, level,
                                                          static_cast<int>(cap));
    rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    long long* t = in;
    in = nxt, nxt = t;
    int* tc = in_cnt;
    in_cnt = nxt_cnt, nxt_cnt = tc;
  }
  bottom_emit_kernel<<<G, kEmitThreads, 0, st>>>(in, in_cnt, lstart, c0, s, out, out_n);
  return static_cast<int>(cudaGetLastError());
}
