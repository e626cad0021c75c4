// Bottom-s distinct sketch of rows (or groups of rows) of k-mer windows,
// written by hand for Hopper, with two front ends on one back end:
//   sketch_codes   codes uint8 [B, L] in (0-3 = ACGT, >= 4 invalid): each
//                  window's canonical k-mer MurmurHash3 (kmer_core.cuh) is
//                  made in registers and never written to device memory;
//   bottom_sketch  hashes int64 and valid bool [B, n] in (the DB build folds
//                  the pieces of a genome past its window budget with it).
//
// Replaces hymet_tpu/ops/sketch.py::sketch_batch (:919), an XLA program
// (hash every window, a 2-key lax.sort, duplicate marks, a 3-key re-sort,
// slice s), and its TPU-shaped approximation sketch_batch_topk (:852) +
// finish_bottom_sketch (:873); sketch_codes fuses in the hash of
// hymet_tpu/ops/pallas_kernels.py::_hash_tile_kernel. For each segment (one
// row, or a run of consecutive rows) the s smallest *distinct* valid hashes
// in uint64 order, PAD_HASH (all ones) padded, and their count n =
// min(#distinct, s). Hashes travel as int64 holding the uint64 bit pattern;
// inside, keys are hash ^ (1 << 63), whose signed order is the hashes'
// unsigned order. A real hash equal to PAD_HASH is a value like any other:
// the lists carry counts, not sentinels.
//
// Two kernels, one stream, one call:
//   chunk_kernel  one block a chunk of a row (kChunkWaves waves of kWave
//                 windows). A wave's keys come 16 to a thread; those at or
//                 below tau survive and are appended (block scan) to a
//                 buffer of kWave keys. When the next wave's survivors
//                 would not fit, and at the chunk's end, the buffer is
//                 sorted (bitonic, over the next power of two above its
//                 count) and folded into the block's sorted list of at most
//                 s distinct keys. tau is the list's s-th key once it holds
//                 s (+inf before), or the segment's shared bound where that
//                 is lower: any chunk's s-th distinct key bounds its
//                 segment's, so each block publishes its own with atomicMin
//                 after a fold and reads the others' every wave. Ties on
//                 tau are kept. The list ends in the chunk's slot with its
//                 count.
//   merge_kernel  one block a segment folds its chunks' lists into one the
//                 same way (they are sorted and distinct: no sort; a list is
//                 read only up to tau) and writes it as hashes, PAD padded,
//                 with its count.
// A list of up to kSharedCap keys lives in shared memory (two buffers, it
// is merged from one into the other); a longer one (s above it: the list
// room is min(s, the windows it can see)) in device memory, in the chunk's
// slot or the output row and a scratch row.
//
// What bounds it on an H100. sketch_codes: about 110 32-bit integer
// instructions a window at k = 21 (chip_smoke.py::window_ops) against 1 byte
// read, so the integer pipes; bottom_sketch: 9 bytes a window read (hash and
// valid), so memory. Both write 8 s + 4 bytes a segment. The threshold cuts
// the selection's work: blocks start row by row, so a row's later chunks
// find the bound of its first ones, keep about 1,000 of their 65,536
// windows and fold once. Folding a full buffer and not each wave spends a
// sort's barriers on thousands of keys, not on a wave's few (a fold at
// every 512 to 2048 survivors measured the same). A row's ~12 chunk lists
// are folded by one block, most of their keys cut by tau.
//
// Measured (tools/sketch_trace.py; H100 80GB HBM3, 700 W): a row's first
// three or four chunks start together with no bound and fold about 13,000
// survivors each in four folds; the folds' bitonic sorts of up to 4096
// keys, bound by the shared memory's bandwidth (each key read and written
// 78 times), are 80 % of their fold cycles and most of these blocks' time.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_core.cuh"
#include "scan.cuh"

namespace {

using namespace hymet;

constexpr int kT = 256;                  // threads a block
constexpr int kPer = kRun;               // keys a thread holds in a wave
constexpr int kWave = kT * kPer;         // windows a block takes at a time
constexpr int kChunkWaves = 16;          // waves a chunk block owns
constexpr long long kChunk = static_cast<long long>(kWave) * kChunkWaves;
constexpr int kSharedCap = 4096;         // the longest list kept in shared memory
constexpr int kWaveSlabWords = kWave / 16 + 4;  // a wave's bases and a halo of 64
constexpr long long kPadKey = 0x7FFFFFFFFFFFFFFFLL;  // PAD_HASH ^ (1 << 63): +inf
constexpr unsigned long long kSign = 0x8000000000000000ULL;

// Dynamic shared memory of a block whose lists hold `cap` keys: the
// candidate buffer, and the two lists when they fit.
size_t smem_bytes(int cap) {
  return sizeof(long long) * (kWave + (cap <= kSharedCap ? 2 * static_cast<size_t>(cap) : 0));
}

// Number of keys of a[0, n) below x (a sorted ascending).
__device__ __forceinline__ int lower_bound(const long long* a, int n, long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// A block's selection; every thread holds the same copy.
struct Sel {
  long long* cand;  // [kWave] survivors of a wave, in shared memory
  long long* cur;   // the list: the m smallest distinct keys seen, ascending
  long long* nxt;   // room for the next list
  int m;
  int cap;          // room of a list: min(s, keys the block can see)
  int s;
  long long tau;    // cur[s - 1] once m == s, else kPadKey
};

// Lists of `cap` keys in shared memory when they fit, else at a and b.
__device__ __forceinline__ Sel make_sel(long long* smem, int cap, int s, long long* a,
                                        long long* b) {
  Sel S;
  S.cand = smem;
  if (cap <= kSharedCap) {
    S.cur = smem + kWave;
    S.nxt = S.cur + cap;
  } else {
    S.cur = a;
    S.nxt = b;
  }
  S.m = 0;
  S.cap = cap;
  S.s = s;
  S.tau = kPadKey;
  return S;
}

// Ascending bitonic sort of a[0, P), P a power of two; ends in a barrier
// when P > 1.
__device__ __forceinline__ void bitonic_sort(long long* a, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = threadIdx.x; q < P / 2; q += kT) {
        const int lo = 2 * q - (q & (stride - 1));
        const int hi = lo + stride;
        const long long x = a[lo], y = a[hi];
        if ((x > y) == ((lo & size) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Fold the keys C[0, c) into the list, sorting them first unless sorted
// (ascending and distinct): the list becomes the first `cap` distinct keys
// of both, and tau their s-th once there are s. C is written and a barrier
// passed; every thread of the block calls it.
__device__ __forceinline__ void fold(Sel& S, int c, bool sorted) {
  const int tid = threadIdx.x;
  long long* C = S.cand;
  if (!sorted) {  // pad to a power of two with +inf: the first c sort as the keys
    int P = 1;
    while (P < c) P <<= 1;
    for (int i = c + tid; i < P; i += kT) C[i] = kPadKey;
    __syncthreads();
    bitonic_sort(C, P);
  }

  // the first of each run of equal keys, if the list lacks it. Element i =
  // kT * j + tid, so that a few survivors still spread over all threads;
  // its rank among the kept ones comes from its warp's ballot and a scan of
  // the ballots' counts, in element order.
  __shared__ int tally[kPer * (kT / 32)];
  const int n = c, rounds = (n + kT - 1) / kT;
  const int lane = tid & 31, warp = tid >> 5;
  long long y[kPer];
  int below[kPer];  // the list's keys below y[j]
  uint32_t ballot[kPer];
  uint32_t keep = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (j < rounds) {
      const int i = kT * j + tid;
      bool kept = false;
      if (i < n) {
        y[j] = C[i];
        const int l = lower_bound(S.cur, S.m, y[j]);
        below[j] = l;
        kept = (i == 0 || C[i - 1] != y[j]) && !(l < S.m && S.cur[l] == y[j]);
      }
      ballot[j] = __ballot_sync(0xFFFFFFFFu, kept);
      if (lane == 0) tally[j * (kT / 32) + warp] = __popc(ballot[j]);
      keep |= static_cast<uint32_t>(kept) << j;
    }
  }
  __syncthreads();
  const int slots = rounds * (kT / 32);
  long long u;
  const long long ahead = block_exclusive_scan<kT>(tid < slots ? tally[tid] : 0, &u);
  if (u == 0) return;
  if (tid < slots) tally[tid] = static_cast<int>(ahead);
  __syncthreads();
  // the new keys, compacted in place (every read of C above came before
  // the barriers), each at its place in the next list
  const uint32_t lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if ((keep >> j) & 1u) {
      const int q = tally[j * (kT / 32) + warp] + __popc(ballot[j] & lower);
      C[q] = y[j];
      if (q + below[j] < S.cap) S.nxt[q + below[j]] = y[j];
    }
  }
  __syncthreads();
  // the list's keys, each moved up by the new keys below it
  for (int i = tid; i < S.m; i += kT) {
    const long long x = S.cur[i];
    const long long p = i + lower_bound(C, static_cast<int>(u), x);
    if (p < S.cap) S.nxt[p] = x;
  }
  __syncthreads();
  long long* t = S.cur;
  S.cur = S.nxt;
  S.nxt = t;
  S.m = static_cast<int>(S.m + u < S.cap ? S.m + u : S.cap);
  S.tau = S.m == S.s ? S.cur[S.s - 1] : kPadKey;
}

// Fold this thread's keys key[j] with bit j of `take` set (in thread order
// ascending and distinct: a list read in order) into the list.
__device__ __forceinline__ void absorb_sorted(Sel& S, const long long (&key)[kPer], uint32_t take) {
  long long c;
  long long at = block_exclusive_scan<kT>(__popc(take), &c);
  if (c == 0) return;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if ((take >> j) & 1u) S.cand[at++] = key[j];
  __syncthreads();
  fold(S, static_cast<int>(c), true);
}

// What a chunk block reads: codes (k >= 1) or hashes and valid flags.
struct Input {
  const uint8_t* codes;  // [B, L]
  const int64_t* hash;   // [B, n]
  const bool* valid;     // [B, n]
  const int* row_group;  // a row's segment; nullptr: each row its own
  long long L;           // codes a row
  long long n;           // windows a row
  int k;
  bool vec;              // code rows may be read 16 bytes at a time
};

// grid (B, chunks a row): chunk blockIdx.y of row blockIdx.x -> its list
// at lists[slot * cap], its count at counts[slot], slot = row * gridDim.y +
// chunk. Blocks start in the order of blockIdx.x first, so a row's later
// chunks start after its first ones have published a bound. NW = ceil(k /
// 8) for codes in, 0 for hashes in. seg_tau[g]: the least s-th key any
// chunk of segment g has found (kPadKey at the start).
template <int NW>
__global__ void __launch_bounds__(kT, 2)
chunk_kernel(Input in, int s, int cap, long long* __restrict__ lists, int* __restrict__ counts,
             long long* seg_tau, long long* __restrict__ work) {
  extern __shared__ long long smem[];
  __shared__ uint32_t code_slab[kWaveSlabWords];
  __shared__ uint16_t mask16[kWaveSlabWords];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const size_t slot = static_cast<size_t>(row) * gridDim.y + blockIdx.y;
  long long* out = lists + slot * cap;
  Sel S = make_sel(smem, cap, s, out, cap > kSharedCap ? work + slot * cap : nullptr);
  const int g = in.row_group ? in.row_group[row] : row;
  const volatile long long* bound = seg_tau + g;
  const long long first = static_cast<long long>(blockIdx.y) * kChunk;
  const long long end = in.n < first + kChunk ? in.n : first + kChunk;

  int waiting = 0;  // survivors in cand, not yet folded
  for (long long w0 = first; w0 < end; w0 += kWave) {
    long long key[kPer];
    uint32_t live = 0;
    if constexpr (NW == 0) {
      // windows w0 + tid + kT * j: each load coalesced across the block
      const size_t base = static_cast<size_t>(row) * in.n;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {  // no load waits on another
        const long long w = w0 + tid + kT * j;
        const bool in_row = w < end;
        const unsigned long long h = in_row ? in.hash[base + w] : 0;
        live |= static_cast<uint32_t>(in_row && in.valid[base + w]) << j;
        key[j] = static_cast<long long>(h ^ kSign);
      }
    } else {
      // windows w0 + kPer * tid + j, a run of kmer_core.cuh; the slab's
      // previous reads all came before the last wave's scan barriers
      load_code_slab(in.codes + static_cast<size_t>(row) * in.L, in.L, w0, kWaveSlabWords, in.vec,
                     code_slab, mask16);
      __syncthreads();
      live = run_mask(end - (w0 + kPer * tid)) & window_valid(run_valid_bits(mask16, tid), in.k);
#pragma unroll
      for (int j = 0; j < kPer; ++j) key[j] = kPadKey;
      if (live) {
        uint32_t code[4];
        run_codes(code_slab, tid, code);
        hash_run<NW>(code, in.k, [&](int j, uint64_t h) {
          key[j] = static_cast<long long>(h ^ kSign);
        });
      }
    }
    const long long seen = *bound;
    const long long tau = S.tau < seen ? S.tau : seen;
    uint32_t take = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) take |= static_cast<uint32_t>(key[j] <= tau) << j;
    take &= live;
    // the survivors wait in cand; what waits is folded when they would
    // not fit beside it
    long long c_new;
    long long at = block_exclusive_scan<kT>(__popc(take), &c_new);
    if (waiting + c_new > kWave) {
      fold(S, waiting, false);
      waiting = 0;
      if (tid == 0 && S.m == s && S.tau < seen) atomicMin(seg_tau + g, S.tau);
    }
    at += waiting;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if ((take >> j) & 1u) S.cand[at++] = key[j];
    waiting += static_cast<int>(c_new);
  }
  __syncthreads();
  if (waiting) {
    fold(S, waiting, false);
    if (tid == 0 && S.m == s && S.tau < *bound) atomicMin(seg_tau + g, S.tau);
  }
  if (S.cur != out)
    for (int i = tid; i < S.m; i += kT) out[i] = S.cur[i];
  if (tid == 0) counts[slot] = S.m;
}

// grid G: segment g's chunk lists (chunks [first_row[g] * cpr, first_row[g
// + 1] * cpr), or [g * cpr, (g + 1) * cpr) without first_row) folded into
// one list of at most `cap` keys -> out[g, :s] as hashes, PAD_HASH (-1)
// past its count, and out_n[g].
__global__ void __launch_bounds__(kT)
merge_kernel(const long long* __restrict__ lists, const int* __restrict__ counts,
             const int* __restrict__ first_row, int cpr, int cap0, int s, int cap,
             long long* __restrict__ work, int64_t* __restrict__ out, int* __restrict__ out_n) {
  extern __shared__ long long smem[];
  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  long long* o = reinterpret_cast<long long*>(out) + static_cast<size_t>(g) * s;
  Sel S = make_sel(smem, cap, s, o, cap > kSharedCap ? work + static_cast<size_t>(g) * cap : nullptr);
  const long long c_first = static_cast<long long>(first_row ? first_row[g] : g) * cpr;
  const long long c_end = static_cast<long long>(first_row ? first_row[g + 1] : g + 1) * cpr;
  for (long long c = c_first; c < c_end; ++c) {
    const long long* A = lists + c * cap0;
    const int na = counts[c];
    // the list is ascending: past a key above tau nothing can enter
    for (int off = 0; off < na && A[off] <= S.tau; off += kWave) {
      long long key[kPer];
      uint32_t take = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = off + kPer * tid + j;
        key[j] = i < na ? A[i] : kPadKey;
        take |= static_cast<uint32_t>(i < na && key[j] <= S.tau) << j;
      }
      absorb_sorted(S, key, take);
    }
  }
  // in place when the list lives in the output row: each thread reads and
  // writes its own slots
  for (int i = tid; i < s; i += kT)
    o[i] = i < S.m ? static_cast<long long>(static_cast<unsigned long long>(S.cur[i]) ^ kSign) : -1;
  if (tid == 0) out_n[g] = S.m;
}

template <int NW>
cudaError_t start_chunks(const Input& in, dim3 grid, int s, int cap, long long* lists,
                         int* counts, long long* seg_tau, long long* work, cudaStream_t st) {
  const size_t shm = smem_bytes(cap);
  const cudaError_t rc = cudaFuncSetAttribute(
      chunk_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shm));
  if (rc != cudaSuccess) return rc;
  chunk_kernel<NW><<<grid, kT, shm, st>>>(in, s, cap, lists, counts, seg_tau, work);
  return cudaGetLastError();
}

int sketch_launch(const Input& in, int B, int G, const int* first_row, int s, int cpr, int cap0,
                  int cap, long long* lists, int* counts, long long* seg_tau, long long* work,
                  int64_t* out, int* out_n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(cpr));
  cudaError_t rc;
  switch (in.k ? (in.k + 7) / 8 : 0) {
    case 0: rc = start_chunks<0>(in, grid, s, cap0, lists, counts, seg_tau, work, st); break;
    case 1: rc = start_chunks<1>(in, grid, s, cap0, lists, counts, seg_tau, work, st); break;
    case 2: rc = start_chunks<2>(in, grid, s, cap0, lists, counts, seg_tau, work, st); break;
    case 3: rc = start_chunks<3>(in, grid, s, cap0, lists, counts, seg_tau, work, st); break;
    default: rc = start_chunks<4>(in, grid, s, cap0, lists, counts, seg_tau, work, st); break;
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const size_t shm = smem_bytes(cap);
  rc = cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(shm));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  merge_kernel<<<G, kT, shm, st>>>(lists, counts, first_row, cpr, cap0, s, cap, work, out, out_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` and return the first CUDA error (0 = all
// launched). The caller checks the shapes and allocates: cpr = ceil(n /
// 65536) <= 65535 chunks a row; lists int64 [B * cpr * cap0] and counts int32 [B *
// cpr], cap0 = min(s, 65536); seg_tau int64 [G] filled with 2^63 - 1; out
// int64 [G, s], out_n int32 [G]; cap = min(s, the most windows a segment
// has); work int64 [B * cpr * cap0] where cap0 > 4096 and [G * cap] where
// cap > 4096 (the larger of the two), else unused.

// codes uint8 [B, L] (L >= k, 1 <= k <= 32), one segment a row (G = B);
// vec: rows may be read 16 bytes at a time (L % 16 == 0, aligned base).
extern "C" int sketch_codes_launch(const uint8_t* codes, int B, int L, int k, int vec, int s,
                                   int cpr, int cap0, int cap, long long* lists, int* counts,
                                   long long* seg_tau, long long* work, int64_t* out, int* out_n,
                                   void* stream) {
  const Input in{codes, nullptr, nullptr, nullptr, L, static_cast<long long>(L) - k + 1, k,
                 vec != 0};
  return sketch_launch(in, B, B, nullptr, s, cpr, cap0, cap, lists, counts, seg_tau, work, out,
                       out_n, stream);
}

// hash int64 and valid bool [B, n] (n >= 1); row_group int32 [B] (a row's
// segment, rows of a segment consecutive); first_row int32 [G + 1].
extern "C" int bottom_sketch_launch(const int64_t* hash, const bool* valid, int B, long long n,
                                    const int* row_group, const int* first_row, int G, int s,
                                    int cpr, int cap0, int cap, long long* lists, int* counts,
                                    long long* seg_tau, long long* work, int64_t* out,
                                    int* out_n, void* stream) {
  const Input in{nullptr, hash, valid, row_group, 0, n, 0, false};
  return sketch_launch(in, B, G, first_row, s, cpr, cap0, cap, lists, counts, seg_tau, work, out,
                       out_n, stream);
}
