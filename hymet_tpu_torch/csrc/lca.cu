// Weighted rank-consensus LCA, written by hand for Hopper.
//
// Replaces hymet_tpu/ops/lca.py::weighted_lca (:40), an XLA program: per
// query and rank, from the top, the hits' names through the rank table,
// the weight per name (the [Q, H, H] equality einsum, :66-69), the first
// maximum (jnp.argmax), the named total (jnp.sum, :64), conf *= best /
// total, and a stop at the first rank whose total is 0. Input: hit rows
// int32 [Q, H] (-1 pads), weights float64 [Q, H] (>= 0), the rank table
// int32 [T, 8] (0 = no name). Output: chosen int32 [Q, 8] (0 past the
// depth), n_chosen int32 [Q], confidence float64 [Q] (min(conf, 1) where
// n_chosen > 0, else 0). All 8 ranks in one launch.
//
// The sums are added in exactly the orders XLA-CPU uses with x64 on
// (ROADMAP C2), so the port's confidences equal the JAX package's bit for
// bit:
//   - weight of hit i's name: four accumulators, hit j (increasing j) into
//     accumulator j % 4 where names[j] == names[i] != 0, then
//     (a0 + a2) + (a1 + a3);
//   - named total: each block of 32 hits folded in order, the block sums
//     of each chunk of 1024 hits folded in order, the chunk sums folded in
//     order.
// A term the einsum multiplies by 0 (another name) is +0.0 and is skipped:
// adding +0.0 to a non-negative sum changes no bit. Every add, product and
// quotient is written with __dadd_rn, __dmul_rn and __ddiv_rn, so nvcc
// contracts nothing into an FMA.
//
// Design (simple; the main path's hit lists are short, H <= 128): one
// block a query, a power of two of 32 to 256 threads. The query's rows and
// weights, and each rank's names, sit in shared memory (16 B a hit: 32 KB
// at H = 2048). A thread takes hits i = tid, tid + threads, ... and sums
// each named one's weight over all H hits (broadcast reads of shared
// memory); a tree in shared memory keeps the first maximum (the larger
// sum, on a tie the lower hit index). Thread b < ceil(H / 32) folds block
// b of the named weights; thread 0 folds the block and chunk sums and
// updates the confidence.
//
// What bounds it on an H100: the launch. The function needs 12 bytes a
// valid hit, 4 a rank-table entry a rank reached and 44 a query written,
// and about two float64 adds a named hit a rank
// (chip_smoke.py::lca_bound_ms): for a gut classification, well under a
// microsecond of either, far below one launch. The O(H^2) name sums are
// this design's, not the function's; a query's distinct names could each
// be summed once, in the same order, if long hit lists ever mattered.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRanks = 8;
constexpr int kBlockHits = 32;  // the named total's blocks
constexpr int kChunkBlocks = 32;  // 1024 hits a chunk
constexpr int kMaxHits = 2048;  // ops/lca.py LCA_MAX_BUCKET
constexpr int kMaxThreads = 256;

__device__ __forceinline__ bool better(double v, int i, double bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kMaxThreads)
    lca_kernel(const int* __restrict__ rows, const double* __restrict__ w,
               const int* __restrict__ table, int H, int T, int* __restrict__ chosen,
               int* __restrict__ n_chosen, double* __restrict__ confidence) {
  extern __shared__ double smem[];
  double* s_w = smem;                             // [H]
  double* s_blk = s_w + H;                        // [ceil(H / 32)]
  double* s_val = s_blk + kMaxHits / kBlockHits;  // [threads]
  int* s_idx = reinterpret_cast<int*>(s_val + blockDim.x);  // [threads]
  int* s_row = s_idx + blockDim.x;                // [H]
  int* s_name = s_row + H;                        // [H]
  __shared__ int s_stop;

  const int tid = threadIdx.x, nt = blockDim.x;
  const long long q = blockIdx.x;
  for (int j = tid; j < H; j += nt) {
    int row = rows[q * H + j];
    s_row[j] = row < T ? row : T - 1;  // out of range: clamped, as XLA's gather
    s_w[j] = w[q * H + j];
  }
  const int nblk = (H + kBlockHits - 1) / kBlockHits;
  double conf = 1.0;  // thread 0's
  int depth = 0;      // thread 0's
  for (int r = 0; r < kRanks; ++r) {
    for (int j = tid; j < H; j += nt) {
      int row = s_row[j];
      s_name[j] = row >= 0 ? table[static_cast<long long>(row) * kRanks + r] : 0;
    }
    __syncthreads();
    for (int b = tid; b < nblk; b += nt) {
      const int end = min(H, (b + 1) * kBlockHits);
      double s = 0.0;
      for (int j = b * kBlockHits; j < end; ++j) s = __dadd_rn(s, s_name[j] != 0 ? s_w[j] : 0.0);
      s_blk[b] = s;
    }
    double bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = tid; i < H; i += nt) {
      const int ni = s_name[i];
      double v = -INFINITY;
      if (ni != 0) {
        double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
        for (int j = 0; j < H; j += 4) {
          if (s_name[j] == ni) a0 = __dadd_rn(a0, s_w[j]);
          if (j + 1 < H && s_name[j + 1] == ni) a1 = __dadd_rn(a1, s_w[j + 1]);
          if (j + 2 < H && s_name[j + 2] == ni) a2 = __dadd_rn(a2, s_w[j + 2]);
          if (j + 3 < H && s_name[j + 3] == ni) a3 = __dadd_rn(a3, s_w[j + 3]);
        }
        v = __dadd_rn(__dadd_rn(a0, a2), __dadd_rn(a1, a3));
      }
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    s_val[tid] = bv;
    s_idx[tid] = bi;
    __syncthreads();
    for (int half = nt / 2; half > 0; half /= 2) {
      if (tid < half && better(s_val[tid + half], s_idx[tid + half], s_val[tid], s_idx[tid])) {
        s_val[tid] = s_val[tid + half];
        s_idx[tid] = s_idx[tid + half];
      }
      __syncthreads();
    }
    if (tid == 0) {
      double total = 0.0;
      for (int c = 0; c < nblk; c += kChunkBlocks) {
        const int end = min(nblk, c + kChunkBlocks);
        double cs = 0.0;
        for (int b = c; b < end; ++b) cs = __dadd_rn(cs, s_blk[b]);
        total = __dadd_rn(total, cs);
      }
      s_stop = !(total > 0.0);
      if (!s_stop) {
        conf = __dmul_rn(conf, __ddiv_rn(s_val[0], total));
        chosen[q * kRanks + r] = s_name[s_idx[0]];
        ++depth;
      }
    }
    __syncthreads();
    if (s_stop) break;
  }
  if (tid == 0) {
    for (int r = depth; r < kRanks; ++r) chosen[q * kRanks + r] = 0;
    n_chosen[q] = depth;
    confidence[q] = depth > 0 ? (conf > 1.0 ? 1.0 : conf) : 0.0;
  }
}

}  // namespace

extern "C" int lca_launch(const int* rows, const double* w, const int* table, int Q, int H, int T,
                          int* chosen, int* n_chosen, double* confidence, void* stream) {
  if (Q < 1 || H < 1 || H > kMaxHits || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  int threads = 32;
  while (threads < H && threads < kMaxThreads) threads *= 2;
  const size_t shared = sizeof(double) * (H + kMaxHits / kBlockHits + threads) +
                        sizeof(int) * (threads + 2 * H);
  lca_kernel<<<Q, threads, shared, static_cast<cudaStream_t>(stream)>>>(rows, w, table, H, T,
                                                                         chosen, n_chosen,
                                                                         confidence);
  return static_cast<int>(cudaGetLastError());
}
