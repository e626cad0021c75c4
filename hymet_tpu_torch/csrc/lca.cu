// Weighted rank-consensus LCA, written by hand for Hopper.
//
// Replaces hymet_tpu/ops/lca.py::weighted_lca (:40), an XLA program: per
// query and rank, from the top, the hits' names through the rank table,
// the weight per name (the [Q, H, H] equality einsum, :66-69), the first
// maximum (jnp.argmax, :71), the named total (jnp.sum, :64), conf *= best
// / total, and a stop at the first rank whose total is 0 (the rank
// lax.scan, :85). Input: hit rows int32 [Q, H] (-1 pads), weights float64
// [Q, H] (>= 0), the rank table int32 [T, 8] (0 = no name). Output: chosen
// int32 [Q, 8] (0 past the depth), n_chosen int32 [Q], confidence float64
// [Q] (min(conf, 1) where n_chosen > 0, else 0). One launch a call.
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
// What bounds it on an H100: the launch and the memory latency, not bytes
// or float64 adds. The function needs 12 bytes a valid hit, 4 a
// rank-table entry a rank reached and 44 a query written, and about two
// float64 adds a named hit a rank (chip_smoke.py::lca_bound_ms): for a gut
// classification well under a microsecond of either, far below one
// launch. A query's time is its chain of dependent steps: a hit's row,
// then its names; the sums; the fold of the ranks.
//
// Design: the ranks depend on each other only through the stop and the
// running product, so all eight are computed at once. One block a query,
// a warp a rank (4 at H > 128: the name sums grow as H^2; a template
// parameter, so the short lists' code has no merge).
//   - Each thread takes hits j = tid, tid + threads, ...: its weight into
//     shared memory, and its row, then its eight names (rows past the
//     table clamped to T - 1, as XLA's gather; a negative row names
//     nothing). One round of memory latency for all ranks, not eight.
//     Names lie hit-major, 8 a hit, so a warp's reads of hit j's name at
//     its rank are broadcasts. 40 bytes a hit: 80 KB at H = 2048, where
//     the launch raises the dynamic shared limit.
//   - A rank's lanes take hits i = lane, lane + 32, ... (over its warps)
//     and sum each named one's weight over all H hits (broadcast reads);
//     warp shuffles keep the first maximum (the larger sum, on a tie the
//     lower hit index, as jnp.argmax), and the rank's first warp merges
//     its other warps' through shared memory. That warp's lane b folds
//     block b of the named weights; shuffles bring each chunk's block
//     sums to every lane, in order. Lane 0 writes the rank's quotient
//     best / total, its name and whether total > 0.
//   - One __syncthreads; thread 0 walks the ranks in order to the first
//     without a positive total, multiplies the quotients before it, and
//     writes the names, the depth and the confidence.
// A rank past the query's stop is computed and not used. The O(H^2) name
// sums are this design's, not the function's; the main path's hit lists
// are short (H <= 32 on the gut sample).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRanks = 8;
constexpr int kWarp = 32;
constexpr int kBlockHits = 32;    // the named total's blocks
constexpr int kChunkBlocks = 32;  // 1024 hits a chunk
constexpr int kMaxHits = 2048;    // ops/lca.py LCA_MAX_BUCKET
constexpr int kDefaultShared = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(double v, int i, double bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// A rank's named total, in every lane of the warp: lane b folds blocks b
// and b + 32 of the named weights (H <= 2048: at most 64 blocks, two
// chunks), then every lane folds each chunk's block sums in order,
// shuffled from their lanes, and the chunk sums in order.
__device__ __forceinline__ double named_total(const int* names, const double* s_w, int H,
                                              int lane) {
  const int nblk = (H + kBlockHits - 1) / kBlockHits;
  double blk[2] = {0.0, 0.0};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int b = c * kChunkBlocks + lane;
    if (b < nblk) {
      const int end = min(H, (b + 1) * kBlockHits);
      double s = 0.0;
      for (int j = b * kBlockHits; j < end; ++j)
        s = __dadd_rn(s, names[j * kRanks] != 0 ? s_w[j] : 0.0);
      blk[c] = s;
    }
  }
  double total = 0.0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int nb = min(kChunkBlocks, nblk - c * kChunkBlocks);  // the same in every lane
    if (nb <= 0) break;
    double cs = 0.0;
    for (int k = 0; k < nb; ++k) cs = __dadd_rn(cs, __shfl_sync(kFull, blk[c], k));
    total = __dadd_rn(total, cs);
  }
  return total;
}

template <int kRankWarps>  // warps a rank: 1, or 4 at H > 128
__global__ void __launch_bounds__(kRanks * kRankWarps * kWarp)
    lca_kernel(const int* __restrict__ rows, const double* __restrict__ w,
               const int* __restrict__ table, int H, int T, int* __restrict__ chosen,
               int* __restrict__ n_chosen, double* __restrict__ confidence) {
  extern __shared__ double smem[];
  double* s_w = smem;                                // [H]
  int* s_name = reinterpret_cast<int*>(s_w + H);     // [H][8], hit-major
  __shared__ double s_quot[kRanks];
  __shared__ int s_best[kRanks];
  __shared__ bool s_has[kRanks];
  __shared__ double s_cand_v[kRanks * kRankWarps];  // each warp's first maximum
  __shared__ int s_cand_i[kRanks * kRankWarps];

  constexpr int kThreads = kRanks * kRankWarps * kWarp;
  const int tid = threadIdx.x;
  const long long q = blockIdx.x;
  for (int j = tid; j < H; j += kThreads) {
    s_w[j] = w[q * H + j];
    const int row = rows[q * H + j];
    int* dst = s_name + j * kRanks;
    if (row >= 0) {
      const int* src = table + static_cast<long long>(row < T ? row : T - 1) * kRanks;
#pragma unroll
      for (int r = 0; r < kRanks; ++r) dst[r] = __ldg(src + r);
    } else {
#pragma unroll
      for (int r = 0; r < kRanks; ++r) dst[r] = 0;
    }
  }
  __syncthreads();

  const int warp = tid / kWarp, lane = tid % kWarp;
  const int rank = warp / kRankWarps, sub = warp % kRankWarps;
  const int* names = s_name + rank;  // names[j * kRanks]: hit j's name at this rank
  double bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = sub * kWarp + lane; i < H; i += kRankWarps * kWarp) {
    const int ni = names[i * kRanks];
    if (ni == 0) continue;
    double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
    for (int j = 0; j < H; j += 4) {
      if (names[j * kRanks] == ni) a0 = __dadd_rn(a0, s_w[j]);
      if (j + 1 < H && names[(j + 1) * kRanks] == ni) a1 = __dadd_rn(a1, s_w[j + 1]);
      if (j + 2 < H && names[(j + 2) * kRanks] == ni) a2 = __dadd_rn(a2, s_w[j + 2]);
      if (j + 3 < H && names[(j + 3) * kRanks] == ni) a3 = __dadd_rn(a3, s_w[j + 3]);
    }
    const double v = __dadd_rn(__dadd_rn(a0, a2), __dadd_rn(a1, a3));
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const double ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }

  if (kRankWarps > 1) {
    if (lane == 0) {
      s_cand_v[warp] = bv;
      s_cand_i[warp] = bi;
    }
    __syncthreads();
    for (int k = 1; sub == 0 && k < kRankWarps; ++k) {
      const double ov = s_cand_v[warp + k];
      const int oi = s_cand_i[warp + k];
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
  }
  if (sub == 0) {  // the rank's first warp: its total, quotient and name
    const double total = named_total(names, s_w, H, lane);
    if (lane == 0) {
      const bool has = total > 0.0;
      s_has[rank] = has;
      s_quot[rank] = has ? __ddiv_rn(bv, total) : 1.0;
      s_best[rank] = has ? names[bi * kRanks] : 0;
    }
  }
  __syncthreads();

  if (tid == 0) {
    double conf = 1.0;
    int depth = 0;
    while (depth < kRanks && s_has[depth]) {
      conf = __dmul_rn(conf, s_quot[depth]);
      ++depth;
    }
    for (int r = 0; r < kRanks; ++r) chosen[q * kRanks + r] = r < depth ? s_best[r] : 0;
    n_chosen[q] = depth;
    confidence[q] = depth > 0 ? (conf > 1.0 ? 1.0 : conf) : 0.0;
  }
}

template <int kRankWarps>
int launch(const int* rows, const double* w, const int* table, int Q, int H, int T, int* chosen,
           int* n_chosen, double* confidence, cudaStream_t stream) {
  const size_t shared = (sizeof(double) + kRanks * sizeof(int)) * H;
  if (shared > kDefaultShared) {
    const cudaError_t e = cudaFuncSetAttribute(lca_kernel<kRankWarps>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(shared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lca_kernel<kRankWarps><<<Q, kRanks * kRankWarps * kWarp, shared, stream>>>(
      rows, w, table, H, T, chosen, n_chosen, confidence);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lca_launch(const int* rows, const double* w, const int* table, int Q, int H, int T,
                          int* chosen, int* n_chosen, double* confidence, void* stream) {
  if (Q < 1 || H < 1 || H > kMaxHits || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H > 128) return launch<4>(rows, w, table, Q, H, T, chosen, n_chosen, confidence, s);
  return launch<1>(rows, w, table, Q, H, T, chosen, n_chosen, confidence, s);
}
