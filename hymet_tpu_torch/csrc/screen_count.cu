// The sketch screen's count of one staged batch in one kernel, written by
// hand for Hopper: 2-bit unpack -> canonical k-mer MurmurHash3 -> survivor
// filter -> lookup in the DB's flat keys -> count.
//
// Replaces, on the screen's main path, hymet_tpu/ops/pallas_kernels.py::
// _hash_tile_kernel together with the program around it,
// hymet_tpu/ops/sketch.py::_screen_update_fused_packed_impl (the unpack of
// ops/hashing.py::unpack_code_batch_jax and the count of
// ops/sketch.py::_count_prefilter). Input: a batch as StagedContigs holds it,
// packed [B, W] uint8 (four 2-bit codes a byte, position 4b+i at bits 2i)
// and mask [B, M] uint8 (one validity bit a position, little-endian),
// W = 2M, rows of L positions. For every window w < L - k + 1 whose k mask
// bits are all set:
//   total += 1;
//   q = murmur(canonical k-mer) ^ (1 << 63)   (unsigned order as signed);
//   if q <= t (the DB's largest key): binary search of q in the sorted keys
//   flat[F]; on an exact hit counts[pos] += 1.
// Both outputs are integers added atomically, so the result does not
// depend on the order of the atomics.
//
// What bounds it on an H100: about 110 32-bit integer instructions per valid
// window at k = 21 (76 ALU, 34 multiply-add; chip_smoke.py::window_ops)
// against 0.375 bytes of input a position, so the integer pipes set its
// least time. The design spends instructions only where the function
// needs them: a block whose mask bits are all zero (row padding, 80 % of
// the staged screen's positions) leaves after reading its mask slab; a thread whose run holds no valid window does no hashing (one
// that holds any hashes the whole run, without a branch per window, and
// keeps the valid ones); the block's packed and mask slabs are read once,
// 16 bytes a thread, into shared memory as 32-bit words; the valid total
// is a warp reduction and one 64-bit atomic a block. Survivors (about 2e-4
// to 2e-3 of the windows) go to a queue in shared memory once the run is
// hashed, and the block's threads search them side by side (about 27
// dependent loads each at F = 1e8): searched where they were found, each
// one stalled its warp's remaining windows behind a chain of loads.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_core.cuh"

namespace {

using namespace hymet;

constexpr int kCodeBytes = (4 * kSlabWords + 15) / 16 * 16;
constexpr int kMaskBytes = (2 * kSlabWords + 15) / 16 * 16;

// dst[i] = row[start + i] where start + i < avail, else 0, for i < nbytes
// (a multiple of 16). vec: row may be read 16 bytes at a time.
__device__ __forceinline__ void load_slab(uint32_t* dst, const uint8_t* __restrict__ row,
                                          long long start, long long avail, int nbytes,
                                          bool vec) {
  for (int i = threadIdx.x; i < nbytes / 16; i += blockDim.x) {
    const long long p = start + 16LL * i;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (vec && p + 16 <= avail) {
      u = __ldg(reinterpret_cast<const uint4*>(row + p));
    } else if (p < avail) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      for (int q = 0; q < 16 && p + q < avail; ++q) w[q >> 2] |= static_cast<uint32_t>(row[p + q]) << (8 * (q & 3));
      u = make_uint4(w[0], w[1], w[2], w[3]);
    }
    reinterpret_cast<uint4*>(dst)[i] = u;
  }
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
screen_count_kernel(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ mask,
                    int W, int M, int L, int k, const int64_t* __restrict__ flat, int F,
                    long long t, int* __restrict__ counts,
                    unsigned long long* __restrict__ total, bool vec) {
  __shared__ __align__(16) uint32_t code_slab[kCodeBytes / 4];
  __shared__ __align__(16) uint32_t mask_slab[kMaskBytes / 4];
  __shared__ unsigned int warp_total[kThreads / 32];
  __shared__ long long queue[kBlockWindows];  // the block's survivors
  __shared__ int n_queued;
  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const long long b0 = static_cast<long long>(blockIdx.x) * kBlockWindows;
  const uint16_t* mask16 = reinterpret_cast<const uint16_t*>(mask_slab);

  if (tid == 0) n_queued = 0;
  load_slab(mask_slab, mask + static_cast<size_t>(row) * M, b0 / 8, M, kMaskBytes, vec);
  __syncthreads();
  const uint64_t m = run_valid_bits(mask16, tid);
  if (!__syncthreads_or(m != 0)) return;  // all padding: no valid window
  load_slab(code_slab, packed + static_cast<size_t>(row) * W, b0 / 4, W, kCodeBytes, vec);
  __syncthreads();

  const uint32_t live = run_mask(static_cast<long long>(L) - k + 1 - (b0 + kRun * tid)) &
                        window_valid(m, k);
  if (live) {
    // hash the run, then queue its survivors: no branch among the hashes
    uint32_t code[4];
    run_codes(code_slab, tid, code);
    long long q[kRun];
    hash_run<NW>(code, k, [&](int j, uint64_t h) {
      q[j] = static_cast<long long>(h ^ 0x8000000000000000ull);
    });
    uint32_t surv = 0;
#pragma unroll
    for (int j = 0; j < kRun; ++j) surv |= static_cast<uint32_t>(q[j] <= t) << j;
    surv &= live;
    if (surv) {
      int at = atomicAdd(&n_queued, __popc(surv));
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        if ((surv >> j) & 1u) queue[at++] = q[j];
    }
  }
  const unsigned int c = __reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned int>(__popc(live)));
  if ((tid & 31) == 0) warp_total[tid >> 5] = c;
  __syncthreads();

  // the block's survivors, searched side by side: first key >= q, and on
  // an exact hit one count
  for (int i = tid; i < n_queued; i += kThreads) {
    const long long qi = queue[i];
    int lo = 0, hi = F;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(flat + mid) < qi) lo = mid + 1; else hi = mid;
    }
    if (lo < F && __ldg(flat + lo) == qi) atomicAdd(counts + lo, 1);
  }
  if (tid == 0) {
    unsigned long long sum = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) sum += warp_total[i];
    if (sum) atomicAdd(total, sum);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// The caller checks 1 <= k <= 32, k <= L <= 8 M, W = 2 M, 1 <= B <= 65535,
// 1 <= F < 2^31, dtypes and contiguity; vec: rows may be read 16 bytes at a
// time (M % 16 == 0, aligned bases).
extern "C" int screen_count_launch(const uint8_t* packed, const uint8_t* mask, int B,
                                   int W, int M, int L, int k, const int64_t* flat,
                                   int F, long long t, int* counts,
                                   unsigned long long* total, int vec, void* stream) {
  const long long n = static_cast<long long>(L) - k + 1;
  const dim3 grid(static_cast<unsigned>((n + kBlockWindows - 1) / kBlockWindows), B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HYMET_LAUNCH(NW)                                                            \
  screen_count_kernel<NW><<<grid, kThreads, 0, s>>>(packed, mask, W, M, L, k, flat, \
                                                    F, t, counts, total, vec)
  switch ((k + 7) / 8) {
    case 1: HYMET_LAUNCH(1); break;
    case 2: HYMET_LAUNCH(2); break;
    case 3: HYMET_LAUNCH(3); break;
    default: HYMET_LAUNCH(4); break;
  }
#undef HYMET_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
