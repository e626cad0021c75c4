// Canonical k-mer MurmurHash3 of every window of a code batch, written by
// hand for Hopper.
//
// Replaces hymet_tpu/ops/pallas_kernels.py::_hash_tile_kernel
// (kmer_hashes_pallas), as a standalone function: for every k-window of a
// [B, L] uint8 code batch (0-3 = ACGT, >= 4 invalid)
//   valid = no code >= 4 in the window;
//   hash  = MurmurHash3_x64_128 h1, seed 42, of the canonical k-mer's ASCII
//           bytes (codes taken & 3, so invalid windows still get a defined
//           hash), stored as the uint64 bit pattern in int64.
// The screen's main path runs the fused screen_count.cu instead; this
// kernel is the counterpart the DB sketch build calls.
//
// What bounds it on an H100: about 110 32-bit integer instructions per
// window at k = 21 (75 ALU, 34 multiply-add; chip_smoke.py::window_ops)
// against 10 bytes of traffic (1 code in, 8 hash + 1 valid out), so the
// integer pipes, not memory, set its least time. The design keeps the instruction stream short: a block stages its
// codes once in shared memory as 2-bit words and validity bits (16 bytes a
// thread, coalesced); each thread hashes a run of kRun windows with
// kmer_core.cuh's shared work per run; the run's outputs, strided by kRun
// across threads, go through shared memory (rows of kRun + 1, free of bank
// conflicts) and leave coalesced.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_core.cuh"

namespace {

using namespace hymet;

template <int NW>
__global__ void __launch_bounds__(kThreads)
kmer_hash_kernel(const uint8_t* __restrict__ codes, int64_t* __restrict__ hash,
                 bool* __restrict__ valid, int L, int k, bool vec) {
  __shared__ uint32_t code_slab[kSlabWords];
  __shared__ uint16_t mask16[kSlabWords];
  __shared__ uint64_t out_hash[kThreads * (kRun + 1)];
  __shared__ uint32_t out_valid[kThreads];
  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const long long b0 = static_cast<long long>(blockIdx.x) * kBlockWindows;
  const uint8_t* src = codes + static_cast<size_t>(row) * L;

  // 16 codes a step -> one code word and 16 validity bits; past the row,
  // code 4 (invalid)
  load_code_slab(src, L, b0, kSlabWords, vec, code_slab, mask16);
  __syncthreads();

  const long long n = static_cast<long long>(L) - k + 1;
  const uint32_t live = run_mask(n - (b0 + kRun * tid));
  if (live) {
    uint32_t code[4];
    run_codes(code_slab, tid, code);
    uint64_t* out = out_hash + tid * (kRun + 1);
    hash_run<NW>(code, k, [&](int j, uint64_t h) { out[j] = h; });
  }
  out_valid[tid] = window_valid(run_valid_bits(mask16, tid), k) & live;
  __syncthreads();

  const size_t base = static_cast<size_t>(row) * n;
  for (int o = tid; o < kBlockWindows; o += kThreads) {
    const long long w = b0 + o;
    if (w < n) {
      hash[base + w] = static_cast<int64_t>(out_hash[(o / kRun) * (kRun + 1) + o % kRun]);
      valid[base + w] = (out_valid[o / kRun] >> (o % kRun)) & 1u;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// The caller checks 1 <= k <= 32, L >= k, 1 <= B <= 65535 and contiguity;
// vec: rows may be read 16 bytes at a time (L % 16 == 0, aligned base).
extern "C" int kmer_hash_launch(const uint8_t* codes, int64_t* hash, bool* valid,
                                int B, int L, int k, int vec, void* stream) {
  const long long n = static_cast<long long>(L) - k + 1;
  const dim3 grid(static_cast<unsigned>((n + kBlockWindows - 1) / kBlockWindows), B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((k + 7) / 8) {
    case 1: kmer_hash_kernel<1><<<grid, kThreads, 0, s>>>(codes, hash, valid, L, k, vec); break;
    case 2: kmer_hash_kernel<2><<<grid, kThreads, 0, s>>>(codes, hash, valid, L, k, vec); break;
    case 3: kmer_hash_kernel<3><<<grid, kThreads, 0, s>>>(codes, hash, valid, L, k, vec); break;
    default: kmer_hash_kernel<4><<<grid, kThreads, 0, s>>>(codes, hash, valid, L, k, vec); break;
  }
  return static_cast<int>(cudaGetLastError());
}
