// Unpacked Myers bit-vector DP: approximate k-mer counts on Hopper.
//
// Replaces approx_counter_tpu/kernels/bpm.py:_bpm_kernel (the Pallas TPU
// kernel behind approx_counts_pallas).  It computes the same function: for
// each candidate k-mer c, the sum over valid windows w of
// max(0, maxerr + 1 - d_min(c, w)), where d_min is the least edit distance
// between c and any substring of w.  The result is int32 and exact.
//
// The TPU kernel keeps one 32-bit Myers word per (candidate, window): about
// 17 integer ops per candidate and text symbol, with the word's bits at and
// above k idle.  Here the candidates are bit-sliced instead
// (myers_sliced.cuh): a thread carries 32 candidates in k planes, and a
// text symbol costs about 8 ops per plane, about 150 ALU-pipe ops per
// 32 candidates at k = 16.  That integer logic is what bounds it; the text
// is one byte per window and step.
//
// The input stays the TPU kernel's: peq [C, 4], one mask per base.  Lane b
// of each warp reads candidate 32 * blockIdx.y + b's masks and the core's
// ballots turn them into planes, so a block takes kCands = 32 candidates.
// k is a compile-time constant (-DKMER); maxerr is an argument, read only
// where the counts are taken.
//
// Built by approx_counter_tpu_torch/kernels/_build.py with nvcc for sm_90a,
// one shared library per KMER, and called through ctypes.

#include "myers_sliced.cuh"

#ifndef KMER
#error "build with -DKMER=<k>, 2 <= k <= 32"
#endif

namespace {

template <int K>
__global__ void __launch_bounds__(myers::kBlock)
bpm_myers_kernel(const uint32_t* __restrict__ peq,
                 const uint8_t* __restrict__ windows_t,
                 const uint8_t* __restrict__ wvalid,
                 int32_t* __restrict__ out, int C, int m, int W, int maxerr) {
  const long long c0 = static_cast<long long>(blockIdx.y) * myers::kCands;
  const long long c = c0 + (threadIdx.x & 31);
  uint32_t mask0 = 0u, mask1 = 0u;
  if (c < C) {
    const uint32_t* p = peq + 4 * c;
    mask0 = p[1] | p[3];  // bases C, T: bit 0 set
    mask1 = p[2] | p[3];  // bases G, T: bit 1 set
  }
  myers::count_word<K>(mask0, mask1, windows_t, wvalid, out, c0, C, m, W,
                       maxerr);
}

}  // namespace

// out[C] must be zeroed by the caller.  peq is [C, 4] uint32 (bit i of
// peq[c][b] set iff pattern base i of candidate c is b), windows_t is [m, W]
// uint8, wvalid is [W] bytes (0 or 1); k must be KMER.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int bpm_myers(const void* peq, const void* windows_t,
                         const void* wvalid, void* out, int C, int m, int W,
                         int k, int maxerr, void* stream) {
  const long long groups = (C + myers::kCands - 1LL) / myers::kCands;
  if (C <= 0 || groups > 65535 || W <= 0 || m < 0 || k != KMER ||
      maxerr < 0 || maxerr > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + myers::kBlock - 1) / myers::kBlock,
                  static_cast<unsigned>(groups));
  bpm_myers_kernel<KMER><<<grid, myers::kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(peq), static_cast<const uint8_t*>(windows_t),
      static_cast<const uint8_t*>(wvalid), static_cast<int32_t*>(out), C, m, W,
      maxerr);
  return static_cast<int>(cudaGetLastError());
}
