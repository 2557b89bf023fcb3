// The DUST dimer sums of int64 k-mer codes in one kernel: the re-rank's
// CompareCount key (count/approx.py:rank_with_zero_counts) on the card.
//
// Replaces no TPU kernel: the JAX package leaves dimer_sum's elementwise
// ops to XLA, which fuses them.  The port's plain version
// (core/complexity.py:dimer_sum) counts equal dimer pairs with 2·C(k-1, 2)
// + 3(k-1) elementwise ops, 255 launches at k = 16.
//
// The function: dimer[s] = dimer_sum(codes[s], k) (dimer_sum.cuh), int32.
// Layout: one thread a code; reads and writes of neighbouring codes
// coalesce.  What bounds it: 12 bytes a code, or at the re-rank's few
// hundred codes the launch itself.
//
// Built by approx_counter_tpu_torch/kernels/_build.py with nvcc for sm_90a
// and called through ctypes.

#include "dimer_sum.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
slot_dimers_kernel(const unsigned long long* __restrict__ codes,
                   int* __restrict__ dimer, long long n_codes, int k) {
  const long long s = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (s < n_codes) dimer[s] = dimer_sum(codes[s], k);
}

}  // namespace

// codes: int64 [n_codes]; dimer: int32 [n_codes].  2 <= k <= 32.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int slot_dimers(const void* codes, void* dimer, long long n_codes,
                           int k, void* stream) {
  if (k < 2 || k > 32 || n_codes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_codes == 0) return 0;
  const long long blocks = (n_codes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  slot_dimers_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(codes), static_cast<int*>(dimer),
      n_codes, k);
  return static_cast<int>(cudaGetLastError());
}
