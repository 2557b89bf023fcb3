// Candidate-bit-sliced level NFA: approximate k-mer counts on Hopper.
//
// Replaces approx_counter_tpu/kernels/bpm.py:_nfa_kernel_sliced (the Pallas
// TPU kernel behind approx_counts_pallas_sliced).  It computes the same
// function: for each candidate k-mer c, the sum over valid windows w of
// max(0, MAXERR + 1 - d_min(c, w)), where d_min is the least edit distance
// between c and any substring of w.  Text symbols are 0-5; 4 (N) and 5
// (pad) match nothing.  The result is int32 and exact.
//
// Its input is the TPU kernel's: the candidates' base bit-planes, built on
// the host (build_sliced_planes), one [K] pair per 32-candidate word.  A
// block is 256 windows of one word: its planes come into shared memory
// with one load, then into each thread's registers, and the level-NFA core
// (nfa_sliced.cuh, shared with nfa_packed.cu) builds the block's match
// table from them and runs the text loop, with its note on layout and
// bound.
//
// Built by approx_counter_tpu_torch/kernels/_build.py with nvcc for sm_90a,
// one shared library per (KMER, MAXERR), and called through ctypes.

#include "nfa_sliced.cuh"

#ifndef KMER
#error "build with -DKMER=<k>, 2 <= k <= 32"
#endif
#ifndef MAXERR
#error "build with -DMAXERR=<e>, 0 <= e <= 3"
#endif

namespace {

using nfa::kBlock;

template <int K, int E>
__global__ void __launch_bounds__(kBlock)
nfa_sliced_kernel(const uint32_t* __restrict__ p0,
                  const uint32_t* __restrict__ p1,
                  const uint8_t* __restrict__ windows_t,
                  const uint8_t* __restrict__ wvalid,
                  int32_t* __restrict__ out, int m, int W) {
  __shared__ uint32_t s_p0[K];
  __shared__ uint32_t s_p1[K];

  const int cw = blockIdx.y;
  const int tid = threadIdx.x;
  if (tid < K) {
    s_p0[tid] = p0[cw * K + tid];
    s_p1[tid] = p1[cw * K + tid];
  }
  __syncthreads();

  uint32_t P0[K], P1[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    P0[i] = s_p0[i];
    P1[i] = s_p1[i];
  }
  nfa::count_word<K, E>(P0, P1, windows_t, wvalid, out + cw * nfa::kCands,
                        nfa::kCands, m, W);
}

}  // namespace

// out[32*n_words] must be zeroed by the caller.  p0/p1 are [n_words, KMER]
// uint32, windows_t is [m, W] uint8, wvalid is [W] bytes (0 or 1).  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int nfa_sliced(const void* p0, const void* p1,
                          const void* windows_t, const void* wvalid, void* out,
                          int n_words, int m, int W, void* stream) {
  if (n_words <= 0 || n_words > 65535 || W <= 0 || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kBlock - 1) / kBlock, n_words);
  nfa_sliced_kernel<KMER, MAXERR><<<grid, kBlock, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(p0), static_cast<const uint32_t*>(p1),
      static_cast<const uint8_t*>(windows_t),
      static_cast<const uint8_t*>(wvalid), static_cast<int32_t*>(out), m, W);
  return static_cast<int>(cudaGetLastError());
}
