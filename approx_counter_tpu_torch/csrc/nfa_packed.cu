// Packed level NFA: approximate k-mer counts on Hopper.
//
// Replaces approx_counter_tpu/kernels/bpm.py:_nfa_kernel_packed (the Pallas
// TPU kernel behind approx_counts_pallas_packed(algo="nfa")).  It computes
// the same function as the other approximate-count kernels -- per
// candidate, the sum over valid windows of max(0, maxerr + 1 - d_min) --
// from the TPU kernel's input: SWAR words with PACK candidates in the
// fw = 32 / PACK bit fields of one word (PACK 1, 2, 4, 8, 16 for k <= 32,
// 16, 8, 4, 2), word n holding candidates PACK * n ... PACK * n + PACK - 1.
// The result is int32 and exact.
//
// The TPU kernel runs Wu-Manber's level NFA on the packed word itself: per
// level a shift of the word, a restart bit in each field and an initial
// state cut to the field width, about 4 + 7 * maxerr integer ops per word
// and text symbol, with 32 - k bits of the word idle at PACK 1.  Here the
// fields are taken apart instead: lane b of each warp takes field b % PACK
// of word kWords * blockIdx.y + b / PACK, candidate 32 * blockIdx.y + b
// (approx::swar_lane_masks), two ballots per pattern position build the 32
// candidates' base planes, and the sliced NFA's core (nfa_sliced.cuh) runs
// them from its match table in shared memory (six rows, one per text
// symbol, built once per block from the planes; layout and bank rule in
// nfa_sliced.cuh): its shifts are plane indices, and its constant levels
// count the alignment to the empty substring where k <= maxerr.  About 86
// ALU-pipe ops per 32 candidates and text symbol at k = 16, maxerr 2, at
// every PACK.
// That integer logic is what bounds it; the text is one byte per window
// and step.  out[PACK * n + f] is candidate PACK * n + f's count, as
// before.
//
// k and maxerr are compile-time constants (-DKMER, -DMAXERR), PACK a
// template parameter switched at the C entry (each PACK with
// KMER <= 32 / PACK); PACK touches only the prologue.
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

template <int K, int E, int PACK>
__global__ void __launch_bounds__(nfa::kBlock)
nfa_packed_kernel(const uint32_t* __restrict__ words,
                  const uint8_t* __restrict__ windows_t,
                  const uint8_t* __restrict__ wvalid,
                  int32_t* __restrict__ out, int n_words, int m, int W) {
  static_assert(K <= 32 / PACK, "a field holds at most 32 / PACK bases");
  uint32_t mask0, mask1;
  approx::swar_lane_masks<PACK>(words, n_words, mask0, mask1);
  uint32_t P0[K], P1[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    P0[i] = __ballot_sync(nfa::kFull, (mask0 >> i) & 1u);
    P1[i] = __ballot_sync(nfa::kFull, (mask1 >> i) & 1u);
  }
  const int c0 = blockIdx.y * nfa::kCands;  // n_words * PACK < 2^31
  nfa::count_word<K, E>(P0, P1, windows_t, wvalid, out + c0,
                        n_words * PACK - c0, m, W);
}

template <int PACK>
int launch(const void* words, const void* windows_t, const void* wvalid,
           void* out, int n_words, int m, int W, cudaStream_t stream) {
  constexpr int kWords = nfa::kCands / PACK;
  const long long groups = (n_words + kWords - 1LL) / kWords;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + nfa::kBlock - 1) / nfa::kBlock,
                  static_cast<unsigned>(groups));
  nfa_packed_kernel<KMER, MAXERR, PACK><<<grid, nfa::kBlock, 0, stream>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const uint8_t*>(windows_t),
      static_cast<const uint8_t*>(wvalid), static_cast<int32_t*>(out),
      n_words, m, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[n_words * pack] must be zeroed by the caller; out[pack*n + f] is the
// count of field f of word n.  words is [n_words, 4] uint32 (interleaved
// peq), windows_t is [m, W] uint8, wvalid is [W] bytes (0 or 1); k must be
// KMER and maxerr MAXERR.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int nfa_packed(const void* words, const void* windows_t,
                          const void* wvalid, void* out, int n_words, int m,
                          int W, int k, int maxerr, int pack, void* stream) {
  if (n_words <= 0 || W <= 0 || m < 0 || k != KMER || maxerr != MAXERR ||
      pack < 1 || k > 32 / pack)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (pack) {
    case 1: return launch<1>(words, windows_t, wvalid, out, n_words, m, W, s);
#if KMER <= 16
    case 2: return launch<2>(words, windows_t, wvalid, out, n_words, m, W, s);
#endif
#if KMER <= 8
    case 4: return launch<4>(words, windows_t, wvalid, out, n_words, m, W, s);
#endif
#if KMER <= 4
    case 8: return launch<8>(words, windows_t, wvalid, out, n_words, m, W, s);
#endif
#if KMER <= 2
    case 16: return launch<16>(words, windows_t, wvalid, out, n_words, m, W, s);
#endif
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
