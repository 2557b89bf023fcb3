// Packed Myers bit-vector DP: approximate k-mer counts on Hopper.
//
// Replaces approx_counter_tpu/kernels/bpm.py:_bpm_kernel_packed (the Pallas
// TPU kernel behind approx_counts_pallas_packed(algo="myers")).  It computes
// the same function as bpm_myers.cu -- per candidate, the sum over valid
// windows of max(0, maxerr + 1 - d_min) -- from the TPU kernel's input:
// SWAR words with PACK candidates in the fw = 32 / PACK bit fields of one
// word (PACK 2: k <= 16, PACK 4: k <= 8), word n holding candidates
// PACK * n ... PACK * n + PACK - 1.  The result is int32 and exact.
//
// The TPU kernel runs Myers on the packed word itself: a per-field add
// (about 5 ops) for the one carry-coupled op, a LEAK mask after each shift
// and one packed score, about 21 integer ops per word and text symbol, so
// about 10 per candidate at PACK 2.  Hopper's DPX halfword add would save
// about 3 of them and has no byte form for PACK 4.  So the fields are taken
// apart instead: lane b of each warp takes field b % PACK of word
// kWords * blockIdx.y + b / PACK, candidate 32 * blockIdx.y + b, and the
// bit-sliced core (myers_sliced.cuh) runs the 32 candidates in k planes,
// about 150 ALU-pipe ops per 32 candidates and text symbol at k = 16.  That
// integer logic is what bounds it; the text is one byte per window and
// step.  out[PACK * n + f] is candidate PACK * n + f's count, as before.
//
// k is a compile-time constant (-DKMER), PACK a template parameter
// switched at the C entry (PACK 4 exists for KMER <= 8); maxerr is an
// argument, read only where the counts are taken.
//
// Built by approx_counter_tpu_torch/kernels/_build.py with nvcc for sm_90a,
// one shared library per KMER, and called through ctypes.

#include "myers_sliced.cuh"

#ifndef KMER
#error "build with -DKMER=<k>, 2 <= k <= 16"
#endif

namespace {

template <int K, int PACK>
__global__ void __launch_bounds__(myers::kBlock)
bpm_packed_kernel(const uint32_t* __restrict__ words,
                  const uint8_t* __restrict__ windows_t,
                  const uint8_t* __restrict__ wvalid,
                  int32_t* __restrict__ out, int n_words, int m, int W,
                  int maxerr) {
  static_assert((PACK == 2 || PACK == 4) && K <= 32 / PACK,
                "Myers packs 2 fields for k <= 16, 4 for k <= 8");
  uint32_t mask0, mask1;
  approx::swar_lane_masks<PACK>(words, n_words, mask0, mask1);
  myers::count_word<K>(mask0, mask1, windows_t, wvalid, out,
                       static_cast<long long>(blockIdx.y) * myers::kCands,
                       static_cast<long long>(n_words) * PACK, m, W, maxerr);
}

template <int PACK>
int launch(const void* words, const void* windows_t, const void* wvalid,
           void* out, int n_words, int m, int W, int maxerr,
           cudaStream_t stream) {
  constexpr int kWords = myers::kCands / PACK;
  const long long groups = (n_words + kWords - 1LL) / kWords;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + myers::kBlock - 1) / myers::kBlock,
                  static_cast<unsigned>(groups));
  bpm_packed_kernel<KMER, PACK><<<grid, myers::kBlock, 0, stream>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const uint8_t*>(windows_t),
      static_cast<const uint8_t*>(wvalid), static_cast<int32_t*>(out),
      n_words, m, W, maxerr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[n_words * pack] must be zeroed by the caller; out[pack*n + f] is the
// count of field f of word n.  words is [n_words, 4] uint32 (interleaved
// peq), windows_t is [m, W] uint8, wvalid is [W] bytes (0 or 1); k must be
// KMER.  Returns the cudaError_t of the launch (0 on success).
extern "C" int bpm_packed(const void* words, const void* windows_t,
                          const void* wvalid, void* out, int n_words, int m,
                          int W, int k, int maxerr, int pack, void* stream) {
  if (n_words <= 0 || W <= 0 || m < 0 || k != KMER || maxerr < 0 ||
      maxerr > 3 || (pack != 2 && pack != 4) || k > 32 / pack)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (pack == 2)
    return launch<2>(words, windows_t, wvalid, out, n_words, m, W, maxerr, s);
#if KMER <= 8
  return launch<4>(words, windows_t, wvalid, out, n_words, m, W, maxerr, s);
#else
  return static_cast<int>(cudaErrorInvalidValue);
#endif
}
