// Candidate-bit-sliced level NFA: approximate k-mer counts on Hopper.
//
// Replaces approx_counter_tpu/kernels/bpm.py:_nfa_kernel_sliced (the Pallas
// TPU kernel behind approx_counts_pallas_sliced).  It computes the same
// function: for each candidate k-mer c, the sum over valid windows w of
// max(0, MAXERR + 1 - d_min(c, w)), where d_min is the least edit distance
// between c and any substring of w.  Text symbols >= 4 (N, pad) match
// nothing.  The result is int32 and exact.
//
// Layout.  Bit b of a uint32 word holds candidate 32*cw + b, so one word
// carries 32 candidates.  There is one state word R[d][i] per error level d
// and pattern position i >= d (bit b set iff P_b[0..i] matches a substring
// ending at the current text position with <= d edits); positions i < d are
// the all-ones constant and are never stored.  Per text symbol:
//
//   Eq[i]    = ((P0[i] ^ x0) & (P1[i] ^ x1)) & vm
//   Rn_0[i]  = R_0[i-1] & Eq[i]                   (Rn_0[0] = Eq[0])
//   Rn_d[i]  = (R_d[i-1] & Eq[i]) | R_{d-1}[i] | R_{d-1}[i-1] | Rn_{d-1}[i-1]
//   h_d     |= Rn_d[K-1]
//
// P0/P1 are the candidates' base bit-planes (build_sliced_planes); x0, x1
// and vm are all-ones/all-zeros masks from the text symbol.  The levels nest,
// so a window contributes sum_d h_d, which equals max(0, MAXERR+1 - d_min).
// Levels d > K-1 are constant (every window hits) and are added as
// N_CONST * (valid windows).
//
// What bounds it on this card: integer logic, not bytes.  At K=16 and
// MAXERR=2 a text step is about 197 logic ops per 32-candidate word and
// reads one byte per window.  The design keeps every state word in registers
// across the whole text loop: one thread per (window, candidate word), all
// indices compile-time constants after unrolling (template on K and MAXERR).
// A block is 256 windows of one candidate word, so P0/P1 are uniform across
// it: one load into shared memory, then a broadcast into each thread's
// registers.  Row j of the [m, W] text is read as windows_t[j*W + w], one
// coalesced byte per lane.  Hits are reduced with warp ballots and popcounts,
// summed per block in shared memory, then added with one integer atomic per
// candidate: exact in any order.
//
// Built by approx_counter_tpu_torch/kernels/_build.py with nvcc for sm_90a,
// one shared library per (KMER, MAXERR), and called through ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef KMER
#error "build with -DKMER=<k>, 2 <= k <= 32"
#endif
#ifndef MAXERR
#error "build with -DMAXERR=<e>, 0 <= e <= 3"
#endif

namespace {

constexpr int kBlock = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int K, int E>
__global__ void __launch_bounds__(kBlock)
nfa_sliced_kernel(const uint32_t* __restrict__ p0,
                  const uint32_t* __restrict__ p1,
                  const uint8_t* __restrict__ windows_t,
                  const uint8_t* __restrict__ wvalid,
                  int32_t* __restrict__ out, int m, int W) {
  static_assert(K >= 2 && K <= 32, "K out of range");
  static_assert(E >= 0 && E <= 3, "MAXERR out of range");
  constexpr int kLevels = (E < K - 1 ? E : K - 1) + 1;  // variable levels
  constexpr int kConst = E + 1 - kLevels;               // all-constant levels

  __shared__ uint32_t s_p0[K];
  __shared__ uint32_t s_p1[K];
  __shared__ int s_hits[32];
  __shared__ int s_valid;

  const int cw = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long w = static_cast<long long>(blockIdx.x) * kBlock + tid;
  const bool in_range = w < W;
  const bool valid = in_range && wvalid[w] != 0;

  if (tid < K) {
    s_p0[tid] = p0[cw * K + tid];
    s_p1[tid] = p1[cw * K + tid];
  }
  if (tid < 32) s_hits[tid] = 0;
  if (tid == 0) s_valid = 0;
  __syncthreads();

  uint32_t P0[K], P1[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    P0[i] = s_p0[i];
    P1[i] = s_p1[i];
  }

  // R[d][i] is used for i >= d only; entries i < d stay zero and unread.
  uint32_t R[kLevels][K];
  uint32_t h[kLevels];
#pragma unroll
  for (int d = 0; d < kLevels; ++d) {
    h[d] = 0u;
#pragma unroll
    for (int i = 0; i < K; ++i) R[d][i] = 0u;
  }

  const uint8_t* col = windows_t + (in_range ? w : 0);
  uint32_t c_next = (in_range && m > 0) ? col[0] : 5u;
  for (int j = 0; j < m; ++j) {
    const uint32_t c = c_next;
    if (j + 1 < m) c_next = in_range ? col[static_cast<size_t>(j + 1) * W] : 5u;
    const uint32_t x0 = (c & 1u) - 1u;          // all ones iff text bit 0 == 0
    const uint32_t x1 = ((c >> 1) & 1u) - 1u;   // all ones iff text bit 1 == 0
    const uint32_t vm = c < 4u ? kFull : 0u;    // N and pad match nothing

    uint32_t Eq[K];
#pragma unroll
    for (int i = 0; i < K; ++i) Eq[i] = (P0[i] ^ x0) & (P1[i] ^ x1) & vm;

    uint32_t Rn[kLevels][K];
    Rn[0][0] = Eq[0];
#pragma unroll
    for (int i = 1; i < K; ++i) Rn[0][i] = R[0][i - 1] & Eq[i];
#pragma unroll
    for (int d = 1; d < kLevels; ++d) {
#pragma unroll
      for (int i = d; i < K; ++i) {
        uint32_t match = Eq[i];              // R_d[d-1] is the all-ones region
        if (i > d) match &= R[d][i - 1];
        Rn[d][i] = match | R[d - 1][i] | R[d - 1][i - 1] | Rn[d - 1][i - 1];
      }
    }
#pragma unroll
    for (int d = 0; d < kLevels; ++d) {
      h[d] |= Rn[d][K - 1];
#pragma unroll
      for (int i = d; i < K; ++i) R[d][i] = Rn[d][i];
    }
  }

  // Per-warp hit counts for each candidate bit; lane b keeps bit b's count.
  int mine = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    int n = 0;
#pragma unroll
    for (int d = 0; d < kLevels; ++d)
      n += __popc(__ballot_sync(kFull, valid && ((h[d] >> b) & 1u)));
    if (lane == b) mine = n;
  }
  if (mine) atomicAdd(&s_hits[lane], mine);
  const int n_valid = __popc(__ballot_sync(kFull, valid));
  if (lane == 0 && n_valid) atomicAdd(&s_valid, n_valid);
  __syncthreads();
  if (tid < 32) {
    const int total = s_hits[tid] + kConst * s_valid;
    if (total) atomicAdd(&out[cw * 32 + tid], total);
  }
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
