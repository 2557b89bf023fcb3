// Candidate-bit-sliced level NFA: the core of nfa_sliced.cu and
// nfa_packed.cu.
//
// Both compute, for each candidate k-mer c, the sum over valid windows w of
// max(0, MAXERR + 1 - d_min(c, w)), where d_min is the least edit distance
// between c and any substring of w.  Text symbols >= 4 (N, pad) match
// nothing.  The result is int32 and exact.
//
// Layout.  Bit b of a uint32 word holds the block's candidate b, so one
// word carries 32 candidates.  There is one state word R[d][i] per error level d
// and pattern position i >= d (bit b set iff P_b[0..i] matches a substring
// ending at the current text position with <= d edits); positions i < d are
// the all-ones constant and are never stored.  Per text symbol:
//
//   Eq[i]    = ((P0[i] ^ x0) & (P1[i] ^ x1)) & vm
//   Rn_0[i]  = R_0[i-1] & Eq[i]                   (Rn_0[0] = Eq[0])
//   Rn_d[i]  = (R_d[i-1] & Eq[i]) | R_{d-1}[i] | R_{d-1}[i-1] | Rn_{d-1}[i-1]
//   h_d     |= Rn_d[K-1]
//
// P0/P1 are the candidates' base bit-planes (bit b of P0[i] is bit 0 of
// candidate b's base at position i, P1 bit 1); x0, x1 and vm are
// all-ones/all-zeros masks from the text symbol.  The levels nest, so a
// window contributes sum_d h_d, which equals max(0, MAXERR+1 - d_min).
// Levels d > K-1 are constant (every window hits: the alignment to the
// empty substring) and are added as N_CONST * (valid windows).  The word
// form's shifts are the plane index i - 1: no shift op is left.
//
// What bounds it on this card: integer logic, not bytes.  At K=16 and
// MAXERR=2 a text step is about 150 ALU-pipe ops per 32-candidate word and
// reads one byte per window.  Every state word stays in registers across
// the whole text loop: a thread owns one window and the block's word, all
// indices compile-time constants after unrolling (template on K and
// MAXERR).  A block is 256 windows of one word, so the planes are uniform
// across it.  Row j of the [m, W] text is read as windows_t[j*W + w], one
// coalesced byte per lane.  Hits are reduced with warp ballots and
// popcounts, summed per block in shared memory, then added with one integer
// atomic per candidate: exact in any block order.

#pragma once

#include "approx_common.cuh"

namespace nfa {

using approx::kBlock;
using approx::kFull;

constexpr int kCands = 32;  // candidates per block: one bit of each plane

// Counts the block's 32 candidates (planes P0, P1, the same in every
// thread) against its 256 windows: out[b] gains candidate b's count for
// b < n_out (out points at the block's first candidate's count, n_out
// counts the outputs from there on).
template <int K, int E>
__device__ __forceinline__ void count_word(
    const uint32_t (&P0)[K], const uint32_t (&P1)[K],
    const uint8_t* __restrict__ windows_t, const uint8_t* __restrict__ wvalid,
    int32_t* __restrict__ out, int n_out, int m, int W) {
  static_assert(K >= 2 && K <= 32, "K out of range");
  static_assert(E >= 0 && E <= 3, "MAXERR out of range");
  constexpr int kLevels = (E < K - 1 ? E : K - 1) + 1;  // variable levels
  constexpr int kConst = E + 1 - kLevels;               // all-constant levels

  __shared__ int s_hits[kCands];
  __shared__ int s_valid;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long w = static_cast<long long>(blockIdx.x) * kBlock + tid;
  const bool in_range = w < W;
  const bool valid = in_range && wvalid[w] != 0;
  if (tid < kCands) s_hits[tid] = 0;
  if (tid == 0) s_valid = 0;

  // R[d][i] is used for i >= d only; entries i < d stay zero and unread.
  uint32_t R[kLevels][K];
  uint32_t h[kLevels];
#pragma unroll
  for (int d = 0; d < kLevels; ++d) {
    h[d] = 0u;
#pragma unroll
    for (int i = 0; i < K; ++i) R[d][i] = 0u;
  }
  __syncthreads();  // s_hits and s_valid zeroed

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
  if (tid < kCands && tid < n_out) {
    const int total = s_hits[tid] + kConst * s_valid;
    if (total) atomicAdd(&out[tid], total);
  }
}

}  // namespace nfa
