// Candidate-bit-sliced level NFA: the core of nfa_sliced.cu and
// nfa_packed.cu.
//
// Both compute, for each candidate k-mer c, the sum over valid windows w of
// max(0, MAXERR + 1 - d_min(c, w)), where d_min is the least edit distance
// between c and any substring of w.  Text symbols are 0-3 (bases), 4 (N)
// and 5 (pad); N and pad match nothing.  The result is int32 and exact.
//
// Layout.  Bit b of a uint32 word holds the block's candidate b, so one
// word carries 32 candidates.  There is one state word R[d][i] per error level d
// and pattern position i >= d (bit b set iff P_b[0..i] matches a substring
// ending at the current text position with <= d edits); positions i < d are
// the all-ones constant and are never stored.  Per text symbol c:
//
//   Eq[i]    = T[c][i]
//   Rn_0[i]  = R_0[i-1] & Eq[i]                   (Rn_0[0] = Eq[0])
//   Rn_d[i]  = (R_d[i-1] & Eq[i]) | R_{d-1}[i] | R_{d-1}[i-1] | Rn_{d-1}[i-1]
//   h_d     |= Rn_d[K-1]
//
// T is the block's match table (Myers' Peq table, bit-sliced): bit b of
// T[s][i] is set iff candidate b's base at position i is s.  Row s < 4 is
// (P0[i] ^ x0) & (P1[i] ^ x1) for the masks x0, x1 of symbol s
// (approx::text_masks), where P0/P1 are the candidates' base bit-planes
// (bit b of P0[i] is bit 0 of candidate b's base at position i, P1 bit 1);
// rows 4 (N) and 5 (pad) are zero, so those symbols match nothing with no
// compare.  The levels nest, so a window contributes sum_d h_d, which
// equals max(0, MAXERR+1 - d_min).  Levels d > K-1 are constant (every
// window hits: the alignment to the empty substring) and are added as
// N_CONST * (valid windows).  The word form's shifts are the plane index
// i - 1: no shift op is left.
//
// The table lives in shared memory, built once per block from the planes,
// which are then dead.  Each row is kRow words: ceil(K/4) 16-byte chunks
// rounded up to an odd count, 4 * (ceil(K/4) | 1) words (20 at K = 16).  A
// thread reads its row with 16-byte loads (LDS.128; a narrower tail where
// K % 4 != 0).  A quarter-warp's 16-byte loads of chunk q over any mix of
// rows start at banks 4 * ((s * kRow / 4 + q) mod 8): kRow / 4 is odd,
// so the six rows fall on six distinct groups of four banks (0, 20, 8, 28,
// 16, 4 at K = 16) and no load conflicts.  The row of the next symbol is
// read a step ahead, and its byte a step before that, so neither load's
// latency sits in the chain of state updates.
//
// What bounds it on this card: integer logic, not bytes.  At K=16 and
// MAXERR=2 a text step is 85.5 ALU-pipe ops per 32-candidate word in the
// SASS (83 LOP3: the recurrence's 76 at least, 15 ANDs, two LOP3s per
// state at levels 1-2 and 3 ORs into h), 11.5 FMA-pipe and 103.5 issued
// (computing Eq from the planes at every step costs 148, 41 and 193: the
// reason for the table), and reads one byte per window.  Every state word stays in
// registers across the whole text loop: a thread owns one window and the
// block's word, all indices compile-time constants after unrolling
// (template on K and MAXERR).  A block is 256 windows of one word, so the
// planes and the table are uniform across it.  Row j of the [m, W] text is
// read as windows_t[j*W + w], one coalesced byte per lane.  Hits are
// reduced with warp ballots and popcounts, summed per block in shared
// memory, then added with one integer atomic per candidate: exact in any
// block order.

#pragma once

#include "approx_common.cuh"

namespace nfa {

using approx::kBlock;
using approx::kFull;

constexpr int kCands = 32;  // candidates per block: one bit of each plane
constexpr int kSymbols = 6;  // text symbols: bases 0-3, N 4, pad 5

// Eq[i] = row[i] for i < K: 16-byte loads, then an 8- and a 4-byte tail.
// row is 16-byte aligned.
template <int K>
__device__ __forceinline__ void load_row(const uint32_t* row,
                                         uint32_t (&Eq)[K]) {
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    const uint4 v = reinterpret_cast<const uint4*>(row)[q];
    Eq[4 * q] = v.x;
    Eq[4 * q + 1] = v.y;
    Eq[4 * q + 2] = v.z;
    Eq[4 * q + 3] = v.w;
  }
  constexpr int t = 4 * (K / 4);
  if constexpr (K % 4 >= 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(row + t);
    Eq[t] = v.x;
    Eq[t + 1] = v.y;
  }
  if constexpr (K % 2) Eq[K - 1] = row[K - 1];
}

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
  // words of a table row: ceil(K/4) 16-byte chunks, an odd count (the bank
  // rule in the note above)
  constexpr int kRow = 4 * (((K + 3) / 4) | 1);

  __shared__ int s_hits[kCands];
  __shared__ int s_valid;
  __shared__ __align__(16) uint32_t s_eq[kSymbols * kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long w = static_cast<long long>(blockIdx.x) * kBlock + tid;
  const bool in_range = w < W;
  const bool valid = in_range && wvalid[w] != 0;
  if (tid < kCands) s_hits[tid] = 0;
  if (tid == 0) s_valid = 0;
  if (tid < kSymbols) {  // thread s writes row s, its padding zeroed
    const approx::TextMasks t = approx::text_masks(tid);
    uint32_t* row = s_eq + tid * kRow;
#pragma unroll
    for (int i = 0; i < K; ++i) row[i] = approx::eq_select(P0[i], P1[i], t);
#pragma unroll
    for (int i = K; i < kRow; ++i) row[i] = 0u;
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
  __syncthreads();  // s_hits, s_valid and the table written

  // Eq_next holds the row of symbol j, c_next symbol j + 1 (pad past the
  // end); the row is read a step ahead of its use and the byte a step
  // ahead of that.  Unrolled by two, the two row buffers and the state
  // trade registers without moves.
  const uint8_t* col = windows_t + (in_range ? w : 0);
  uint32_t Eq_next[K];
  load_row<K>(s_eq + ((in_range && m > 0) ? col[0] : 5u) * kRow, Eq_next);
  uint32_t c_next = (in_range && m > 1) ? col[W] : 5u;
#pragma unroll 2
  for (int j = 0; j < m; ++j) {
    uint32_t Eq[K];
#pragma unroll
    for (int i = 0; i < K; ++i) Eq[i] = Eq_next[i];
    load_row<K>(s_eq + c_next * kRow, Eq_next);
    c_next = (in_range && j + 2 < m) ? col[static_cast<size_t>(j + 2) * W]
                                     : 5u;

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
