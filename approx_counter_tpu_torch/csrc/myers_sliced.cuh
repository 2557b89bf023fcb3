// Candidate-bit-sliced Myers bit-vector DP: the core of bpm_myers.cu and
// bpm_packed.cu.
//
// Both compute, for each candidate k-mer c, the sum over valid windows w of
// max(0, maxerr + 1 - d_min(c, w)), where d_min is the least edit distance
// between c and any substring of w (Myers 1999, semi-global: the score
// starts at k and its running minimum over the text is d_min).  Text
// symbols >= 4 (N, pad) match nothing.  The result is int32 and exact.
//
// Layout.  Plane i of a state vector is one uint32 whose bit b is bit i of
// candidate 32 * g + b's vector, so a word of planes carries 32 candidates.
// A thread owns one window and one such word, every plane in registers for
// the whole text loop; a block is 256 windows of one word, so the
// candidates' planes are uniform across it.  Each warp builds them in its
// prologue: lane b holds candidate b's masks and one ballot per plane and
// base bit gathers bit i of the 32 masks.  K = k planes, every plane index
// a compile-time constant after unrolling.
//
// Per text symbol, for planes i = 0 .. K-1 in order (Mh_{-1} = Ph_{-1} = 0:
// the text may start anywhere):
//
//   Eq_i  = (P0_i ^ x0) & (P1_i ^ x1) & vm
//   Xh_i  = Eq_i | Mh_{i-1}
//   Mh_i  = VP_i & Xh_i
//   Ph_i  = VN_i | ~(Xh_i | VP_i)
//   Xv_i  = Eq_i | VN_i
//   VP_i' = Mh_{i-1} | ~(Xv_i | Ph_{i-1})
//   VN_i' = Ph_{i-1} & Xv_i
//
// The word form's one carry-coupled op, Xh = (((Eq & VP) + VP) ^ VP) | Eq,
// becomes the ripple along the planes: bit i of the sum is
// (Eq_i & VP_i) ^ VP_i ^ carry_i, so Xh_i = ((Eq_i & VP_i) ^ carry_i) | Eq_i
// = Eq_i | carry_i, and the carry out, maj(Eq_i & VP_i, VP_i, carry_i) =
// VP_i & (Eq_i | carry_i), is Mh_i itself.  The shifts Ph << 1 and Mh << 1
// are the plane index i - 1.  The carry out of plane K-1 is dropped, as the
// word form drops the bits above k - 1.
//
// The score moves by +1 where Ph_{K-1} is set and -1 where Mh_{K-1} is
// (never both).  It lies in [0, K] and is kept bit-sliced in
// kBits = bit_width(K) planes as an up/down counter: bit j toggles where
// every lower bit is 1 (up) or 0 (down).  h_d gathers [score <= d] for
// d = 0 .. 3, from the start on (the start's score is K, so h_d starts full
// for d >= K); the levels nest, so a window adds sum_{d <= maxerr} h_d,
// which is max(0, maxerr + 1 - d_min).  maxerr is read only there.
//
// What bounds it on this card: integer logic, about 8 ops per plane (2 for
// Eq, one each for Xh, Mh, Ph, Xv, VP', VN'; plane 0 fewer) plus about
// 2 * kBits + 7 for the score and h, for 32 candidates at once: about 150
// ALU-pipe ops per word and text symbol at K = 16, where the word form
// spent about 17 per candidate and the 2- and 4-field SWAR forms about 21
// per word.  The hits are reduced with warp ballots and popcounts, summed
// per block in shared memory and added with one integer atomic per
// candidate: exact in any block order.

#pragma once

#include "approx_common.cuh"

namespace myers {

using approx::kBlock;
using approx::kFull;

constexpr int kCands = 32;  // candidates per block: one bit of each plane

// Bits of the score's counter: the score lies in [0, K].
__host__ __device__ constexpr int score_bits(int K) {
  return K < 2 ? 1 : 1 + score_bits(K / 2);
}

// Counts the block's 32 candidates against its 256 windows: lane b of
// every warp passes candidate c0 + b's base masks (mask0 = pattern bases
// with bit 0 set, mask1 = with bit 1 set; zero for a candidate past
// n_out), and out[c0 + b] gains its count for c0 + b < n_out.
template <int K>
__device__ __forceinline__ void count_word(
    uint32_t mask0, uint32_t mask1, const uint8_t* __restrict__ windows_t,
    const uint8_t* __restrict__ wvalid, int32_t* __restrict__ out,
    long long c0, long long n_out, int m, int W, int maxerr) {
  static_assert(K >= 2 && K <= 32, "K out of range");
  constexpr int kBits = score_bits(K);
  __shared__ int s_hits[kCands];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long w = static_cast<long long>(blockIdx.x) * kBlock + tid;
  const bool in_range = w < W;
  const bool valid = in_range && wvalid[w] != 0;
  if (tid < kCands) s_hits[tid] = 0;

  uint32_t P0[K], P1[K], VP[K], VN[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    P0[i] = __ballot_sync(kFull, (mask0 >> i) & 1u);
    P1[i] = __ballot_sync(kFull, (mask1 >> i) & 1u);
    VP[i] = kFull;
    VN[i] = 0u;
  }
  uint32_t s[kBits];  // the score, K in every candidate
#pragma unroll
  for (int j = 0; j < kBits; ++j) s[j] = ((K >> j) & 1) ? kFull : 0u;
  uint32_t h[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) h[d] = d >= K ? kFull : 0u;
  __syncthreads();  // s_hits zeroed

  approx::scan_text(windows_t, w, in_range, m, W, [&](approx::TextMasks t) {
    uint32_t ph = 0u, mh = 0u;  // Ph_{i-1}, Mh_{i-1}
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const uint32_t eq = approx::eq_select(P0[i], P1[i], t);
      const uint32_t xh = eq | mh;
      const uint32_t xv = eq | VN[i];
      const uint32_t ph_i = VN[i] | ~(xh | VP[i]);
      const uint32_t mh_i = VP[i] & xh;
      VP[i] = mh | ~(xv | ph);
      VN[i] = ph & xv;
      ph = ph_i;
      mh = mh_i;
    }
    uint32_t toggle = ph | mh;
#pragma unroll
    for (int j = 0; j < kBits; ++j) {
      const uint32_t bit = s[j];
      s[j] = bit ^ toggle;
      toggle &= ~(bit ^ ph);  // up: carry where bit was 1; down: borrow where 0
    }
    uint32_t low = kFull;  // score <= 3
#pragma unroll
    for (int j = 2; j < kBits; ++j) low &= ~s[j];
    h[0] |= low & ~(s[1] | s[0]);
    h[1] |= low & ~s[1];
    h[2] |= low & ~(s[1] & s[0]);
    h[3] |= low;
  });

  // Per-warp hit counts for each candidate bit; lane b keeps bit b's count.
  int mine = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    int n = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d)
      if (d <= maxerr)
        n += __popc(__ballot_sync(kFull, valid && ((h[d] >> b) & 1u)));
    if (lane == b) mine = n;
  }
  if (mine) atomicAdd(&s_hits[lane], mine);
  __syncthreads();
  if (tid < kCands && c0 + tid < n_out && s_hits[tid])
    atomicAdd(&out[c0 + tid], s_hits[tid]);
}

}  // namespace myers
