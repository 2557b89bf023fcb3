// Pieces shared by the candidate-bit-sliced approximate-count kernels (the
// level-NFA core nfa_sliced.cuh and the Myers core myers_sliced.cuh, and
// the two packed kernels that take SWAR words apart for them).
//
// All lay work out the same way: a block is kBlock windows (one per thread)
// by 32 candidates that every thread of the block shares, bit b of each
// plane word holding candidate b, so the planes are uniform across the
// block and the state lives in the thread's registers for the whole text
// loop.  Row j of the [m, W] text is read as windows_t[j * W + w], one
// coalesced byte per lane.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace approx {

constexpr int kBlock = 256;          // windows per block, one per thread
constexpr unsigned kFull = 0xFFFFFFFFu;

// Masks of one text symbol c (0-3 a base, >= 4 N or pad): x0 all ones iff
// bit 0 of c is 0, x1 likewise for bit 1, vm all ones iff c is a base.  For
// base planes P0 (bit b set iff candidate b's base there has bit 0 set: C,
// T) and P1 (bit 1: G, T), bit b of (P0 ^ x0) & (P1 ^ x1) & vm is set iff
// candidate b's base there is c.
struct TextMasks {
  uint32_t x0, x1, vm;
};

__device__ __forceinline__ TextMasks text_masks(uint32_t c) {
  return TextMasks{(c & 1u) - 1u, ((c >> 1) & 1u) - 1u, c < 4u ? kFull : 0u};
}

__device__ __forceinline__ uint32_t eq_select(uint32_t mask0, uint32_t mask1,
                                              TextMasks t) {
  return (mask0 ^ t.x0) & (mask1 ^ t.x1) & t.vm;
}

// Calls step(masks) for each of the m text symbols of window w, in order.
// Windows past W (the ragged last block) read the pad symbol 5.
template <class Step>
__device__ __forceinline__ void scan_text(const uint8_t* __restrict__ windows_t,
                                          long long w, bool in_range, int m,
                                          int W, Step step) {
  const uint8_t* col = windows_t + (in_range ? w : 0);
  uint32_t c_next = (in_range && m > 0) ? col[0] : 5u;
#pragma unroll 1
  for (int j = 0; j < m; ++j) {
    const uint32_t c = c_next;
    if (j + 1 < m) c_next = in_range ? col[static_cast<size_t>(j + 1) * W] : 5u;
    step(text_masks(c));
  }
}

// Lane b's base masks of candidate b of the block's 32 SWAR-packed
// candidates: field b % PACK of word (32 / PACK) * blockIdx.y + b / PACK
// of words ([n_words, 4] interleaved peq), shifted down to bit 0; zero
// past n_words.  mask0 holds the pattern bases with bit 0 set (C, T), mask1
// those with bit 1 set (G, T).  The cores read bits 0 .. k-1 only, and
// k <= 32 / PACK, so no bit of the next field is read.
template <int PACK>
__device__ __forceinline__ void swar_lane_masks(
    const uint32_t* __restrict__ words, int n_words, uint32_t& mask0,
    uint32_t& mask1) {
  const int lane = threadIdx.x & 31;
  const long long n =
      static_cast<long long>(blockIdx.y) * (32 / PACK) + lane / PACK;
  const int shift = (32 / PACK) * (lane % PACK);
  mask0 = 0u;
  mask1 = 0u;
  if (n < n_words) {
    const uint32_t* p = words + 4 * n;
    mask0 = (p[1] | p[3]) >> shift;
    mask1 = (p[2] | p[3]) >> shift;
  }
}

}  // namespace approx
