// Pieces shared by the per-thread-state approximate-count kernels
// (nfa_packed.cu, and bpm_myers.cu and bpm_packed.cu through
// myers_sliced.cuh).
//
// All lay work out the same way: a block is kBlock windows (one per thread)
// by a group of candidate words that every thread of the block shares, so a
// word's masks are uniform across the block and its state lives in the
// thread's registers for the whole text loop.  Row j of the [m, W] text is
// read as windows_t[j * W + w], one coalesced byte per lane.  At the end of
// nfa_packed.cu each thread holds one integer per output slot (candidate);
// block_add sums them with warp reductions and shared-memory atomics and
// adds each sum to the output with one integer atomicAdd: exact in any
// block order.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace approx {

constexpr int kBlock = 256;          // windows per block, one per thread
constexpr unsigned kFull = 0xFFFFFFFFu;

// Masks of one text symbol c (0-3 a base, >= 4 N or pad).  With
// mask0 = peq[C] | peq[T] (pattern bases whose bit 0 is set) and
// mask1 = peq[G] | peq[T], bit i of (mask0 ^ x0) & (mask1 ^ x1) & vm is set
// iff pattern base i == c.  Bits at and above k of a field can be set by the
// select (mask bits there are 0, so a text A sets them); every kernel here
// only moves bits upward, so they never reach the bit k-1 that is read.
struct TextMasks {
  uint32_t x0, x1, vm;
};

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
    step(TextMasks{(c & 1u) - 1u, ((c >> 1) & 1u) - 1u, c < 4u ? kFull : 0u});
  }
}

// Block-wide sum of each thread's value[s] for s < kSlots, added to
// out[base + s] for base + s < n_out.  s_acc is kSlots ints of shared
// memory, zeroed by the caller before a __syncthreads that precedes this.
template <int kSlots>
__device__ __forceinline__ void block_add(const int (&value)[kSlots],
                                          int* s_acc, int32_t* out,
                                          long long base, long long n_out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int sum = __reduce_add_sync(kFull, value[s]);
    if (lane == 0 && sum) atomicAdd(&s_acc[s], sum);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < kSlots; s += blockDim.x) {
    if (base + s < n_out && s_acc[s]) atomicAdd(&out[base + s], s_acc[s]);
  }
}

}  // namespace approx
