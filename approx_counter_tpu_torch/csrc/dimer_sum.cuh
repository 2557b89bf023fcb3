// The DUST dimer sum of one k-mer code: the core of slot_keys.cu and
// slot_dimers.cu.
//
// dimer_sum(c, k) = sum over the 16 dimer values v of h_v (h_v - 1), h the
// histogram of the k - 1 dimers (c >> 2j) & 15, j < k - 1: the integer DUST
// sum, core/complexity.py:dimer_sum (0 at k = 2, whose one dimer has no
// pair).  The histogram lives in two registers of eight 8-bit bins (k - 1
// <= 31 dimers fit a bin), and adding a dimer whose bin holds h adds 2h to
// the sum, so no dimer is compared with another: about eight integer ops a
// dimer.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ int dimer_sum(unsigned long long code, int k) {
  unsigned long long lo = 0, hi = 0;  // bins of dimers 0-7 and 8-15
  int pairs = 0;
  for (int j = 0; j < k - 1; ++j) {
    const unsigned d = static_cast<unsigned>(code >> (2 * j)) & 15;
    const unsigned sh = 8 * (d & 7);
    pairs += static_cast<int>(((d < 8 ? lo : hi) >> sh) & 0xff);
    const unsigned long long one = 1ull << sh;
    lo += d < 8 ? one : 0;
    hi += d < 8 ? 0 : one;
  }
  return 2 * pairs;
}
