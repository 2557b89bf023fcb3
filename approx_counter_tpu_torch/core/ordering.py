"""Total ordering of k-mer counts.

Reproduces ``CompareCount`` (approx_counter.cpp:275-305): rank (kmer, count)
pairs by

  1. count   -- descending
  2. DUST complexity score (float32) -- ascending (the integer dimer sum,
     see core/complexity.py)
  3. packed code -- descending, as an unsigned 64-bit value

torch has no multi-key sort, so the order is built from three sorts, least
significant key first: the codes descending, then stable sorts by dimer sum
ascending and by count descending.  Codes are int64 tensors holding the
uint64 bits: at k = 32 a code whose first base is G or T has bit 63 set and
is negative as int64, so the code sort flips the sign bit first, which maps
unsigned order onto signed order.
"""

from __future__ import annotations

import torch

from approx_counter_tpu_torch.core.complexity import dimer_sum

_SIGN = -(1 << 63)  # int64 with only bit 63 set


def compare_count_order(codes: torch.Tensor, counts: torch.Tensor,
                        k: int) -> torch.Tensor:
    """Permutation putting distinct int64 ``codes`` (uint64 bits, k <= 32)
    with their ``counts`` into CompareCount order."""
    order = torch.argsort(codes ^ _SIGN, descending=True)
    by_dimer = torch.sort(dimer_sum(codes[order], k), stable=True).indices
    order = order[by_dimer]
    by_count = torch.sort(counts[order], descending=True, stable=True).indices
    return order[by_count]
