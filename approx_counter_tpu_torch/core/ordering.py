"""Total ordering of k-mer counts.

Reproduces ``CompareCount`` (approx_counter.cpp:275-305): rank (kmer, count)
pairs by

  1. count   -- descending
  2. DUST complexity score (float32) -- ascending (the integer dimer sum,
     see core/complexity.py)
  3. packed code -- descending

torch has no multi-key sort, so the order is built from two sorts: one over
the unique composite key (dimer asc, code desc), then a stable sort by count
descending.
"""

from __future__ import annotations

import torch

from approx_counter_tpu_torch.core.complexity import dimer_sum


def compare_count_order(codes: torch.Tensor, counts: torch.Tensor,
                        k: int) -> torch.Tensor:
    """Permutation putting distinct int64 ``codes`` (k <= 16, so each fits
    in 32 bits) with their ``counts`` into CompareCount order."""
    if k > 16:
        raise ValueError(f"compare_count_order takes k <= 16, got {k}")
    minor = (dimer_sum(codes, k).to(torch.int64) << 32) | (0xFFFFFFFF - codes)
    order = torch.argsort(minor)
    by_count = torch.sort(counts[order], descending=True, stable=True).indices
    return order[by_count]
