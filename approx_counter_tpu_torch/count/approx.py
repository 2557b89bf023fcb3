"""Approximate-count re-rank.

Port of ``rank_with_zero_counts`` (``approx_counter_tpu/count/approx.py``),
the ``get_most_frequent`` re-rank after ``errorCount``
(approx_counter.cpp:922-923).  The reference stores ``results[kmer] =
total`` for every candidate, zero totals included, and those appear in the
exported ranking.  Here every row is a real candidate (the selection keeps
exactly ``n_keep`` of them), so zero counts rank like any other count and
need none of the JAX version's +1 key offset for padded slots.  A resume
list may repeat a code: its copies are equal in every key and rank side by
side.
"""

from __future__ import annotations

import torch

from approx_counter_tpu_torch.core.ordering import compare_count_order


def rank_with_zero_counts(codes: torch.Tensor, counts: torch.Tensor, k: int):
    """(codes, counts) of the candidates in CompareCount order."""
    order = compare_count_order(codes, counts.to(torch.int64), k)
    return codes[order], counts[order]
