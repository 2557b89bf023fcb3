"""Approximate-count stage: candidates x windows -> ranked counts.

Port of ``approx_counter_tpu/count/approx.py``, the ``errorCount`` and
``get_most_frequent`` re-rank (approx_counter.cpp:531-601, :922-923).  The
reference stores ``results[kmer] = total`` for every candidate, zero totals
included, and those appear in the exported ranking.

``rank_with_zero_counts`` is the pipeline's re-rank.  Given a ``valid``
mask, as the single-device pass's fixed-cap selection gives it and
``approx_count_rank`` takes it, it keeps the JAX version's +1 key offset,
so that a valid zero count still ranks before every padded slot.  Without
one every row is a real candidate (the eager pass keeps exactly ``n_keep``
of them, a resume pass scores a list), so zero counts rank like any other
count.  A resume list may repeat a code: its copies are equal in every key
and rank side by side.
"""

from __future__ import annotations

import torch

from approx_counter_tpu_torch.core.ordering import compare_count_order
from approx_counter_tpu_torch.kernels.bpm import MAXERR, approx_counts, build_peq
from approx_counter_tpu_torch.kernels.exact_stage import slot_dimers


def rank_with_zero_counts(codes: torch.Tensor, counts: torch.Tensor, k: int,
                          valid: torch.Tensor | None = None):
    """(codes, counts) of the candidates in CompareCount order; given a
    bool ``valid`` mask, (codes, counts, valid) with every invalid slot last
    and its count 0.  The dimer sums come from ``slot_dimers``, one kernel
    on the card."""
    dimer = slot_dimers(codes, k)
    if valid is None:
        order = compare_count_order(codes, counts.to(torch.int64), k,
                                    dimer=dimer)
        return codes[order], counts[order]
    # an invalid slot's code was still counted as a real k-mer: mask it
    counts = torch.where(valid, counts, 0)
    order = compare_count_order(codes, counts.to(torch.int64) + 1, k, valid,
                                dimer)
    return codes[order], counts[order], valid[order]


def approx_count_rank(windows: torch.Tensor, n_valid: int,
                      codes: torch.Tensor, sel_valid: torch.Tensor, k: int,
                      maxerr: int = MAXERR):
    """Approximate counts of a selection, ranked by CompareCount.

    windows:   uint8 [W, m] sampled windows (rows >= ``n_valid`` are padding)
    codes:     int64 [C] candidate codes; ``sel_valid`` bool [C] marks the
               real ones
    returns    (codes, counts int32, valid) in CompareCount order, every
               invalid slot last with count 0

    The counts come from ``approx_counts``: the sliced level NFA on CUDA
    tensors, its plain version on CPU tensors.
    """
    W = windows.shape[0]
    window_valid = torch.arange(W, device=windows.device) < n_valid
    counts = approx_counts(build_peq(codes, k), windows.t().contiguous(),
                           window_valid, k, maxerr)
    return rank_with_zero_counts(codes, counts, k, sel_valid)
