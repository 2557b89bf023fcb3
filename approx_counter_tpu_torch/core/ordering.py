"""Total ordering of k-mer counts.

Reproduces ``CompareCount`` (approx_counter.cpp:275-305): rank (kmer, count)
pairs by

  1. count   -- descending
  2. DUST complexity score (float32) -- ascending (the integer dimer sum,
     see core/complexity.py)
  3. packed code -- descending, as an unsigned 64-bit value

torch has no multi-key sort, so the order is built from three stable sorts,
least significant key first: the codes descending, then the dimer sum
ascending and the count descending.  Codes are int64 tensors holding the
uint64 bits: at k = 32 a code whose first base is G or T has bit 63 set and
is negative as int64, so the code key flips the sign bit first, which maps
unsigned order onto signed order.
"""

from __future__ import annotations

import numpy as np
import torch

from approx_counter_tpu_torch.core.complexity import dimer_sum, dimer_sum_np

_SIGN = -(1 << 63)  # int64 with only bit 63 set


def compare_count_keys(codes: torch.Tensor, counts: torch.Tensor, k: int,
                       valid: torch.Tensor | None = None,
                       dimer: torch.Tensor | None = None):
    """The three keys whose ascending lexicographic order is CompareCount
    order: ``~count`` (in the counts' own signed integer dtype), the int32
    dimer sum, and ``~code`` with the code's sign bit flipped (descending
    unsigned order, int64).

    ``counts`` are non-negative; ``valid`` optionally masks entries, which
    then rank as count 0, after every count >= 1.  ``dimer`` is the codes'
    ``dimer_sum`` when the caller has it already.
    """
    if valid is not None:
        counts = torch.where(valid, counts, 0)
    if dimer is None:
        dimer = dimer_sum(codes, k)
    return ~counts, dimer, ~(codes ^ _SIGN)


def compare_count_order(codes: torch.Tensor, counts: torch.Tensor, k: int,
                        valid: torch.Tensor | None = None,
                        dimer: torch.Tensor | None = None) -> torch.Tensor:
    """Permutation putting int64 ``codes`` (uint64 bits, k <= 32) with their
    ``counts`` into CompareCount order (``valid`` and ``dimer`` as in
    ``compare_count_keys``): three stable sorts, least significant key
    first, so equal entries keep their input order."""
    by_count, by_dimer, by_code = compare_count_keys(codes, counts, k, valid,
                                                     dimer)
    order = torch.sort(by_code, stable=True).indices
    order = order[torch.sort(by_dimer[order], stable=True).indices]
    return order[torch.sort(by_count[order], stable=True).indices]


def sort_by_compare_count(codes: torch.Tensor, counts: torch.Tensor, k: int,
                          valid: torch.Tensor | None = None, extras=()):
    """Sort entries into CompareCount order; returns (codes, counts,
    *extras).  Masked entries (``valid`` False) and zero counts land at
    the end; the counts come back unmasked."""
    order = compare_count_order(codes, counts, k, valid)
    return (codes[order], counts[order], *(e[order] for e in extras))


def compare_count_np(codes: np.ndarray, counts: np.ndarray, k: int):
    """Host-side argsort into CompareCount order (NumPy twin).

    Returns indices ordering (count desc, dimer-sum asc, code desc); codes
    may be uint64 or int64 holding the uint64 bits.
    """
    codes = np.asarray(codes).astype(np.uint64)
    counts = np.asarray(counts, dtype=np.uint64)
    s = dimer_sum_np(codes, k)
    # np.lexsort: last key is primary.
    return np.lexsort((np.iinfo(np.uint64).max - codes, s,
                       -counts.astype(np.int64)))
