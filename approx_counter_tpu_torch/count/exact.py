"""Exact k-mer counting and top-N candidate selection.

Port of ``exact_count_select_rows(transposed=True)``
(``approx_counter_tpu/count/exact.py``).  Replaces the reference's
sliding-window hash-map count and sorted selection (``count_kmers``
approx_counter.cpp:487-519, ``get_most_frequent`` :396-405) with torch ops:

  1. pack every window position's k-mer into an int64 code in one sweep
     over the text rows, tracking N and pad as masks;
  2. sort the valid codes and run-length count them
     (``unique_consecutive``);
  3. drop low-complexity (DUST) and forbidden codes among the unique ones
     (the filters depend only on the code);
  4. rank the survivors in CompareCount order and keep the first ``limit``
     or, in solid mode (``solid_km > 0``, ``get_solid_kmers``
     approx_counter.cpp:372-388), every survivor counted ``solid_km`` times
     or more.  Solid mode has no cap: torch shapes follow the data, so the
     JAX package's cap regrowth has no counterpart here.

Steps 1-2 are ``exact_count_local`` and steps 3-4 ``select_counted``;
``dist/mesh.py:exact_count_select_sharded`` runs the first on each rank's
windows and the second on the codes each rank owns.  Everything is a sort
or a sum over positions, so the result does not depend on the window order.
"""

from __future__ import annotations

import torch

from approx_counter_tpu_torch.core.complexity import dimer_sum
from approx_counter_tpu_torch.core.ordering import compare_count_order


def exact_count_local(windows_t: torch.Tensor, row_mask: torch.Tensor,
                      k: int):
    """Steps 1-2 on a window batch (uint8 ``[m, n]``, text-major; bool row
    mask ``[n]``): ``(codes, counts, had_n)``, the unique int64 codes of the
    valid positions in ascending order, their int64 counts, and the number
    of N-containing k-mers in real windows as an int64 scalar tensor."""
    if not 2 <= k <= 32:
        raise ValueError(f"exact_count_select takes 2 <= k <= 32, got {k}")
    m, n = windows_t.shape
    p = m - k + 1  # sliding positions per window (ref :496)

    # --- 1. packing sweep over the text rows --------------------------------
    # At k = 32 the last shift moves the first base into bits 62-63: the
    # int64 shift wraps like the uint64 one, so the code holds the uint64
    # bits (negative as int64 when the first base is G or T).
    code = torch.zeros((p, n), dtype=torch.int64, device=windows_t.device)
    has_n = torch.zeros((p, n), dtype=torch.bool, device=windows_t.device)
    has_pad = torch.zeros_like(has_n)
    for j in range(k):
        sym = windows_t[j:j + p]
        has_n |= sym == 4
        has_pad |= sym >= 5
        code = (code << 2) | (sym & 3)
    row_valid = row_mask[None, :]
    # N-containing k-mers in real windows (ref had_n tally :513-517);
    # positions touching padding are not real sliding positions.
    had_n = (has_n & ~has_pad & row_valid).sum()
    valid = ~(has_n | has_pad) & row_valid

    # --- 2. sort + run-length count -----------------------------------------
    codes, counts = torch.unique_consecutive(
        torch.sort(code[valid]).values, return_counts=True
    )
    return codes, counts, had_n


def select_counted(codes: torch.Tensor, counts: torch.Tensor, k: int,
                   lc_sum_thr: int, forbidden: torch.Tensor, limit: int,
                   solid_km: int = 0) -> dict:
    """Steps 3-4 on distinct int64 ``codes`` and their int64 ``counts``:
    ``sel_codes`` and ``sel_counts`` of length ``n_keep`` in CompareCount
    order, and the ints ``n_pass`` and ``n_keep``."""
    # --- 3. filters on unique entries ---------------------------------------
    # haveLowComplexity: score >= threshold -> reject (integer-sum compare;
    # the k == 2 quirk arrives as an unreachable threshold)
    keep = dimer_sum(codes, k) < lc_sum_thr
    if forbidden.numel():
        keep &= ~torch.isin(codes, forbidden)
    if solid_km > 0:
        keep &= counts >= solid_km
    codes, counts = codes[keep], counts[keep]
    n_pass = codes.numel()

    # --- 4. CompareCount top-limit, or every solid k-mer --------------------
    n_keep = n_pass if solid_km > 0 else min(n_pass, limit)
    order = compare_count_order(codes, counts, k)[:n_keep]
    return dict(sel_codes=codes[order], sel_counts=counts[order],
                n_pass=n_pass, n_keep=n_keep)


def exact_count_select(
    windows_t: torch.Tensor,   # uint8 [m, n]: text-major window batch
    row_mask: torch.Tensor,    # bool [n]: which windows are real
    k: int,
    lc_sum_thr: int,           # integer dimer-sum threshold (lc_sum_threshold)
    forbidden: torch.Tensor,   # int64 [F] codes (F may be 0)
    limit: int,
    solid_km: int = 0,
) -> dict:
    """Top-``limit`` k-mers by CompareCount among those that pass the
    filters, or with ``solid_km > 0`` all of them whose count is at least
    ``solid_km`` (``limit`` is then ignored), in CompareCount order, the JAX
    package's deterministic refinement of the reference's tie-less sort.
    Returns ``sel_codes`` (int64) and ``sel_counts`` (int64) of length
    ``n_keep``, plus the ints ``n_unique``, ``n_pass``, ``n_keep`` and
    ``had_n``: ``exact_count_local`` then ``select_counted``."""
    codes, counts, had_n = exact_count_local(windows_t, row_mask, k)
    out = select_counted(codes, counts, k, lc_sum_thr, forbidden, limit,
                         solid_km)
    return dict(out, n_unique=codes.numel(), had_n=int(had_n))
