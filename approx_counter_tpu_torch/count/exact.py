"""Exact k-mer counting and top-N candidate selection.

Port of ``approx_counter_tpu/count/exact.py``.  Replaces the reference's
sliding-window hash-map count and sorted selection (``count_kmers``
approx_counter.cpp:487-519, ``get_most_frequent`` :396-405) with torch ops:

  1. pack every window position's k-mer into an int64 code in one sweep
     over the text rows, tracking N and pad as masks;
  2. sort the codes and run-length count them;
  3. drop low-complexity (DUST) and forbidden codes among the unique ones
     (the filters depend only on the code);
  4. rank the survivors in CompareCount order and keep the first ``limit``
     or, in solid mode (``solid_km > 0``, ``get_solid_kmers``
     approx_counter.cpp:372-388), every survivor counted ``solid_km`` times
     or more.

Two forms of it.  ``exact_count_select_rows``, the fixed-cap passes',
has fixed shapes and no host sync, so a CUDA graph can hold it:
``exact_count_local_rows`` (steps 1-2: every position is sorted, invalid
ones as code 0, taken out of that code's run again, and runs are found by
a boundary mask and a reverse ``cummin``), then ``select_counted_rows``
(steps 3-4 on fixed (code, count) slots: ``cap`` slots with a validity
mask); the caller re-runs it at a larger ``cap`` when ``n_keep`` outgrows
it (the JAX package's cap regrowth).  Their elementwise steps, 1 and 3,
are each one CUDA kernel on a CUDA tensor (``kernels/exact_stage.py``:
``position_keys``, ``slot_keys``) and torch ops on a CPU tensor.
``dist/mesh.py`` runs the first on each rank's windows and the second on
the slots each rank owns, their counts summed by ``_run_sums``, the same
run-length count.
``exact_count_select`` follows the data's shapes: ``exact_count_local``
(steps 1-2, ``unique_consecutive`` on the valid codes) then
``select_counted`` (steps 3-4).  Everything is a sort or a sum over
positions, so the result does not depend on the window order.
"""

from __future__ import annotations

import torch

from approx_counter_tpu_torch.core.complexity import dimer_sum, max_dimer_sum
from approx_counter_tpu_torch.core.ordering import _SIGN, compare_count_order
from approx_counter_tpu_torch.kernels.exact_stage import (
    position_keys,
    positions,
    slot_keys,
)

_I64_MAX = (1 << 63) - 1
#: Rows of ``_suffix_min``'s first level.
SCAN_ROWS = 1024
#: Slot granularity of a fixed-cap selection: a regrown cap is ``n_keep``
#: rounded up to it, as in the JAX package.
CT = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pass_cap(limit: int) -> int:
    """A pass's first selection cap, the JAX package's: ``limit`` rounded
    up to ``CT``, at least 512 and at most 2^20."""
    return max(512, _round_up(min(limit, 1 << 20), CT))


def exact_count_local(windows_t: torch.Tensor, row_mask: torch.Tensor,
                      k: int):
    """Steps 1-2 on a window batch (uint8 ``[m, n]``, text-major; bool row
    mask ``[n]``): ``(codes, counts, had_n)``, the unique int64 codes of the
    valid positions in ascending order, their int64 counts, and the number
    of N-containing k-mers in real windows as an int64 scalar tensor."""
    code, valid, had_n = positions(windows_t, row_mask, k)
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


def _suffix_min(x: torch.Tensor) -> torch.Tensor:
    """``min(x[i:])`` at every i of int64 ``x``, the reverse running
    minimum (``lax.cummin(reverse=True)``), in two levels: along each row
    of a ``[SCAN_ROWS, ceil(P / SCAN_ROWS)]`` view, then across the rows'
    minima.  ``torch.cummin`` scans a 1-D tensor in one thread block (9.81
    ms at P = 3,440,000 on an NVIDIA H100 80GB HBM3 at 700 W); rows scan
    in parallel."""
    P = x.shape[0]
    if P == 0:
        return x
    cols = -(-P // SCAN_ROWS)
    pad = x.new_full((SCAN_ROWS * cols - P,), _I64_MAX)
    rows = torch.cat([x, pad]).view(SCAN_ROWS, cols).flip(1)
    rows = torch.cummin(rows, 1).values.flip(1)
    # the least entry of the rows after each row
    after = torch.cummin(rows[:, 0].flip(0), 0).values.flip(0)
    after = torch.cat([after[1:], after.new_full((1,), _I64_MAX)])
    return torch.minimum(rows, after[:, None]).reshape(-1)[:P]


def _topk_global(x: torch.Tensor, cap: int):
    """The ``cap`` smallest of int64 ``x`` (values ascending, indices), in
    two levels of ``torch.topk``: each row's ``cap`` smallest of an
    ``[R, P/R]`` reshape, then the ``cap`` smallest of those.  Exact: fewer
    than ``cap`` entries anywhere rank before a global winner, so it is
    among its row's.  R is the largest power of two up to 256 that divides
    P with rows at least ``cap`` wide; one flat ``topk`` when none does.
    Ties may take other members than a flat call would; ``_topk_rank``
    does not depend on which."""
    P = x.shape[0]
    R = 256
    while R > 1 and (P % R or P // R < cap):
        R //= 2
    if R == 1:
        return torch.topk(x, cap, largest=False)
    v, i = torch.topk(x.view(R, P // R), cap, dim=1, largest=False)
    rows = torch.arange(R, device=x.device)[:, None] * (P // R)
    v2, j = torch.topk(v.reshape(-1), cap, largest=False)
    return v2, (rows + i).reshape(-1)[j]


def _sort2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Permutation ordering entries by (a, b) ascending."""
    order = torch.sort(b, stable=True).indices
    return order[torch.sort(a[order], stable=True).indices]


def _topk_rank(key1: torch.Tensor, ncode: torch.Tensor, cap: int):
    """Indices of the first ``cap`` entries in (key1, ncode) ascending
    order, in that order, without sorting all P entries: two top-k passes
    and an exact sort of their 2 x ``cap`` union.

    Let kb be the cap-th smallest key1, counted with multiplicity.  Every
    winner has key1 < kb, or key1 == kb and an ncode among the kb class's
    smallest.  The first top-k (smallest key1) holds every entry with key1
    < kb; the second (smallest ncode inside the kb class; entries outside
    it keyed ``INT64_MAX``) holds the class's ncode winners.  The one
    corner, a class member whose own ncode is ``INT64_MAX`` (code 0),
    ranks last in its class, so it wins only when the whole class fits in
    the first top-k.  The union therefore covers the true winners, and
    sorting it, a repeated index keyed last, puts them in order.  The
    class can be far larger than ``cap``: count-1 k-mers sharing a dimer
    sum run into the millions at the default run's size."""
    v1, i1 = _topk_global(key1, cap)
    in_class = key1 == v1[cap - 1]
    _, i2 = _topk_global(torch.where(in_class, ncode, _I64_MAX), cap)
    idx = torch.sort(torch.cat([i1, i2])).values
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=idx.device),
                     idx[1:] == idx[:-1]])
    order = _sort2(torch.where(dup, _I64_MAX, key1[idx]),
                   torch.where(dup, _I64_MAX, ncode[idx]))
    return idx[order[:cap]]


def _cap_slice(x: torch.Tensor, cap: int) -> torch.Tensor:
    """``x[:cap]``, padded with zeros to ``cap`` entries when x is shorter
    (a regrown cap can pass P on a small batch)."""
    if x.shape[0] >= cap:
        return x[:cap]
    return torch.cat([x, x.new_zeros(cap - x.shape[0])])


def _run_sums(s: torch.Tensor, weight: torch.Tensor | None = None):
    """At the first position of each run of equal entries of sorted int64
    ``s``: the run's length, or with ``weight`` the sum of its entries'
    weights; 0 at every other position.  Runs end at the next run start, a
    reverse running minimum (``_suffix_min``), so no shape depends on the
    data."""
    P = s.shape[0]
    idx = torch.arange(P, device=s.device)
    is_start = torch.ones(P, dtype=torch.bool, device=s.device)
    is_start[1:] = s[1:] != s[:-1]
    next_start = torch.empty_like(idx)
    next_start[:-1] = _suffix_min(torch.where(is_start, idx, P))[1:]
    next_start[-1:] = P
    if weight is None:
        run = next_start - idx
    else:
        ends = torch.zeros(P + 1, dtype=torch.int64, device=s.device)
        ends[1:] = torch.cumsum(weight, 0)
        run = ends[next_start] - ends[idx]
    return torch.where(is_start, run, 0)


def exact_count_local_rows(windows_t: torch.Tensor, row_mask: torch.Tensor,
                           k: int):
    """Steps 1-2 of ``exact_count_select_rows`` in fixed shapes, with no
    host sync: ``(codes, counts, had_n)``, every position's int64 code in
    ascending unsigned order, its int64 run count (non-zero only at the
    first position of a valid k-mer's run), and the number of N-containing
    k-mers in real windows as a 0-d int64 tensor."""
    keys, n_valid, had_n = position_keys(windows_t, row_mask, k)
    # Invalid positions sort as code 0 (the all-A k-mer), which comes first
    # in unsigned order (the sign bit flipped for the signed sort), so they
    # join the first run, and that run's count drops by how many there are.
    s = torch.sort(keys).values ^ _SIGN
    counts = _run_sums(s)
    # the first run may hold invalid positions only: its count is then 0
    counts[:1] -= keys.shape[0] - n_valid
    return s, counts, had_n


def select_counted_rows(
    codes: torch.Tensor,       # int64 [P] code slots
    counts: torch.Tensor,      # int64 [P]: each slot's count, 0 if empty
    k: int,
    lc_sum_thr: int,           # integer dimer-sum threshold (lc_sum_threshold)
    forbidden: torch.Tensor,   # int64 [F] codes (F may be 0)
    limit: int,
    solid_km: int,
    cap: int,                  # selection slots (>= the k-mers kept)
) -> dict:
    """Steps 3-4 of ``exact_count_select_rows`` on fixed (code, count)
    slots, each non-empty slot a distinct code: the filters, then the first
    ``cap`` survivors in CompareCount order (``_topk_rank``, not a sort of
    every slot, where k <= 16 and the slots outnumber ``2 * cap``).
    Returns ``sel_codes``, ``sel_counts`` (int64 ``[cap]``), ``sel_valid``
    (bool ``[cap]``: the first ``n_keep`` slots), and ``n_pass``,
    ``n_keep`` and ``n_unique`` (the non-empty slots) as 0-d int64
    tensors."""
    P = codes.shape[0]
    dev = codes.device

    # --- 3. filters on the non-empty slots, 4. CompareCount top-cap --------
    # (count desc, dimer asc) in one key; the code, descending unsigned, in
    # a second (``~(code ^ sign)``).  Every slot that did not pass has
    # count 0 and so ranks after every one that did.
    by_topk = k <= 16 and P > 2 * cap
    slots = slot_keys(codes, counts, k, lc_sum_thr, forbidden, solid_km,
                      max_dimer_sum(k).bit_length() if by_topk else None)
    count, n_pass = slots["count"], slots["n_pass"]
    if by_topk:
        top = _topk_rank(slots["key1"], slots["ncode"], cap)
    else:
        top = compare_count_order(codes, count, k, slots["keep"],
                                  slots["dimer"])[:cap]
    sel_codes = _cap_slice(codes[top], cap)
    sel_counts = _cap_slice(count[top], cap)
    n_keep = n_pass if solid_km > 0 else n_pass.clamp(max=limit)
    sel_valid = (torch.arange(cap, device=dev) < n_keep) & (sel_counts > 0)
    return dict(sel_codes=sel_codes, sel_counts=sel_counts,
                sel_valid=sel_valid, n_pass=n_pass, n_keep=n_keep,
                n_unique=slots["n_unique"])


def exact_count_select_rows(
    windows_t: torch.Tensor,   # uint8 [m, n]: text-major window batch
    row_mask: torch.Tensor,    # bool [n]: which windows are real
    k: int,
    lc_sum_thr: int,           # integer dimer-sum threshold (lc_sum_threshold)
    forbidden: torch.Tensor,   # int64 [F] codes (F may be 0)
    limit: int,
    solid_km: int,
    cap: int,                  # selection slots (>= the k-mers kept)
) -> dict:
    """``exact_count_select`` in fixed shapes, with no host sync: the
    first ``cap`` k-mers in CompareCount order among those that pass the
    filters (and, with ``solid_km > 0``, count at least ``solid_km``).
    Returns ``sel_codes`` (int64 ``[cap]``), ``sel_counts`` (int64
    ``[cap]``) and ``sel_valid`` (bool ``[cap]``: the first ``n_keep``
    slots), and ``n_unique``, ``n_pass``, ``n_keep`` (``n_pass`` in solid
    mode, else at most ``limit``) and ``had_n`` as 0-d int64 tensors.
    Slots past ``n_keep`` hold whatever ranks there; ``n_keep > cap``
    means the caller must run it again at a larger ``cap``:
    ``exact_count_local_rows`` then ``select_counted_rows``."""
    codes, counts, had_n = exact_count_local_rows(windows_t, row_mask, k)
    out = select_counted_rows(codes, counts, k, lc_sum_thr, forbidden, limit,
                              solid_km, cap)
    return dict(out, had_n=had_n)
