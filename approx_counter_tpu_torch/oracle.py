"""Slow, obviously-correct NumPy/Python oracle of the reference semantics.

This module is the differential-testing ground truth (SURVEY.md §4): a
direct, hash-map-style transcription of the *behavior* specified by
/root/reference/approx_counter.cpp, used to validate the TPU array programs
and the Pallas kernel on small inputs.  It is deliberately naive -- clarity
over speed -- and never used on the hot path.
"""

from __future__ import annotations

import numpy as np

from approx_counter_tpu_torch.core.codec import BASE_N


def oracle_complexity(code: int, k: int) -> float:
    """getComplexity (approx_counter.cpp:247-267), float32 arithmetic."""
    counts = [0] * 16
    v = code
    for _ in range(k - 1):
        counts[v & 15] += 1
        v >>= 2
    s = sum(c * (c - 1) for c in counts)
    with np.errstate(invalid="ignore", divide="ignore"):
        return float(np.float32(s) / np.float32(2 * (k - 2)))


def oracle_count_kmers(
    windows: list[np.ndarray], k: int, lc_threshold: float, forbidden: set[int]
) -> tuple[dict[int, int], int]:
    """count_kmers (approx_counter.cpp:487-519) over ordinal windows.

    Returns (counter, had_n).
    """
    count: dict[int, int] = {}
    had_n = 0
    thr = np.float32(lc_threshold)
    for seq in windows:
        L = len(seq)
        for i in range(L - k + 1):
            km = seq[i : i + k]
            if np.any(km >= BASE_N):
                had_n += 1
                continue
            code = 0
            for c in km:
                code = (code << 2) | int(c)
            comp = np.float32(oracle_complexity(code, k))
            low = bool(comp >= thr)  # NaN (k==2) -> False
            if not low and code not in forbidden:
                count[code] = count.get(code, 0) + 1
    return count, had_n


def oracle_sort_compare_count(
    counter: dict[int, int], k: int
) -> list[tuple[int, int]]:
    """CompareCount total order (approx_counter.cpp:275-305).

    count desc, complexity asc (float32 equality), code desc.  NaN
    complexity (k==2): both comparator branches are False in the reference
    (unspecified tie order); here ties fall to code desc -- the framework's
    documented deterministic refinement.
    """
    def key(item):
        code, cnt = item
        comp = oracle_complexity(code, k)
        if np.isnan(comp):
            comp = 0.0
        return (-cnt, comp, -code)

    return sorted(counter.items(), key=key)


def oracle_get_most_frequent(
    counter: dict[int, int], limit: int, k: int
) -> list[tuple[int, int]]:
    return oracle_sort_compare_count(counter, k)[:limit]


def oracle_get_solid_kmers(
    counter: dict[int, int], solid_km: int, k: int
) -> list[tuple[int, int]]:
    """get_solid_kmers (approx_counter.cpp:372-388), with the framework's
    CompareCount order in place of the reference's unspecified tie order."""
    return [x for x in oracle_sort_compare_count(counter, k) if x[1] >= solid_km]


def oracle_dmin(pattern: np.ndarray, text: np.ndarray) -> int:
    """Min semi-global edit distance of ``pattern`` vs any substring of
    ``text`` (Sellers DP: first row zero, min over last row).

    Symbols >= 4 (N / pad) match nothing, mirroring Dna5 'N' never matching
    an ACGT needle char under SeqAn EditDistance.
    """
    kk = len(pattern)
    prev = np.zeros(len(text) + 1, dtype=np.int64)
    best = kk if len(text) >= 0 else kk
    cur = np.empty_like(prev)
    for i in range(1, kk + 1):
        cur[0] = i
        pi = pattern[i - 1]
        for j in range(1, len(text) + 1):
            sub = prev[j - 1] + (0 if (pi == text[j - 1] and pi < 4) else 1)
            cur[j] = min(sub, prev[j] + 1, cur[j - 1] + 1)
        prev, cur = cur, prev
    best = int(prev.min()) if kk > 0 else 0
    return best


def oracle_exact_error_levels(
    pattern: np.ndarray, text: np.ndarray, maxerr: int = 2
) -> set[int]:
    """The set of e in [0, maxerr] such that an alignment of the full
    pattern against some substring of ``text`` with *exactly* e edit
    operations exists.

    This is the mathematically precise version of what the reference's
    per-error-level bit fields record (approx_counter.cpp:556-586): SeqAn
    search schemes enumerate alignments stratified by error count.  Used to
    validate the Σ max(0, 3 - d_min) closed form (SURVEY.md §3C).

    DP over (pattern pos, text pos, exact errors used).
    """
    kk, L = len(pattern), len(text)
    # reach[i][j][e]: pattern[:i] aligns ending at text pos j using exactly e.
    reach = np.zeros((kk + 1, L + 1, maxerr + 1), dtype=bool)
    reach[0, :, 0] = True  # free start, zero errors consumed
    for i in range(1, kk + 1):
        pi = pattern[i - 1]
        for j in range(L + 1):
            for e in range(maxerr + 1):
                ok = False
                if j > 0:
                    match = pi == text[j - 1] and pi < 4
                    if match and reach[i - 1, j - 1, e]:
                        ok = True
                    if not ok and e > 0 and reach[i - 1, j - 1, e - 1]:
                        ok = True  # substitution
                    if not ok and e > 0 and reach[i, j - 1, e - 1]:
                        ok = True  # text char deleted (gap in pattern)
                if not ok and e > 0 and reach[i - 1, j, e - 1]:
                    ok = True      # pattern char inserted (gap in text)
                reach[i, j, e] = ok
    return {e for e in range(maxerr + 1) if reach[kk, :, e].any()}


def oracle_error_count(
    windows: list[np.ndarray],
    candidates: list[int],
    k: int,
    maxerr: int = 2,
) -> dict[int, int]:
    """errorCount semantics (approx_counter.cpp:531-601): per candidate, each
    window contributes one count per achievable error level -- the
    Σ max(0, maxerr+1 - d_min) closed form validated by
    ``oracle_exact_error_levels``."""
    out: dict[int, int] = {}
    pats = {}
    for code in candidates:
        pat = np.empty(k, dtype=np.uint8)
        v = code
        for i in range(k - 1, -1, -1):
            pat[i] = v & 3
            v >>= 2
        pats[code] = pat
    for code in candidates:
        total = 0
        for w in windows:
            d = oracle_dmin(pats[code], w)
            total += max(0, maxerr + 1 - d)
        out[code] = total
    return out
