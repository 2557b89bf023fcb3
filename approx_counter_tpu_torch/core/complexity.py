"""DUST-style dimer complexity score.

Port of ``approx_counter_tpu/core/complexity.py``.  Reproduces
``getComplexity`` / ``haveLowComplexity`` (approx_counter.cpp:214-267):
slide a 2-base window over the packed k-mer, histogram the 16 dimer codes,
and score

    s = sum_v v*(v-1) / float32(2*(k-2))

The integer dimer sum is order- and equality-equivalent to the reference's
float32 score for every k in [2, 32] (see the JAX module for the argument),
so the filter and the CompareCount tie-break use the integer sum, and the
float threshold is turned into an integer one on the host
(``lc_sum_threshold``).

k == 2 quirk: the reference divides by zero; 0/0.0f is NaN, so
``haveLowComplexity`` (NaN >= t) is always False and the comparator's
complexity tie-break never fires.  Reproduced: the filter threshold becomes
unreachable and the integer sum is constant 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def adjust_threshold(c_old: float, k_old: int, k_new: int) -> float:
    """approx_counter.cpp:183-186 -- float32 arithmetic like the C++."""
    c_old = np.float32(c_old)
    ratio = np.float32(
        np.power(np.float64(k_new - 2 + 1), 2) / np.power(np.float64(k_old - 2 + 1), 2)
    )
    return float(np.float32(c_old * ratio))


def max_dimer_sum(k: int) -> int:
    """Largest possible sum_v v*(v-1): all k-1 dimers identical."""
    return (k - 1) * (k - 2)


@functools.lru_cache(maxsize=None)
def score_table(k: int) -> np.ndarray:
    """Exact-IEEE f32 score for every possible integer dimer sum.

    ``score_table(k)[s] == float32(s) / float32(2*(k-2))`` computed on host
    with correctly-rounded IEEE division.  For k == 2 every entry is NaN.
    """
    s = np.arange(max_dimer_sum(k) + 1, dtype=np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        return (s / np.float32(2 * (k - 2))).astype(np.float32)


def lc_sum_threshold(threshold: float, k: int) -> int:
    """Smallest integer dimer sum s with f32(s / (2(k-2))) >= threshold.

    Filtering then reduces to the integer compare ``s >= s_thr``,
    bit-equivalent to the reference's float compare.  Returns s_max+1 when
    nothing can be rejected (k == 2 NaN quirk, or threshold above range).
    """
    tbl = score_table(k)
    hits = np.nonzero(tbl >= np.float32(threshold))[0]
    return int(hits[0]) if len(hits) else max_dimer_sum(k) + 1


def dimer_sum(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Integer sum_v v*(v-1) over the 16-dimer histogram, for int64 codes.

    Dimer j (from the low end, matching the reference's ``kmer & 15;
    kmer >>= 2`` loop) spans bits [2j, 2j+4).  sum_v v*(v-1) is the number
    of ordered equal dimer pairs, counted here as twice the C(k-1, 2)
    unordered pairwise compares.  Returns int32 of the codes' shape.
    """
    dimers = [((codes >> (2 * j)) & 15).to(torch.int8) for j in range(k - 1)]
    acc = torch.zeros(codes.shape, dtype=torch.int32, device=codes.device)
    for i in range(k - 1):
        for j in range(i + 1, k - 1):
            acc += dimers[i] == dimers[j]
    return acc * 2


def dimer_sum_np(codes: np.ndarray, k: int) -> np.ndarray:
    """NumPy host-side twin of :func:`dimer_sum` over uint64 codes."""
    codes = np.asarray(codes, dtype=np.uint64)
    counts = np.zeros(codes.shape + (16,), dtype=np.int64)
    v = codes.copy()
    for _ in range(k - 1):
        d = (v & np.uint64(15)).astype(np.int64)
        np.put_along_axis(
            counts, d[..., None], np.take_along_axis(counts, d[..., None], -1) + 1, -1
        )
        v >>= np.uint64(2)
    return np.sum(counts * (counts - 1), axis=-1)


def complexity_score(codes: torch.Tensor, k: int) -> torch.Tensor:
    """float32 DUST score per int64 code, bit-exact against the C++ float:
    ``score_table(k)`` (host IEEE divisions) looked up at ``dimer_sum``."""
    table = torch.from_numpy(score_table(k)).to(codes.device)
    return table[dimer_sum(codes, k).long()]


def complexity_score_np(codes: np.ndarray, k: int) -> np.ndarray:
    """NumPy host-side twin of :func:`complexity_score` over uint64 codes."""
    return score_table(k)[dimer_sum_np(codes, k)]


def have_low_complexity(codes: torch.Tensor, k: int,
                        threshold: float) -> torch.Tensor:
    """Boolean low-complexity test per int64 code: score >= threshold ==>
    reject.

    Matches ``haveLowComplexity`` (approx_counter.cpp:214-234) including the
    k == 2 never-rejects NaN quirk.
    """
    return dimer_sum(codes, k) >= lc_sum_threshold(threshold, k)
