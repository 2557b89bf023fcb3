"""The port's copy of the oracle vs the JAX package's, and ``gpu_check`` on
the CPU.

``approx_counter_tpu_torch/oracle.py`` is the JAX package's numpy oracle with
the port's codec import (the GPU host has no JAX); every public function
must give the same answer on the same seeded inputs.  ``gpu_check.run`` on
the CPU drives every check through the plain versions, so each row must be
OK there too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu import oracle as jax_oracle  # noqa: E402
from approx_counter_tpu_torch import oracle  # noqa: E402


def _texts(seed, n=12, lo=10, hi=30):
    """Windows of symbols 0-3 with some N (4), from a seed."""
    rng = np.random.default_rng(seed)
    texts = []
    for _ in range(n):
        t = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
        t[rng.random(len(t)) < 0.05] = 4
        texts.append(t)
    texts[1] = texts[0].copy()  # repeated k-mers
    return texts


@pytest.mark.parametrize("k", [2, 5, 8, 17, 32])
def test_complexity_and_ordering_match(k):
    rng = np.random.default_rng(k)
    codes = [int(c) for c in rng.integers(0, 1 << (2 * k), 60, dtype=np.uint64)]
    codes += [0, (1 << (2 * k)) - 1]
    for c in codes:
        a, b = oracle.oracle_complexity(c, k), jax_oracle.oracle_complexity(c, k)
        assert a == b or (np.isnan(a) and np.isnan(b))
    counter = {c: int(n) for c, n in zip(codes, rng.integers(1, 4, len(codes)))}
    assert (oracle.oracle_sort_compare_count(counter, k)
            == jax_oracle.oracle_sort_compare_count(counter, k))
    assert (oracle.oracle_get_most_frequent(counter, 25, k)
            == jax_oracle.oracle_get_most_frequent(counter, 25, k))
    assert (oracle.oracle_get_solid_kmers(counter, 2, k)
            == jax_oracle.oracle_get_solid_kmers(counter, 2, k))


@pytest.mark.parametrize("k,lc", [(4, 0.8), (8, 1.0), (17, 3.0)])
def test_count_kmers_matches(k, lc):
    texts = _texts(k)
    forbidden = {0, 5, (1 << (2 * k)) - 1}
    got = oracle.oracle_count_kmers(texts, k, lc, forbidden)
    assert got == jax_oracle.oracle_count_kmers(texts, k, lc, forbidden)
    assert got[1] > 0  # N-containing k-mers were seen


def test_dmin_and_error_levels_match():
    rng = np.random.default_rng(3)
    for _ in range(20):
        pat = rng.integers(0, 4, int(rng.integers(2, 7))).astype(np.uint8)
        text = rng.integers(0, 5, int(rng.integers(0, 12))).astype(np.uint8)
        assert oracle.oracle_dmin(pat, text) == jax_oracle.oracle_dmin(pat, text)
        assert (oracle.oracle_exact_error_levels(pat, text, 3)
                == jax_oracle.oracle_exact_error_levels(pat, text, 3))


@pytest.mark.parametrize("maxerr", [0, 1, 2, 3])
def test_error_count_matches(maxerr):
    k = 6
    texts = _texts(40 + maxerr, n=8, lo=8, hi=20)
    rng = np.random.default_rng(maxerr)
    cands = [int(c) for c in rng.integers(0, 1 << (2 * k), 10, dtype=np.uint64)]
    got = oracle.oracle_error_count(texts, cands, k, maxerr)
    assert got == jax_oracle.oracle_error_count(texts, cands, k, maxerr)


def test_gpu_check_rows_all_ok_on_cpu():
    from approx_counter_tpu_torch import gpu_check

    rows = gpu_check.run(device="cpu")
    assert [name for name, ok in rows if not ok] == []
    names = [name for name, _ in rows]
    assert len(names) == len(set(names))
    # 20 (k, maxerr) configs x (sliced, myers, packed), exact stage, 4
    # whole passes (top-N and solid), the resume pass, the multihost step,
    # the window upload's round trips, the pool passes
    assert sum("nfa-p1 " in n for n in names) == 20
    assert sum("myers-p4" in n for n in names) == 8   # k in {2, 8}
    assert sum("nfa-p16" in n for n in names) == 4    # k = 2
    assert names[-14:] == ["exact stage k= 8 vs oracle",
                           "whole pass k= 8 top-N vs oracle",
                           "whole pass k=17 top-N vs oracle",
                           "whole pass k= 8 -sk 2 vs oracle",
                           "whole pass k=17 -sk 2 vs oracle",
                           "resume pass k= 9 (a repeated code) vs oracle",
                           "mesh full step (all-reduced counts) vs oracle",
                           "sparse-N window unpack round trip",
                           "dense window unpack round trip",
                           "transposed sparse unpack round trip",
                           "device_windows sparse upload round trip",
                           "device_windows dense upload round trip",
                           "pool-path pass end=0 vs oracle",
                           "pool-path pass end=1 vs oracle"]
