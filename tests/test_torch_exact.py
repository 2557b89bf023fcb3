"""The port's exact counting, selection and re-rank vs the JAX package's.

Both packages get the same numpy-seeded ``[m, W]`` windows; the port's
inputs are converted by ``approx_counter_tpu_torch.interop``.  Every field
is an integer, compared exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu.core.codec import join_code, split_code  # noqa: E402
from approx_counter_tpu.core.complexity import (  # noqa: E402
    adjust_threshold,
    dimer_sum_np,
    lc_sum_threshold,
)
from approx_counter_tpu.count.approx import (  # noqa: E402
    rank_with_zero_counts as j_rank,
)
from approx_counter_tpu.count.exact import exact_count_select_rows  # noqa: E402
from approx_counter_tpu_torch import interop  # noqa: E402
from approx_counter_tpu_torch.core.complexity import dimer_sum  # noqa: E402
from approx_counter_tpu_torch.count.approx import rank_with_zero_counts  # noqa: E402
from approx_counter_tpu_torch.count.exact import exact_count_select  # noqa: E402

CAP = 512


def _windows(seed, n=64, m=41, pair=(0, 3)):
    """Tie-heavy ``[m, n]`` windows: rows drawn from 6 templates (two of
    them over the two bases ``pair`` only, A/T by default) with a few
    substitutions, some Ns, two poly-A rows, a trailing pad column on half
    the rows and 5 all-pad invalid rows."""
    rng = np.random.default_rng(seed)
    templates = rng.integers(0, 4, (6, m))
    templates[:2] = np.asarray(pair)[rng.integers(0, 2, (2, m))]  # repeats
    wins = templates[rng.integers(0, 6, n)].astype(np.uint8)
    subs = rng.random((n, m)) < 0.04
    wins[subs] = rng.integers(0, 4, int(subs.sum()))
    wins[rng.random((n, m)) < 0.01] = 4
    wins[3] = 0
    wins[17] = 0
    wins[::2, -1] = 5
    row_mask = np.ones(n, bool)
    row_mask[-5:] = False
    wins[-5:] = 5
    return np.ascontiguousarray(wins.T), row_mask


def _jax_select(wins_t, row_mask, k, lc_thr, forbidden, limit):
    fhi, flo = split_code(forbidden)
    ex = exact_count_select_rows(
        wins_t, row_mask, k, np.int32(lc_thr), fhi, flo, np.int32(limit),
        np.int32(0), cap=CAP, n_forbidden=len(forbidden), use_solid=False,
        transposed=True,
    )
    n_keep = int(ex["n_keep"])
    return dict(
        codes=join_code(np.asarray(ex["sel_hi"])[:n_keep],
                        np.asarray(ex["sel_lo"])[:n_keep]),
        counts=np.asarray(ex["sel_count"])[:n_keep].astype(np.uint64),
        n_unique=int(ex["n_unique"]), n_pass=int(ex["n_pass"]),
        n_keep=n_keep, had_n=int(ex["had_n"]),
    )


@pytest.mark.parametrize("k", [2, 8, 16, 17, 24, 31, 32])
@pytest.mark.parametrize("param_lc", [0.5, 2.0])
@pytest.mark.parametrize("with_forbidden", [False, True])
def test_exact_count_select_matches_jax(k, param_lc, with_forbidden):
    """k > 16 takes G/T-rich windows: at k = 32 half the codes have bit 63
    set, negative as int64, and the code tie-break must stay unsigned."""
    wins_t, row_mask = _windows(10 * k + int(with_forbidden),
                                pair=(2, 3) if k > 16 else (0, 3))
    lc_thr = lc_sum_threshold(adjust_threshold(param_lc, 16, k), k)
    limit = 40
    forbidden = np.empty(0, np.uint64)
    if with_forbidden:  # two selected codes and one never seen
        first = _jax_select(wins_t, row_mask, k, lc_thr, forbidden, limit)
        forbidden = np.array(
            sorted({int(first["codes"][0]), int(first["codes"][-1]),
                    (1 << (2 * k)) - 2}), np.uint64)
    want = _jax_select(wins_t, row_mask, k, lc_thr, forbidden, limit)

    got = exact_count_select(
        interop.windows_to_torch(wins_t), interop.mask_to_torch(row_mask), k,
        lc_thr, torch.from_numpy(forbidden.view(np.int64)), limit,
    )
    assert want["n_keep"] > 0
    for key in ("n_unique", "n_pass", "n_keep", "had_n"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(
        got["sel_codes"].numpy().view(np.uint64), want["codes"])
    np.testing.assert_array_equal(
        got["sel_counts"].numpy().astype(np.uint64), want["counts"])


@pytest.mark.parametrize("n_rows", [0, 6])
def test_exact_stage_counts_the_int64_max_code(n_rows):
    """At k = 32 the code C T^31 is INT64_MAX (and T^32 is -1): ``n_rows``
    windows hold it among Ns, pads and invalid rows, and it is counted and
    selected as the JAX package counts and selects it."""
    k, m = 32, 41
    wins_t, row_mask = _windows(77, m=m, pair=(2, 3))
    wins = np.ascontiguousarray(wins_t.T)
    wins[:n_rows] = 3
    wins[:n_rows, 0] = 1
    wins_t = np.ascontiguousarray(wins.T)
    lc_thr = 1 << 30  # no code is low-complexity: poly-T stays in
    want = _jax_select(wins_t, row_mask, k, lc_thr, np.empty(0, np.uint64), 40)
    got = exact_count_select(
        interop.windows_to_torch(wins_t), interop.mask_to_torch(row_mask), k,
        lc_thr, torch.empty(0, dtype=torch.int64), 40)
    for key in ("n_unique", "n_pass", "n_keep", "had_n"):
        assert got[key] == want[key], key
    codes = got["sel_codes"].numpy()
    np.testing.assert_array_equal(codes.view(np.uint64), want["codes"])
    np.testing.assert_array_equal(
        got["sel_counts"].numpy().astype(np.uint64), want["counts"])
    assert (np.iinfo(np.int64).max in codes) == bool(n_rows)


@pytest.mark.parametrize("k", range(2, 33))
def test_dimer_sum_matches_numpy(k):
    """At k = 32 the last dimer spans bits 60-63, read through an
    arithmetic shift of a negative int64: the & 15 mask keeps it right."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 1 << (2 * k), 500, dtype=np.uint64)
    codes[:3] = [0, (1 << (2 * k)) - 1, int("01" * k, 2)]  # poly-A, -T, -C
    want = dimer_sum_np(codes, k)
    got = dimer_sum(torch.from_numpy(codes.view(np.int64)), k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,n", [(2, 12), (8, 40), (16, 40), (17, 40),
                                 (24, 40), (31, 40), (32, 40)])
def test_rank_with_zero_counts_matches_jax(k, n):
    rng = np.random.default_rng(n + k)
    if k <= 16:
        codes = rng.choice(1 << (2 * k), n, replace=False).astype(np.uint64)
        counts = rng.integers(0, 4, n).astype(np.int32)  # ties and zeros
    else:
        # pairs c, c ^ 0b1010...: bit 1 of every base flipped (A<->G,
        # C<->T) keeps the dimer histogram's shape, so each pair ties on
        # count and dimer sum and only the unsigned code order splits it --
        # at k = 32 one code of each pair has bit 63 set
        half = rng.integers(0, 1 << (2 * k), n // 2, dtype=np.uint64)
        flip = np.uint64(int("10" * k, 2))
        codes = np.concatenate([half, half ^ flip])
        counts = np.tile(rng.integers(0, 4, n // 2), 2).astype(np.int32)
        assert len(np.unique(codes)) == n
    counts[:2] = 0
    cap = 64
    hi, lo = split_code(codes)
    sel_hi, sel_lo = np.zeros(cap, np.uint32), np.zeros(cap, np.uint32)
    sel_hi[:n], sel_lo[:n] = hi, lo
    cnt = np.zeros(cap, np.int32)
    cnt[:n] = counts
    o_hi, o_lo, o_cnt, o_val = map(np.asarray, j_rank(
        sel_hi, sel_lo, cnt, np.arange(cap) < n, k))
    assert int(o_val.sum()) == n

    got_codes, got_counts = rank_with_zero_counts(
        interop.codes_to_torch(hi, lo), torch.from_numpy(counts), k)
    np.testing.assert_array_equal(
        got_codes.numpy().view(np.uint64), join_code(o_hi[:n], o_lo[:n]))
    np.testing.assert_array_equal(got_counts.numpy(), o_cnt[:n])
