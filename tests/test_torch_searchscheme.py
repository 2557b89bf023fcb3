"""The port's search-scheme enumerator vs the JAX package's, and the port's
approximate counts vs the enumerator.

``approx_counter_tpu_torch/searchscheme.py`` is a copy of the JAX package's
module.  The first 37 tests mirror ``tests/test_searchscheme.py`` case for
case, on the same seeded fixtures (the conftest's ``rng``): the port's copy
must give the JAX module's scheme checks, level sets and totals exactly, and
the closed form and stratum DP of the port's oracle.  Then every
approximate-count wrapper on the CPU (its plain version) and every plain
version must equal ``search_scheme_error_count`` on the adversarial windows
of ``gpu_check.searchscheme_case`` at k in {2, 8, 16, 32} x maxerr 0-3.
Counts are integers: every comparison is exact.

The ``cuda`` test holds the four CUDA kernels to the enumerator on the
card.  The GPU host has no JAX, so this file imports the JAX package only
through fixtures; run it there with
``python -m pytest --noconftest -m cuda tests/test_torch_searchscheme.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu_torch import gpu_check, oracle  # noqa: E402
from approx_counter_tpu_torch import searchscheme as ss  # noqa: E402
from approx_counter_tpu_torch.kernels import bpm  # noqa: E402


@pytest.fixture
def jss():
    """The JAX package's searchscheme module (the GPU host has no JAX)."""
    return pytest.importorskip("approx_counter_tpu.searchscheme")


def _levels(jss, pat, txt, maxerr):
    """The port's level set, after checking it equals the JAX module's,
    the closed form and the stratum DP of the port's oracle."""
    got = ss.search_scheme_levels(pat, txt, maxerr)
    d = oracle.oracle_dmin(pat, txt)
    closed = set(range(d, maxerr + 1)) if d <= maxerr else set()
    strata = oracle.oracle_exact_error_levels(pat, txt, maxerr)
    want = jss.search_scheme_levels(pat, txt, maxerr)
    assert got == want == closed == strata, (
        maxerr, pat.tolist(), txt.tolist(), got, want, closed, strata)
    return got


class TestSchemeTables:
    def test_connected_orders(self, jss):
        assert ({K: [(s.pi, s.L, s.U) for s in v] for K, v in ss.SCHEMES.items()}
                == {K: [(s.pi, s.L, s.U) for s in v]
                    for K, v in jss.SCHEMES.items()})
        for scheme in ss.SCHEMES.values():
            for s in scheme:
                assert ss.connected(s.pi) and jss.connected(s.pi), s
        assert not ss.connected((1, 3, 2)) and not jss.connected((1, 3, 2))

    @pytest.mark.parametrize("K", [0, 1, 2, 3])
    def test_error_distribution_coverage(self, K, jss):
        assert ss.scheme_covers(ss.SCHEMES[K], K)
        assert jss.scheme_covers(jss.SCHEMES[K], K)
        assert ss._scheme_for(K) == ss.SCHEMES[K]

    def test_k2_single_searches_insufficient(self, jss):
        for s, js in zip(ss.SCHEMES[2], jss.SCHEMES[2]):
            assert not ss.scheme_covers((s,), 2), s
            assert not jss.scheme_covers((js,), 2), js

    def test_split_pieces(self, jss):
        assert ss.split_pieces(16, 3) == [(0, 6), (6, 11), (11, 16)]
        assert ss.split_pieces(2, 3) == [(0, 1), (1, 2), (2, 2)]
        assert ss.split_pieces(32, 4) == [(0, 8), (8, 16), (16, 24), (24, 32)]
        for k in range(1, 33):
            for P in range(1, 5):
                assert ss.split_pieces(k, P) == jss.split_pieces(k, P)
                for s, js in zip(ss.SCHEMES[P - 1], jss.SCHEMES[P - 1]):
                    pieces = ss.split_pieces(k, P)
                    assert ss._schedule(s, pieces) == jss._schedule(js, pieces)


class TestLevelSets:
    @pytest.mark.parametrize("maxerr", [0, 1, 2, 3])
    @pytest.mark.parametrize("k", [2, 3, 5, 8, 16])
    def test_random_differential(self, k, maxerr, rng, jss):
        for trial in range(12):
            pat = rng.integers(0, 4, k).astype(np.uint8)
            L = int(rng.integers(k, 28))
            txt = rng.integers(0, 5, L).astype(np.uint8)
            if trial % 3 == 0:
                pos = 0 if trial % 6 == 0 else int(rng.integers(0, L - k + 1))
                txt[pos:pos + k] = pat
            _levels(jss, pat, txt, maxerr)

    def test_k32_split_code_boundary(self, rng, jss):
        pat = rng.integers(0, 4, 32).astype(np.uint8)
        txt = rng.integers(0, 4, 40).astype(np.uint8)
        txt[5:37] = pat
        txt[20] = (txt[20] + 1) % 4
        assert _levels(jss, pat, txt, 2) == {1, 2}

    @pytest.mark.parametrize("maxerr", [1, 2, 3])
    def test_window_shorter_than_pattern(self, maxerr, rng, jss):
        pat = rng.integers(0, 4, 5).astype(np.uint8)
        got = _levels(jss, pat, pat[:3].copy(), maxerr)
        assert (2 in got) == (maxerr >= 2)

    def test_all_n_window(self, jss):
        pat = np.array([0, 1, 2, 3], dtype=np.uint8)
        txt = np.full(12, 4, dtype=np.uint8)
        for maxerr in (0, 2, 3):
            assert _levels(jss, pat, txt, maxerr) == set()

    @pytest.mark.parametrize("k", [2, 3])
    def test_degenerate_k_le_maxerr(self, k, rng, jss):
        pat = rng.integers(0, 4, k).astype(np.uint8)
        txt = np.full(6, (pat[0] + 1) % 4, dtype=np.uint8)
        assert min(_levels(jss, pat, txt, 3)) <= k

    def test_exact_match_yields_all_levels(self, rng, jss):
        pat = rng.integers(0, 4, 8).astype(np.uint8)
        txt = np.concatenate([pat, rng.integers(0, 4, 6).astype(np.uint8)])
        assert _levels(jss, pat, txt, 2) == {0, 1, 2}


def _code_pattern(code, k):
    pat = np.empty(k, np.uint8)
    for i in range(k - 1, -1, -1):
        pat[i] = code & 3
        code >>= 2
    return pat


class TestErrorCountEquivalence:
    def test_error_count_matches_closed_form(self, rng, jss):
        k, n_win, n_cand = 6, 8, 5
        windows = [rng.integers(0, 5, int(rng.integers(k, 20))).astype(np.uint8)
                   for _ in range(n_win)]
        cands = [int(c) for c in rng.integers(0, 1 << (2 * k), n_cand)]
        for w in windows[::2]:
            w[:k] = _code_pattern(cands[0], k)
        for maxerr in (0, 2):
            got = ss.search_scheme_error_count(windows, cands, k, maxerr)
            assert got == jss.search_scheme_error_count(windows, cands, k,
                                                        maxerr)
            assert got == oracle.oracle_error_count(windows, cands, k, maxerr)

    def test_error_count_matches_kernel(self, rng, jss):
        """The totals == the port's plain counts on a dense batch; the
        port's copy takes the codes as an int64 tensor."""
        k, W, m = 8, 12, 20
        codes = rng.integers(0, 1 << (2 * k), 6, dtype=np.uint64)
        wins = rng.integers(0, 5, (W, m)).astype(np.uint8)
        codes_t = torch.from_numpy(codes.view(np.int64))
        got = bpm.approx_counts_ref(
            bpm.build_peq(codes_t, k), torch.from_numpy(wins.T.copy()),
            torch.ones(W, dtype=torch.bool), k, maxerr=2)
        texts = [wins[i] for i in range(W)]
        port = ss.search_scheme_error_count(texts, codes_t, k, 2)
        jax = jss.search_scheme_error_count(texts, [int(c) for c in codes],
                                            k, 2)
        assert [port[int(c)] for c in codes_t] == got.tolist()
        assert [jax[int(c)] for c in codes] == got.tolist()


def _oracle_counts(codes, windows_t, valid, k, maxerr, module=ss):
    """search_scheme_error_count over the valid windows, in code order."""
    texts = [windows_t[:, w] for w in np.flatnonzero(valid)]
    got = module.search_scheme_error_count(texts, codes, k, maxerr)
    return [got[int(c)] for c in codes]


@pytest.mark.parametrize("maxerr", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [2, 8, 16, 32])
def test_plain_counts_match_search_scheme(k, maxerr, jss):
    """Every wrapper on the CPU and every plain version == the enumerator
    (the port's copy == the JAX module, uint64 codes there) on windows
    with edge occurrences, short prefixes, all-N and invalid windows."""
    codes, wins_t, valid = gpu_check.searchscheme_case(
        np.random.default_rng(100 * k + maxerr), 8, 24, 36, k)
    want = _oracle_counts(codes, wins_t, valid, k, maxerr)
    assert want == _oracle_counts(codes.view(np.uint64), wins_t, valid, k,
                                  maxerr, jss)
    assert sum(want) > 0
    args = (bpm.build_peq(torch.from_numpy(codes), k),
            torch.from_numpy(wins_t), torch.from_numpy(valid), k, maxerr)
    runs = gpu_check.kernel_runs(k)
    assert {name for name, _, _ in runs} >= {"sliced", "myers"}
    for name, wrapper, plain in runs:
        assert wrapper(*args).tolist() == want, name
        assert plain(*args).tolist() == want, name


@pytest.mark.cuda
def test_cuda_kernels_match_search_scheme():
    """The CUDA kernels == the enumerator on the card, at k = 2, 16, 32
    and maxerr 3, 2, 3; every kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    for k, maxerr in ((2, 3), (16, 2), (32, 3)):
        codes, wins_t, valid = gpu_check.searchscheme_case(
            np.random.default_rng(k), 8, 32, 40, k)
        want = _oracle_counts(codes, wins_t, valid, k, maxerr)
        args = (bpm.build_peq(torch.from_numpy(codes).cuda(), k),
                torch.from_numpy(wins_t).cuda(),
                torch.from_numpy(valid).cuda(), k, maxerr)
        before = (bpm.approx_counts.launches, bpm.approx_counts_myers.launches,
                  dict(bpm.approx_counts_packed.launches))
        for name, wrapper, _ in gpu_check.kernel_runs(k):
            assert wrapper(*args).tolist() == want, (k, maxerr, name)
        assert bpm.approx_counts.launches > before[0]
        assert bpm.approx_counts_myers.launches > before[1]
        for algo in ("myers", "nfa"):
            if k <= 16:
                assert bpm.approx_counts_packed.launches[algo] > before[2][algo]
