"""The fixed-cap ``--from-exact`` step and the one-fetch rule on the CPU.

``candidates_from_codes`` against the JAX package's at lengths 0 to 3,000
and with repeats; ``Engine.approx_stage``, the resume pass at the fixed
cap, against the JAX ``Engine.approx_stage`` at k 12/16/32 and maxerr 0-3
(exact: integer counts); and, with ``Tensor.item``, ``tolist``, ``cpu`` and
``numpy`` made to raise, a fused pass, a cap-regrowing solid pass and a
resume pass each reach the host through their one fetch per run only.  The
sharded step's own cases run on gloo ranks in
``tests/test_torch_exact_sharded.py``.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu.core.codec import join_code  # noqa: E402
from approx_counter_tpu.params import Params as JaxParams  # noqa: E402
from approx_counter_tpu.pipeline import Engine as JaxEngine  # noqa: E402
from approx_counter_tpu.pipeline import (  # noqa: E402
    candidates_from_codes as jax_candidates_from_codes,
)
from approx_counter_tpu_torch import pipeline  # noqa: E402
from approx_counter_tpu_torch.params import Params  # noqa: E402
from approx_counter_tpu_torch.pipeline import (  # noqa: E402
    Engine,
    candidates_from_codes,
)
from test_torch_pipeline import jax_numpy_paths  # noqa: E402,F401

N_ROWS, M, N_VALID = 64, 41, 57


def _windows(seed: int) -> np.ndarray:
    """uint8 [N_ROWS, M]: random bases, ~1% N, a pad column on every fifth
    row, a 30-base repeat on every third row."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 4, (N_ROWS, M)).astype(np.uint8)
    w[rng.random((N_ROWS, M)) < 0.01] = 4
    w[::5, -1] = 5
    w[::3, 5:35] = rng.integers(0, 4, 30).astype(np.uint8)
    return w


def _codes(w: np.ndarray, k: int, n: int, seed: int) -> np.ndarray:
    """``n`` uint64 codes of k-mers: half read off the rows (an N read as
    T), so their counts are above zero, half at random, then the first two
    repeated."""
    rng = np.random.default_rng(seed)
    seen = [int("".join(map(str, np.minimum(w[r, 2:2 + k], 3))), 4)
            for r in range(n // 2)]
    rand = rng.integers(0, 1 << min(2 * k, 63), n - len(seen),
                        dtype=np.uint64)
    codes = np.concatenate([np.array(seen, np.uint64), rand])
    return np.concatenate([codes, codes[:2]])


@pytest.mark.parametrize("n", [0, 1, 127, 128, 500, 3000, "repeats"])
def test_candidates_from_codes_match_jax(n):
    """The padded list: the codes (repeats kept) then code 0, the mask of
    the real ones, and the cap ``max(512, round_up(len, 128))``."""
    rng = np.random.default_rng(5)
    if n == "repeats":
        codes = rng.integers(0, 1 << 63, 40, dtype=np.uint64) | np.uint64(
            1 << 63)
        codes = np.concatenate([codes, codes[::3], codes[:1]])
    else:
        codes = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    sel_codes, sel_valid, cap = candidates_from_codes(codes)
    sel_hi, sel_lo, want_valid, want_cap = jax_candidates_from_codes(codes)
    assert cap == want_cap
    np.testing.assert_array_equal(sel_codes, join_code(sel_hi, sel_lo))
    np.testing.assert_array_equal(sel_valid, want_valid)
    assert sel_codes.dtype == np.uint64 and len(sel_codes) == cap


@pytest.mark.parametrize("maxerr", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [12, 16, 32])
def test_fixed_cap_approx_stage_matches_jax(k, maxerr):
    """``Engine.approx_stage`` (the resume pass at the fixed cap of
    ``candidates_from_codes``) returns the JAX engine's ranking, cut to
    ``limit``, repeats side by side."""
    w = _windows(k + maxerr)
    codes = _codes(w, k, 60, k * 10 + maxerr)
    prm = dict(k=k, sl=M - 1, limit=40, max_error=maxerr)
    want = JaxEngine(JaxParams(**prm), use_pallas=False).approx_stage(
        w, N_VALID, *jax_candidates_from_codes(codes))
    engine = Engine(Params(**prm), "cpu")
    try:
        got = engine.approx_stage(w, N_VALID, codes)
    finally:
        engine.close()
    assert len(got[0]) == prm["limit"]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].max() > 0


@contextlib.contextmanager
def host_syncs_raise(fetches: list):
    """``Tensor.item``, ``tolist``, ``cpu`` and ``numpy`` raise inside the
    block, except within ``pipeline._fetch``, which appends the fetched
    array's length to ``fetches``."""
    names = ("item", "tolist", "cpu", "numpy")
    saved = {name: getattr(torch.Tensor, name) for name in names}
    fetch = pipeline._fetch

    def refuse(name):
        def method(self, *a, **kw):
            raise AssertionError(f"Tensor.{name} before the pass's fetch")
        return method

    def allowed(t):
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
        try:
            out = fetch(t)
        finally:
            for name in names:
                setattr(torch.Tensor, name, refuse(name))
        fetches.append(out.size)
        return out

    for name in names:
        setattr(torch.Tensor, name, refuse(name))
    pipeline._fetch = allowed
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
        pipeline._fetch = fetch


@pytest.mark.parametrize("mode", ["fused", "solid_regrowth", "resume"])
def test_pass_bodies_reach_the_host_only_through_their_fetch(mode):
    """Each run of a pass body fetches once and makes no other host sync:
    the fused pass one fetch, a solid pass whose n_keep outgrows the first
    cap two (one a cap), the resume pass one."""
    w = _windows(3)
    prm = Params(k=12, sl=M - 1, limit=30,
                 solid_km=1 if mode == "solid_regrowth" else 0)
    engine = Engine(prm, "cpu")
    windows_t, row_mask = engine.device_windows(w, N_VALID)
    cand = engine._candidates(_codes(w, 12, 60, 1))
    want = (engine._resume(windows_t, row_mask, *cand) if mode == "resume"
            else engine._count(windows_t, row_mask))
    fetches: list = []
    try:
        with host_syncs_raise(fetches):
            got = (engine._resume(windows_t, row_mask, *cand)
                   if mode == "resume" else engine._count(windows_t,
                                                          row_mask))
    finally:
        engine.close()
    assert len(fetches) == (2 if mode == "solid_regrowth" else 1)
    for a, b in zip(got[:2], want[:2]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    if mode == "solid_regrowth":
        assert got[2]["n_keep"] > 512
