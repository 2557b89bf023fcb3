"""The port's fused pass on the CPU vs the JAX package's ``_fused_fn``.

The same seeded numpy windows (padding rows past ``n_valid`` that hold real
bases, N symbols, a pad column on some rows, planted repeats) go through
the JAX ``Engine(prm, use_pallas=False)._fused_fn(cap, m, "raw",
packed_out=True)`` and the port's fixed-shape pass, which runs eagerly on
the CPU (``Engine._pass_output``).  Equal: the four head scalars, each
block's first ``n_keep`` entries and both validity blocks over the whole
``cap``.  Then the cap regrowth of solid mode against the JAX engine's
``count_one_end``, ``_topk_rank`` against a full sort on a tie class larger
than ``cap``, ``_suffix_min`` against a one-level reverse ``cummin``, and
``exact_count_select_rows`` against the eager ``exact_count_select`` on the
kept prefix.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu.params import Params as JaxParams  # noqa: E402
from approx_counter_tpu.pipeline import Engine as JaxEngine  # noqa: E402
from approx_counter_tpu_torch.core.complexity import (  # noqa: E402
    lc_sum_threshold,
)
from approx_counter_tpu_torch.count.exact import (  # noqa: E402
    _I64_MAX,
    SCAN_ROWS,
    _sort2,
    _suffix_min,
    _topk_rank,
    exact_count_select,
    exact_count_select_rows,
)
from approx_counter_tpu_torch.params import Params  # noqa: E402
from approx_counter_tpu_torch.pipeline import (  # noqa: E402
    Engine,
    pass_cap,
    unpack_pass_output,
)
from test_torch_pipeline import jax_numpy_paths  # noqa: E402,F401

N_ROWS, M, N_VALID = 64, 41, 57


def _windows(seed: int) -> np.ndarray:
    """uint8 [N_ROWS, M]: random bases, ~1% N, a pad column on every fifth
    row, a 30-base repeat on every third row; rows past N_VALID hold bases
    too, so only the row mask keeps them out."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 4, (N_ROWS, M)).astype(np.uint8)
    w[rng.random((N_ROWS, M)) < 0.01] = 4
    w[::5, -1] = 5
    w[::3, 5:35] = rng.integers(0, 4, 30).astype(np.uint8)
    return w


def _forbid_file(tmp_path, w: np.ndarray, k: int) -> str:
    """A forbidden list past one compare chunk: the repeat's first 12
    k-mers (they would top the ranking) and 12 random ones."""
    rng = np.random.default_rng(99)
    kmers = ["".join("ACGT"[b] for b in w[0, 5 + i:5 + i + k])
             for i in range(12)]
    kmers += ["".join(rng.choice(list("ACGT"), k)) for _ in range(12)]
    path = tmp_path / "forbid.txt"
    path.write_text("\n".join(kmers) + "\n")
    return str(path)


def _both_packed(prm: dict, w: np.ndarray, cap: int):
    """(JAX packed uint32, port packed uint32) of one pass at ``cap``."""
    jax_engine = JaxEngine(JaxParams(**prm), use_pallas=False)
    want = np.asarray(jax_engine._fused_fn(cap, M, "raw", packed_out=True)(
        w, np.int32(N_VALID), *jax_engine._tail_dev()))
    engine = Engine(Params(**prm), "cpu")
    try:
        got = engine._pass_output(cap, torch.from_numpy(w.T.copy()),
                                  torch.arange(N_ROWS) < N_VALID)
    finally:
        engine.close()
    return want, got.view(np.uint32)


CASES = [
    dict(k=3, limit=40),
    dict(k=12, limit=40),
    dict(k=16, limit=40),
    dict(k=17, limit=40, max_error=1),
    dict(k=32, limit=40),
    dict(k=12, limit=40, forbid=True),
    dict(k=16, limit=5000),           # limit above n_pass: cap past P
    dict(k=12, limit=40, solid_km=2),
]


@pytest.mark.parametrize("case", CASES, ids=[
    "k3", "k12", "k16", "k17_maxerr1", "k32", "k12_forbidden",
    "k16_limit_above_n_pass", "k12_solid2"])
def test_fused_pass_matches_jax(tmp_path, case):
    case = dict(case)
    w = _windows(case["k"])
    if case.pop("forbid", False):
        case["forbid_kmer"] = _forbid_file(tmp_path, w, case["k"])
    prm = dict(case, sl=M - 1)
    cap = pass_cap(case["limit"])
    want, got = _both_packed(prm, w, cap)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:4], want[:4])
    n_keep = int(want[1])
    assert 0 < n_keep <= cap
    if "solid_km" not in case and case["limit"] < 1000:
        assert n_keep == case["limit"]
    if case["limit"] == 5000:
        assert n_keep == int(want[3]) < case["limit"]  # every passing k-mer
    for b in range(8 if case["k"] > 16 else 6):
        lim = cap if b in (2, 5) else n_keep  # the two validity blocks
        np.testing.assert_array_equal(got[4 + b * cap:4 + b * cap + lim],
                                      want[4 + b * cap:4 + b * cap + lim],
                                      err_msg=f"block {b}")
    out = unpack_pass_output(got.view(np.int32), cap, case["k"])
    assert int(out["exact"]["n_keep"]) == n_keep
    assert out["exact"]["sel_valid"].sum() == out["approx_valid"].sum()


@pytest.mark.parametrize("k", [12, 17])
def test_solid_pass_regrows_its_cap_to_the_jax_result(k):
    """-sk 1 keeps every passing k-mer, more than the first cap (512): the
    port's pass runs again at n_keep rounded up to 128 and returns what
    the JAX engine's pass returns after its own regrowth."""
    w = _windows(7)
    prm = dict(k=k, sl=M - 1, limit=30, solid_km=1)
    want = JaxEngine(JaxParams(**prm), use_pallas=False).count_one_end(
        w, N_VALID)
    engine = Engine(Params(**prm), "cpu")
    try:
        got = engine.count_one_end(w, N_VALID)
    finally:
        engine.close()
    assert got[2] == want[2]
    assert got[2]["n_keep"] > pass_cap(prm["limit"])
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert len(got[1][0]) == prm["limit"]


@pytest.mark.parametrize("P, cap, n_less, class_size, code0", [
    (4096, 64, 40, 3000, False),    # two-level top-k (R = 64)
    (4099, 64, 10, 3500, False),    # P prime to 2: one flat top-k
    (2048, 64, 30, 20, True),       # class fits: code 0 must win
    (2048, 64, 30, 1500, True),     # class too large: code 0 must lose
])
def test_topk_rank_matches_a_full_sort(P, cap, n_less, class_size, code0):
    """The exact top-``cap`` of (key1, ncode) through two top-k passes
    equals the first ``cap`` of a full two-key sort, where the boundary
    key1 class is larger than ``cap`` (or holds the all-A code, whose ncode
    is the out-of-class fill)."""
    rng = np.random.default_rng(P + class_size)
    key1 = np.empty(P, np.int64)
    key1[:n_less] = rng.choice(1000, n_less, replace=False)   # below kb
    key1[n_less:n_less + class_size] = 5000                   # the kb class
    key1[n_less + class_size:] = rng.integers(6000, 9000,
                                              P - n_less - class_size)
    ncode = rng.choice(1 << 40, P, replace=False).astype(np.int64)
    if code0:
        ncode[n_less + class_size - 1] = _I64_MAX   # code 0 in the class
    perm = rng.permutation(P)
    key1_t, ncode_t = torch.from_numpy(key1[perm]), torch.from_numpy(
        ncode[perm])
    got = _topk_rank(key1_t, ncode_t, cap)
    want = _sort2(key1_t, ncode_t)[:cap]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    in_top = bool((ncode_t[got] == _I64_MAX).any())
    assert in_top == (code0 and class_size <= cap - n_less)


@pytest.mark.parametrize("P", [1, SCAN_ROWS - 1, SCAN_ROWS + 1, 5 * SCAN_ROWS])
def test_suffix_min_matches_a_reverse_cummin(P):
    """The two-level reverse running minimum equals the one-level one,
    for lengths on both sides of its row count (a padded last row)."""
    x = torch.from_numpy(np.random.default_rng(P).integers(-50, 10 ** 6, P))
    want = torch.cummin(x.flip(0), 0).values.flip(0)
    assert torch.equal(_suffix_min(x), want)


@pytest.mark.parametrize("k, solid_km, forbid", [
    (3, 0, False), (16, 0, True), (16, 3, False), (32, 0, True)])
def test_exact_count_select_rows_matches_the_eager_stage(k, solid_km, forbid):
    """The fixed-shape exact stage's kept prefix equals the eager stage's
    selection, and its counters equal the eager ones."""
    w = _windows(k)
    windows_t = torch.from_numpy(w.T.copy())
    row_mask = torch.arange(N_ROWS) < N_VALID
    forbidden = torch.from_numpy(
        np.random.default_rng(k).integers(0, 4 ** min(k, 31), 20))
    if forbid:  # the planted repeat's first k-mer among them
        first = int("".join(map(str, w[0, 5:5 + k])), 4)
        forbidden[3] = first - (1 << 64 if first >= 1 << 63 else 0)
    else:
        forbidden = forbidden[:0]
    lc_thr = lc_sum_threshold(Params(k=k).adjusted_lc, k)
    args = (windows_t, row_mask, k, lc_thr, forbidden, 50, solid_km)
    want = exact_count_select(*args)
    got = exact_count_select_rows(*args, cap=512)
    n_keep = int(got["n_keep"])
    assert n_keep == want["n_keep"] > 0
    for name in ("n_unique", "n_pass", "had_n"):
        assert int(got[name]) == want[name], name
    assert got["sel_valid"].tolist() == [i < n_keep for i in range(512)]
    assert torch.equal(got["sel_codes"][:n_keep], want["sel_codes"])
    assert torch.equal(got["sel_counts"][:n_keep], want["sel_counts"])
