"""The exact stage's CUDA kernels against the torch ops they replace.

``kernels/exact_stage.py`` runs step 1 (``position_keys``,
``csrc/position_keys.cu``), step 3 (``slot_keys``, ``csrc/slot_keys.cu``)
and the re-rank's dimer sums (``slot_dimers``, ``csrc/slot_dimers.cu``) as
one kernel each on CUDA tensors and as torch ops on CPU tensors; the torch
ops are what ``test_torch_exact.py`` and ``test_torch_fused_pass.py`` hold
to the JAX package.  Here, on the CPU: the kernels' dimer sum
(``csrc/dimer_sum.cuh``: a histogram of 8-bit bins in two 64-bit words, 2h
added for a dimer whose bin holds h) equals ``dimer_sum`` and
``dimer_sum_np`` at every k, and the exact stage on CPU tensors builds and
launches no kernel and marks ``exact.launches=0`` a pass.  Marked
``cuda``, on the card: each kernel equals the torch ops bit for bit (keys,
totals, dimer sums, masks, keys and counts) at the cells' shape and at
every k class, with Ns, pads and a partial row mask, 0, 1 and 17
forbidden codes and ``solid_km`` 0, 1 and 2; ``dimer_sum`` on a card
tensor stays torch ops; ``exact_count_select_rows`` equals the CPU's; a
captured graph's replay equals the eager run; a pass marks
``exact.launches=2`` and launches ``slot_dimers`` once.  The GPU host has no JAX and this file imports
none; run the ``cuda`` tests there with
``python -m pytest --noconftest -m cuda tests/test_torch_exact_kernels.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity  # noqa: E402

from approx_counter_tpu_torch.core.complexity import (  # noqa: E402
    dimer_sum,
    dimer_sum_np,
    lc_sum_threshold,
    max_dimer_sum,
)
from approx_counter_tpu_torch.count.exact import (  # noqa: E402
    exact_count_local_rows,
    exact_count_select_rows,
)
from approx_counter_tpu_torch.kernels import _build, exact_stage  # noqa: E402
from approx_counter_tpu_torch.params import Params  # noqa: E402
from approx_counter_tpu_torch.pipeline import Engine, _FusedGraph  # noqa: E402


def _histogram_dimer_sum(codes: np.ndarray, k: int) -> np.ndarray:
    """``csrc/dimer_sum.cuh:dimer_sum`` step for step on uint64 codes: the
    dimers 0-7 in eight 8-bit bins of one word, 8-15 in another; a dimer
    whose bin holds h adds h equal pairs, then 1 to its bin."""
    codes = codes.astype(np.uint64)
    lo = np.zeros_like(codes)
    hi = np.zeros_like(codes)
    pairs = np.zeros(codes.shape, np.int64)
    for j in range(k - 1):
        d = (codes >> np.uint64(2 * j)) & np.uint64(15)
        sh = np.uint64(8) * (d & np.uint64(7))
        low = d < np.uint64(8)
        pairs += ((np.where(low, lo, hi) >> sh) & np.uint64(0xFF)).astype(
            np.int64)
        one = np.uint64(1) << sh
        lo += np.where(low, one, np.uint64(0))
        hi += np.where(low, np.uint64(0), one)
    return 2 * pairs


def _codes(k: int, n: int, seed: int) -> np.ndarray:
    """``n`` random uint64 k-mer codes, then the four homopolymers, whose
    k - 1 dimers are all one (the maximum sum)."""
    rng = np.random.default_rng(seed)
    mask = np.uint64((1 << (2 * k)) - 1)
    rand = rng.integers(0, 1 << 63, n, dtype=np.uint64) * np.uint64(2)
    rand |= rng.integers(0, 2, n, dtype=np.uint64)
    fills = [0x0, 0x5555555555555555, 0xAAAAAAAAAAAAAAAA, 0xFFFFFFFFFFFFFFFF]
    return np.concatenate([rand, np.array(fills, np.uint64)]) & mask


@pytest.mark.parametrize("k", range(2, 33))
def test_slot_kernel_dimer_histogram_matches_dimer_sum(k):
    """The histogram formula equals the pairwise ``dimer_sum`` and the
    host ``dimer_sum_np`` on random codes and on the codes of one repeated
    dimer, which score the maximum (k - 1)(k - 2).  At k = 2 one dimer
    makes no pair: every sum is 0, under the unreachable threshold the
    reference's NaN score turns into."""
    codes = _codes(k, 4000, k)
    want = dimer_sum_np(codes, k)
    got = _histogram_dimer_sum(codes, k)
    np.testing.assert_array_equal(got, want)
    torch_sum = dimer_sum(torch.from_numpy(codes.view(np.int64)), k)
    assert torch_sum.dtype == torch.int32
    np.testing.assert_array_equal(torch_sum.numpy(), want)
    np.testing.assert_array_equal(got[-4:], max_dimer_sum(k))
    assert got.max() == max_dimer_sum(k) and got.min() >= 0
    if k == 2:
        assert not got.any()
        assert lc_sum_threshold(0.0, 2) == max_dimer_sum(2) + 1 == 1


def _batch(seed: int, m: int, n: int, pair=(0, 3)):
    """Tie-heavy text-major ``[m, n]`` windows: columns drawn from 24
    templates (four over the two bases ``pair`` only) with substitutions,
    ~0.5% Ns, a run of trailing pad on every fifth window, and a bool row
    mask whose last ``n // 9`` rows are not real."""
    rng = np.random.default_rng(seed)
    templates = rng.integers(0, 4, (24, m))
    templates[:4] = np.asarray(pair)[rng.integers(0, 2, (4, m))]
    wins = templates[rng.integers(0, 24, n)].astype(np.uint8)
    subs = rng.random((n, m)) < 0.03
    wins[subs] = rng.integers(0, 4, int(subs.sum()))
    wins[rng.random((n, m)) < 0.005] = 4
    cut = rng.integers(m // 2, m, n)
    for w in range(0, n, 5):
        wins[w, cut[w]:] = 5
    row_mask = np.ones(n, bool)
    row_mask[n - n // 9:] = False
    return (torch.from_numpy(np.ascontiguousarray(wins.T)),
            torch.from_numpy(row_mask))


def _forbidden(codes: torch.Tensor, counts: torch.Tensor, F: int, seed: int):
    """``F`` int64 forbidden codes: the most counted codes first (so the
    filter bites), then codes that may be absent."""
    rng = np.random.default_rng(seed)
    top = codes[torch.argsort(counts, descending=True)[:(F + 1) // 2]]
    rand = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, F - len(top)))
    return torch.cat([top, rand]).to(torch.int64)


def test_exact_stage_on_cpu_builds_and_launches_no_kernel(monkeypatch):
    """CPU tensors take the torch ops: no library is built or loaded and
    no wrapper counts a launch, and ``slot_dimers`` is ``dimer_sum``."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA library was asked for on the CPU")

    monkeypatch.setattr(_build, "kernel_build", refuse)
    monkeypatch.setattr(_build, "_compile", refuse)
    built = dict(_build._builds)
    wrappers = (exact_stage.position_keys, exact_stage.slot_keys,
                exact_stage.slot_dimers)
    before = [f.launches for f in wrappers]
    windows_t, row_mask = _batch(5, 41, 300)
    codes, counts, _ = exact_count_local_rows(windows_t, row_mask, 12)
    forbidden = _forbidden(codes, counts, 17, 5)
    for solid_km, cap in ((0, 128), (2, 4096)):
        out = exact_count_select_rows(windows_t, row_mask, 12, 40, forbidden,
                                      50, solid_km, cap)
        assert int(out["n_keep"]) > 0
    assert torch.equal(exact_stage.slot_dimers(codes, 12),
                       dimer_sum(codes, 12))
    assert [f.launches for f in wrappers] == before
    assert _build._builds == built


def _exact_marks(engine, wins, n_valid, passes=2):
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU],
            experimental_config=torch.profiler._ExperimentalConfig(
                profile_all_threads=True)) as prof:
        for _ in range(passes):
            engine.count_one_end(wins, n_valid)
    return sorted(e.name for e in prof.events()
                  if e.name.startswith("exact.launches="))


def test_a_cpu_pass_marks_no_exact_launch():
    """On the CPU the fused pass marks ``exact.launches=0`` once a pass."""
    rng = np.random.default_rng(11)
    wins = rng.integers(0, 4, (64, 41)).astype(np.uint8)
    engine = Engine(Params(k=12, sl=40, limit=20), "cpu")
    try:
        assert _exact_marks(engine, wins, 60) == ["exact.launches=0"] * 2
    finally:
        engine.close()


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    return torch.device("cuda")


def _assert_same(got, want, what):
    got = got.cpu() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert torch.equal(got, want), what


#: (m, n, k): the cells' shapes (start windows of sl = 100, end windows of
#: 101, 40,000 of them, k = 16), then every k class on a smaller batch.
PACK_SHAPES = [(100, 40000, 16), (101, 40000, 16)] + [
    (101, 3000, k) for k in (2, 3, 15, 17, 31, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", PACK_SHAPES)
def test_position_keys_kernel_matches_torch(cuda, m, n, k):
    windows_t, row_mask = _batch(m * k, m, n, (2, 3) if k > 16 else (0, 3))
    want = exact_stage.position_keys_ref(windows_t, row_mask, k)
    before = exact_stage.position_keys.launches
    got = exact_stage.position_keys(windows_t.to(cuda), row_mask.to(cuda), k)
    torch.cuda.synchronize()
    assert exact_stage.position_keys.launches == before + 1
    for name, g, w in zip(("keys", "n_valid", "had_n"), got, want):
        _assert_same(g, w, name)
    assert 0 < int(want[1]) < want[0].numel() and int(want[2]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 15, 16, 17, 31, 32])
def test_slot_dimers_kernel_matches_torch(cuda, k):
    codes = torch.from_numpy(_codes(k, 100_000, k).view(np.int64))
    want = dimer_sum(codes, k)
    before = exact_stage.slot_dimers.launches
    _assert_same(exact_stage.slot_dimers(codes.to(cuda), k), want, "dimer")
    _assert_same(exact_stage.slot_dimers(codes.view(2, -1).to(cuda), k),
                 want.view(2, -1), "dimer [2, n]")
    assert exact_stage.slot_dimers.launches == before + 2
    # the plain version stays torch ops on a card tensor too
    _assert_same(dimer_sum(codes.to(cuda), k), want, "dimer_sum on the card")
    assert exact_stage.slot_dimers.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 15, 16, 17, 31, 32])
@pytest.mark.parametrize("F", [0, 1, 17])
@pytest.mark.parametrize("solid_km", [0, 1, 2])
def test_slot_keys_kernel_matches_torch(cuda, k, F, solid_km):
    windows_t, row_mask = _batch(7 * k + F, 61, 2000,
                                 (2, 3) if k > 16 else (0, 3))
    codes, counts, _ = exact_count_local_rows(windows_t, row_mask, k)
    forbidden = _forbidden(codes, counts, F, k)
    lc_thr = lc_sum_threshold(1.0, k)
    for key_bits in (None, max_dimer_sum(k).bit_length()):
        args = (k, lc_thr, forbidden, solid_km, key_bits)
        want = exact_stage.slot_keys_ref(codes, counts, *args)
        before = exact_stage.slot_keys.launches
        got = exact_stage.slot_keys(codes.to(cuda), counts.to(cuda), k,
                                    lc_thr, forbidden.to(cuda), solid_km,
                                    key_bits)
        assert exact_stage.slot_keys.launches == before + 1
        assert sorted(got) == sorted(want)
        for name in want:
            _assert_same(got[name], want[name], f"{name} key_bits={key_bits}")
        assert 0 < int(want["n_pass"]) <= int(want["n_unique"])


def _select_cases():
    # (m, n, k, F, solid_km, cap): the default run's shape through
    # _topk_rank, then solid mode at a cap past every slot (the
    # CompareCount sort), then small batches at the other k classes
    yield 101, 40000, 16, 17, 0, 512
    yield 101, 40000, 16, 1, 2, 40960
    yield 100, 40000, 16, 0, 1, 3_440_000
    for k in (2, 3, 15, 17, 31, 32):
        yield 61, 2000, k, 17, 0, 128
        yield 61, 2000, k, 0, 2, 8192


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,F,solid_km,cap", list(_select_cases()))
def test_exact_count_select_rows_matches_cpu(cuda, m, n, k, F, solid_km, cap):
    windows_t, row_mask = _batch(m + k + F, m, n, (2, 3) if k > 16 else (0, 3))
    codes, counts, _ = exact_count_local_rows(windows_t, row_mask, k)
    forbidden = _forbidden(codes, counts, F, k + 1)
    lc_thr = lc_sum_threshold(1.0, k)
    args = (k, lc_thr, forbidden, 500, solid_km, cap)
    want = exact_count_select_rows(windows_t, row_mask, *args)
    got = exact_count_select_rows(windows_t.to(cuda), row_mask.to(cuda),
                                  k, lc_thr, forbidden.to(cuda), 500,
                                  solid_km, cap)
    assert sorted(got) == sorted(want)
    for name in want:
        _assert_same(got[name], want[name], name)
    assert int(want["n_keep"]) > 0


@pytest.mark.cuda
def test_captured_exact_stage_replays_the_eager_run(cuda):
    """The exact stage in a ``_FusedGraph``: the first run eager, the
    second captured and replayed, the third replayed on other windows;
    each equals the CPU's, and each run counts one launch of each kernel,
    the capture none."""
    k, cap = 16, 512
    batches = [_batch(s, 101, 40000) for s in (1, 2, 2, 3)]
    forbidden = torch.tensor([0, 1 << 20, 12345], dtype=torch.int64)
    # on the device before the capture, which may copy nothing from the host
    on = {"cpu": forbidden, "cuda": forbidden.to(cuda)}

    def body(windows_t, row_mask):
        out = exact_count_select_rows(windows_t, row_mask, k, 60,
                                      on[windows_t.device.type], 500, 0, cap)
        return torch.cat([out["sel_codes"], out["sel_counts"],
                          out["sel_valid"].long(),
                          torch.stack([out[n] for n in (
                              "n_unique", "n_pass", "n_keep", "had_n")])])

    seg = _FusedGraph(body)
    counters = (exact_stage.position_keys, exact_stage.slot_keys)
    side = torch.cuda.Stream()  # a graph is captured off the default stream
    for i, (windows_t, row_mask) in enumerate(batches):
        before = [f.launches for f in counters]
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            got = seg.run(windows_t.to(cuda), row_mask.to(cuda)).cpu()
        assert [f.launches - n for f, n in zip(counters, before)] == [1, 1]
        _assert_same(got, body(windows_t, row_mask), f"run {i}")
    assert seg.graph is not None and seg.replays == 3
    assert {f: seg.launches[f] for f in counters} == dict.fromkeys(counters, 1)


@pytest.mark.cuda
def test_a_card_pass_marks_two_exact_launches(cuda):
    """A fused pass on the card launches the pack kernel and the slot
    kernel once each, one ``exact.launches=2`` mark a pass, eager, captured
    or replayed, and ``slot_dimers`` once, in the re-rank."""
    rng = np.random.default_rng(12)
    wins = rng.integers(0, 4, (300, 41)).astype(np.uint8)
    engine = Engine(Params(k=12, sl=40, limit=20), "cuda")
    try:
        before = exact_stage.slot_dimers.launches
        assert _exact_marks(engine, wins, 290, 3) == ["exact.launches=2"] * 3
        assert exact_stage.slot_dimers.launches == before + 3
    finally:
        engine.close()
