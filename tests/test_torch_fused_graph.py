"""The fused pass's packed output and when its segments become CUDA graphs.

The packed vector must carry every field of a fixed-shape pass through
one fetch: ``pack_pass_output`` then ``unpack_pass_output`` gives back the
scalars, the codes (both words at k > 16, so k = 32's negative int64 codes
too), the counts and the validity masks.  A segment runs eagerly at its
first use, is captured at its second and replayed after, and a pass run
again at a regrown cap runs eagerly and is never cached: the CPU tests
drive that through a stand-in for the card (``_on_card`` and
``torch.cuda.CUDAGraph`` patched), with the ``eager`` and ``capture``
spans under a profiler.  The ``cuda`` test holds the policy on the card:
the eager first pass, the replayed second and ``_pass_output`` equal the
CPU's pass, and the count kernel's counter goes up by one for each pass,
never for the capture.  The GPU host has no JAX and this file imports
none; run the ``cuda`` test there with
``python -m pytest --noconftest -m cuda tests/test_torch_fused_graph.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity  # noqa: E402

from approx_counter_tpu_torch import pipeline  # noqa: E402
from approx_counter_tpu_torch.kernels import bpm, exact_stage  # noqa: E402
from approx_counter_tpu_torch.params import Params  # noqa: E402
from approx_counter_tpu_torch.pipeline import (  # noqa: E402
    Engine,
    _FusedGraph,
    pack_pass_output,
    pass_cap,
    unpack_pass_output,
)


@pytest.mark.parametrize("k", [16, 17, 32])
def test_pack_pass_output_round_trips(k):
    cap = 256
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 1 << (2 * k), 2 * cap, dtype=np.uint64)
    as_t = lambda c: torch.from_numpy(c.view(np.int64))  # noqa: E731
    ex = dict(sel_codes=as_t(codes[:cap]),
              sel_counts=torch.from_numpy(rng.integers(0, 1 << 31, cap)),
              sel_valid=torch.arange(cap) < 100,
              n_unique=torch.tensor(2_792_355), n_keep=torch.tensor(100),
              had_n=torch.tensor(7), n_pass=torch.tensor(123))
    approx = (as_t(codes[cap:]),
              torch.from_numpy(rng.integers(0, 1 << 31, cap)).int(),
              torch.arange(cap) < 90)
    packed = pack_pass_output(ex, approx, k)
    assert packed.dtype == torch.int32
    assert packed.numel() == 4 + (8 if k > 16 else 6) * cap
    out = unpack_pass_output(packed.numpy(), cap, k)
    exact = out["exact"]
    assert [int(exact[n]) for n in ("n_unique", "n_keep", "had_n",
                                    "n_pass")] == [2_792_355, 100, 7, 123]
    join = lambda hi, lo: (hi.astype(np.uint64) << np.uint64(32)) | lo  # noqa: E731
    np.testing.assert_array_equal(join(exact["sel_hi"], exact["sel_lo"]),
                                  codes[:cap])
    np.testing.assert_array_equal(exact["sel_count"],
                                  ex["sel_counts"].numpy())
    np.testing.assert_array_equal(exact["sel_valid"], ex["sel_valid"].numpy())
    np.testing.assert_array_equal(join(out["approx_hi"], out["approx_lo"]),
                                  codes[cap:])
    np.testing.assert_array_equal(out["approx_count"], approx[1].numpy())
    np.testing.assert_array_equal(out["approx_valid"], approx[2].numpy())


class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: the body runs
    between ``capture_begin`` and ``capture_end`` as it does under a real
    capture, so the static outputs hold its result on the static inputs;
    a replay is only counted."""

    def __init__(self, made: list):
        self.captures = self.replays = 0
        made.append(self)

    def capture_begin(self, capture_error_mode):
        assert capture_error_mode == "thread_local"

    def capture_end(self):
        self.captures += 1

    def replay(self):
        self.replays += 1


@pytest.fixture
def card(monkeypatch):
    """Every segment on the CPU taken for one on the card; returns the
    list of the stand-in graphs made."""
    made = []
    monkeypatch.setattr(pipeline, "_on_card", lambda t: True)
    monkeypatch.setattr(pipeline.torch.cuda, "CUDAGraph",
                        lambda: _Graph(made))
    return made


def _marks(prof, name: str) -> int:
    return sum(e.name == name for e in prof.events())


@pytest.mark.parametrize("runs", [1, 2, 5])
def test_a_segment_runs_eagerly_then_captures_then_replays(card, runs):
    """A key run once runs its body eagerly (fresh outputs, no graph);
    twice, eagerly and then a capture and a replay; five times, one more
    replay each time, the body still called twice.  Each kernel's counter
    goes up by its launches a run (1 to 4 here, another number for each,
    so no two counters can be mixed up): the eager run through the
    wrappers, a replay by ``launches``, the capture by nothing."""
    calls = []
    made = {bpm.approx_counts: 1, exact_stage.position_keys: 2,
            exact_stage.slot_keys: 3, exact_stage.slot_dimers: 4}

    def body(x):
        calls.append(x)
        for f, n in made.items():
            f.launches += n  # the wrappers' own counts
        return x * 2 + 1

    x = torch.arange(10)
    seg = _FusedGraph(body)
    before = {f: f.launches for f in made}
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [seg.run(x) for _ in range(runs)]
    for one in got:
        torch.testing.assert_close(one, x * 2 + 1)
    assert {f: f.launches - n for f, n in before.items()} == {
        f: n * runs for f, n in made.items()}
    assert _marks(prof, "eager") == 1
    assert _marks(prof, "warm-up") == 0
    assert _marks(prof, "capture") == len(card) == min(runs - 1, 1)
    assert len(calls) == min(runs, 2) and calls[0] is x
    assert seg.runs == runs and seg.replays == runs - 1
    if runs == 1:
        assert seg.graph is None and seg.inputs is None
        assert seg.launches == dict.fromkeys(pipeline._counted(), 0)
    else:
        (graph,) = card
        assert graph.captures == 1 and graph.replays == runs - 1
        assert calls[1] is seg.inputs[0] and seg.inputs[0] is not x
        assert seg.launches == made and seg.graph is not None


def test_a_regrown_cap_runs_eagerly_and_is_never_cached(card, monkeypatch):
    """-sk 1 outgrows the first cap at every pass.  Over three passes on
    one batch the first cap's segment runs eagerly, then is captured and
    replayed; every rerun at the regrown cap runs eagerly and leaves no
    cache entry and no graph.  The profiler sees one ``eager`` span for
    each eager run, one ``capture``, no ``warm-up``; the results equal the
    plain CPU pass."""
    rng = np.random.default_rng(7)
    n, m, n_valid, k = 64, 41, 57, 12
    wins = rng.integers(0, 4, (n, m)).astype(np.uint8)
    wins[::3, 5:35] = rng.integers(0, 4, 30).astype(np.uint8)
    prm = Params(k=k, sl=m - 1, limit=30, solid_km=1)
    with monkeypatch.context() as plain:
        plain.setattr(pipeline, "_on_card", lambda t: False)
        cpu = Engine(prm, "cpu")
        try:
            want = cpu.count_one_end(wins, n_valid)
        finally:
            cpu.close()
    first = pass_cap(prm.limit)
    assert want[2]["n_keep"] > first
    engine = Engine(prm, "cpu")
    try:
        # every thread: the passes count on the engine's worker
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU],
                experimental_config=torch.profiler._ExperimentalConfig(
                    profile_all_threads=True)) as prof:
            got = [engine.count_one_end(wins, n_valid) for _ in range(3)]
        assert [key[1] for key in engine._graphs] == [first]
        (seg,) = engine._graphs.values()
    finally:
        engine.close()
    for one in got:
        assert one[2] == want[2]
        for a, b in zip(one[:2], want[:2]):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    assert seg.runs == 3 and seg.replays == 2
    (graph,) = card
    assert graph.captures == 1 and graph.replays == 2
    # the first cap once, the regrown cap at each of the three passes
    assert _marks(prof, "eager") == 4
    assert _marks(prof, "regrow.reruns=1") == 3
    assert _marks(prof, "capture") == 1 and _marks(prof, "warm-up") == 0


def test_sharded_reruns_take_fresh_segments():
    """The sharded step's segments at the first sizes are cached and
    shared by every pass; a rerun's (a doubled bucket or a regrown cap)
    are made anew each time and never enter the cache."""
    engine = Engine(Params(k=12, sl=40, limit=30), "cpu", sharded=True)
    try:
        first = engine._sharded_segments(512, 64, 41, 64, False)
        assert engine._sharded_segments(512, 64, 41, 64, False) is first
        again = engine._sharded_segments(640, 128, 41, 64, True)
        assert engine._sharded_segments(640, 128, 41, 64, True) is not again
        assert len(again) == 4 and all(s.runs == 0 for s in again)
        assert list(engine._graphs.values()) == [first]
    finally:
        engine.close()


@pytest.mark.cuda
def test_fused_graph_replays_the_eager_body():
    """On the card: the first pass runs the body eagerly, the second
    captures it and replays; both equal the CPU's pass, and so does a
    third through ``_pass_output`` against the body run eagerly there.
    The kernel's counter counts one launch a pass (the eager run, then a
    replay each), not the capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    rng = np.random.default_rng(3)
    n, m, n_valid, k = 300, 41, 290, 12
    wins = rng.integers(0, 4, (n, m)).astype(np.uint8)
    wins[::3, 4:30] = rng.integers(0, 4, 26).astype(np.uint8)
    prm = Params(k=k, sl=m - 1, limit=20)
    engine, cpu = Engine(prm, "cuda"), Engine(prm, "cpu")
    try:
        before = bpm.approx_counts.launches
        got = [engine.count_one_end(wins, n_valid)]
        (graph,) = engine._graphs.values()
        assert graph.graph is None and graph.runs == 1
        got.append(engine.count_one_end(wins, n_valid))
        assert graph.graph is not None and graph.replays == 1
        assert bpm.approx_counts.launches == before + 2
        want = cpu.count_one_end(wins, n_valid)
        for one in got:
            assert one[2] == want[2]
            for a, b in zip(one[:2], want[:2]):
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])
        windows_t, row_mask = engine.device_windows(wins, n_valid)
        cap = pass_cap(prm.limit)
        eager = engine._fused_body(windows_t, row_mask, cap).cpu().numpy()
        replayed = engine._pass_output(cap, windows_t, row_mask)
        np.testing.assert_array_equal(replayed, eager)
        np.testing.assert_array_equal(replayed, cpu._pass_output(
            cap, windows_t.cpu(), row_mask.cpu()))
        assert graph.launches[bpm.approx_counts] == 1 and graph.replays == 2
    finally:
        engine.close()
        cpu.close()
