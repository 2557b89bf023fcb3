"""The port's device window pool (``--device-pool``) on the CPU.

``tests/test_pool.py``'s cases for the port: every export with the pool on
byte-equal to the per-pass upload path (pool off), in each mode; four of
them also against the JAX package's run.  Then the pool's index vector at
a pool of 2^16 rows or more (int32, not uint16) on ``start_pass_pool``
itself, its guard against a read outside the pool, and what ``auto``
builds.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu.core.codec import codes_to_seq  # noqa: E402
from approx_counter_tpu.params import Params as JaxParams  # noqa: E402
from approx_counter_tpu.pipeline import run_pipeline as jax_run  # noqa: E402
from approx_counter_tpu_torch.io.fastx import Reads  # noqa: E402
from approx_counter_tpu_torch.params import Params  # noqa: E402
from approx_counter_tpu_torch.pipeline import (  # noqa: E402
    Engine,
    pool_index,
    pool_rows,
    run_pipeline,
)
from test_torch_pipeline import jax_numpy_paths  # noqa: E402,F401


def _fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">r{i}\n{s}\n")


def _exports(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def _run_modes(tmp_path, rng, name, jax=False, **kw):
    """``tests/test_pool.py:_run_both`` for the port: the pool forced on
    and off (and, with ``jax``, the JAX package at its default) on the same
    reads; every export byte-equal.  Returns the exports."""
    sl = kw.pop("sl")
    n_reads = kw.pop("n_reads", 18)
    with_n = kw.pop("with_n", False)
    seqs = []
    for i in range(n_reads):
        s = codes_to_seq(rng.integers(0, 4, int(rng.integers(2 * sl, 4 * sl))))
        if with_n and i % 3 == 0:
            s = s[:sl // 2] + "N" + s[sl // 2 + 1:]
        seqs.append(s)
    seqs.append(codes_to_seq(rng.integers(0, 4, sl)))  # ineligible
    fa = tmp_path / f"{name}.fasta"
    _fasta(fa, seqs)
    outs = {}
    runs = [("on", run_pipeline), ("off", run_pipeline)]
    if jax:
        runs.append(("jax", None))
    for mode, run in runs:
        d = tmp_path / f"{name}_{mode}"
        d.mkdir()
        prm = dict(input_file=str(fa), output=str(d / "o.txt"),
                   exact_out=str(d / "e.txt"), sl=sl, v=0, **kw)
        if run is None:
            assert jax_run(JaxParams(**prm)) == 0
        else:
            assert run(Params(device_pool=mode, **prm), device="cpu") == 0
        outs[mode] = _exports(d)
    assert len(outs["on"]) > 0
    for mode in outs:
        assert outs[mode] == outs["on"], mode
    return outs["on"]


@pytest.fixture
def pool_spy(monkeypatch):
    """What each run's ``build_pool`` was asked for and gave, and how many
    passes went through the pool."""
    seen = dict(built=[], ends=[], pool_passes=0)
    build, start = Engine.build_pool, Engine.start_pass_pool

    def spy_build(self, reads, sl, ends=("start", "end")):
        r = build(self, reads, sl, ends=ends)
        seen["built"].append(r)
        seen["ends"].append(ends)
        return r

    def spy_start(self, *a, **kw):
        seen["pool_passes"] += 1
        return start(self, *a, **kw)

    monkeypatch.setattr(Engine, "build_pool", spy_build)
    monkeypatch.setattr(Engine, "start_pass_pool", spy_start)
    return seen


@pytest.mark.parametrize("name,kw,jax", [
    ("mr", dict(sl=10, k=6, sn=8, limit=12, seed=3, nb_of_runs=2), True),
    ("ident", dict(sl=10, k=6, sn=100, limit=12, seed=3), False),
    ("k17", dict(sl=20, k=17, sn=10, limit=9, seed=5, nb_of_runs=2), True),
    ("withn", dict(sl=12, k=5, sn=9, limit=10, seed=7, with_n=True,
                   nb_of_runs=2), True),
    ("solid", dict(sl=10, k=4, sn=20, limit=10, seed=2, solid_km=1,
                   nb_of_runs=2), False),
    ("quirk", dict(sl=10, k=6, sn=8, limit=10, seed=4, skip_end=True,
                   compat_quirks=True), True),
    # tests/test_pool.py's cap regrowth: -sk 1 past the JAX package's first
    # cap of 512 (the port has no cap; the case stays for its size)
    ("regrow", dict(sl=40, k=10, sn=60, limit=5000, seed=2, solid_km=1,
                    nb_of_runs=2, n_reads=50), False),
    ("zero", dict(sl=10, k=4, sn=0, limit=5, seed=1, nb_of_runs=2), False),
])
def test_pool_on_equals_off(tmp_path, rng, pool_spy, name, kw, jax):
    outs = _run_modes(tmp_path, rng, name, jax=jax, **kw)
    n_ends = 1 if kw.get("skip_end") and not kw.get("compat_quirks") else 2
    assert len(outs) == 2 * n_ends * kw.get("nb_of_runs", 1)
    # the "on" run built a pool and sent every pass through it
    assert pool_spy["built"][0] is True
    assert pool_spy["pool_passes"] == n_ends * kw.get("nb_of_runs", 1)


def test_pool_auto_triggers_on_multirun(tmp_path, rng, pool_spy):
    """auto builds the pool for identity-sampling multi-run (pool rows <
    the passes' rows) and skips it for a single skip_end pass."""
    seqs = [codes_to_seq(rng.integers(0, 4, 40)) for _ in range(15)]
    fa = tmp_path / "a.fasta"
    _fasta(fa, seqs)
    base = dict(input_file=str(fa), sl=10, k=6, sn=100, limit=5, v=0, seed=1)
    assert run_pipeline(Params(output=str(tmp_path / "o.txt"), nb_of_runs=2,
                               **base), device="cpu") == 0
    assert pool_spy["built"] == [True] and pool_spy["pool_passes"] == 4
    assert run_pipeline(Params(output=str(tmp_path / "o2.txt"), skip_end=True,
                               **base), device="cpu") == 0
    assert pool_spy["built"] == [True] and pool_spy["pool_passes"] == 4
    # one run, both ends: 2 passes of 256 padded rows against 2 x 15 pool
    # rows, so auto builds it
    assert run_pipeline(Params(output=str(tmp_path / "o3.txt"), **base),
                        device="cpu") == 0
    assert pool_spy["built"] == [True, True]


def test_pool_skip_end_builds_start_plane_only(tmp_path, rng, pool_spy):
    """-se (and the quirk, whose end pass re-samples the start) never
    reads the end plane: the pool does not hold it."""
    seqs = [codes_to_seq(rng.integers(0, 4, 40)) for _ in range(12)]
    fa = tmp_path / "a.fasta"
    _fasta(fa, seqs)
    base = dict(input_file=str(fa), sl=10, k=6, sn=100, limit=5, v=0,
                seed=1, nb_of_runs=2, device_pool="on")
    for out, kw in (("s", dict(skip_end=True)),
                    ("q", dict(skip_end=True, compat_quirks=True)),
                    ("b", dict())):
        assert run_pipeline(Params(output=str(tmp_path / f"{out}.txt"),
                                   **base, **kw), device="cpu") == 0
    assert pool_spy["ends"] == [("start",), ("start",), ("start", "end")]
    assert ((tmp_path / "q.txt_0.end").read_text()
            == (tmp_path / "q.txt_0.start").read_text())


def test_pool_not_used_off_stream_or_resume(tmp_path, rng, pool_spy):
    seqs = [codes_to_seq(rng.integers(0, 4, 40)) for _ in range(12)]
    fa = tmp_path / "a.fasta"
    _fasta(fa, seqs)
    base = dict(input_file=str(fa), sl=10, k=6, sn=100, limit=5, v=0,
                seed=1, nb_of_runs=2)
    assert run_pipeline(Params(output=str(tmp_path / "off.txt"),
                               device_pool="off", exact_out=str(tmp_path / "e"),
                               **base), device="cpu") == 0
    assert run_pipeline(Params(output=str(tmp_path / "st.txt"), stream=True,
                               device_pool="on", **base), device="cpu") == 0
    assert run_pipeline(Params(output=str(tmp_path / "re.txt"),
                               from_exact=str(tmp_path / "e_0.start"),
                               device_pool="on", **base), device="cpu") == 0
    assert pool_spy["built"] == [] and pool_spy["pool_passes"] == 0


def test_pool_build_failure_fails_the_run(tmp_path, rng, monkeypatch):
    """--device-pool on uses the pool or fails: an error building it ends
    the run, with no fall-back to per-pass uploads."""
    def broken(self, *a, **kw):
        raise RuntimeError("pool build failed")

    monkeypatch.setattr(Engine, "build_pool", broken)
    fa = tmp_path / "a.fasta"
    _fasta(fa, [codes_to_seq(rng.integers(0, 4, 40)) for _ in range(6)])
    with pytest.raises(RuntimeError, match="pool build failed"):
        run_pipeline(Params(input_file=str(fa), output=str(tmp_path / "o"),
                            sl=10, k=6, sn=4, v=0, seed=1,
                            device_pool="on"), device="cpu")


@pytest.mark.parametrize("E", [5, (1 << 16) - 1, 1 << 16, 70000])
def test_pool_index_round_trip(E):
    """uint16 below 2^16 pool rows (n_valid in two slots, so it may pass
    2^16 itself), int32 from 2^16 on; rows past n_valid gather row 0 and
    are masked."""
    rng = np.random.default_rng(E)
    n_reads = E + 10
    inv = np.full(n_reads, -1, np.int64)
    elig = np.sort(rng.choice(n_reads, E, replace=False))
    inv[elig] = np.arange(E)
    for n_valid in (0, 1, min(E, 70000)):
        chosen = rng.permutation(elig)[:n_valid]
        idx_ext = pool_index(inv, chosen, n_valid, E)
        assert idx_ext.dtype == (np.uint16 if E < (1 << 16) else np.int32)
        idx, row_mask = pool_rows(torch.from_numpy(idx_ext))
        assert len(idx) == max(n_valid, 1)
        np.testing.assert_array_equal(idx.numpy()[:n_valid], inv[chosen])
        assert (idx.numpy()[n_valid:] == 0).all()
        np.testing.assert_array_equal(row_mask.numpy(),
                                      np.arange(len(idx)) < n_valid)


def test_pool_index_refuses_a_read_outside_the_pool():
    inv = np.array([0, -1, 1], np.int64)
    with pytest.raises(ValueError, match="not in the device pool"):
        pool_index(inv, np.array([2, 1]), 2, 2)


def test_start_pass_pool_int32_path_equals_host_batch():
    """A pool of 70,000 rows (the int32 index vector): ``start_pass_pool``
    gives what ``start_pass`` gives on the host-gathered batch of the same
    reads, at both ends."""
    from approx_counter_tpu_torch.sample.sampler import sample_windows

    sl, k, n_reads = 4, 3, 70000
    rng = np.random.default_rng(9)
    buf = rng.integers(0, 4, n_reads * 2 * sl).astype(np.uint8)
    buf[rng.integers(0, len(buf), 50)] = 4
    offsets = np.arange(n_reads + 1, dtype=np.int64) * 2 * sl
    reads = Reads(buf=buf, offsets=offsets)
    engine = Engine(Params(k=k, sl=sl, limit=12), "cpu")
    assert engine.build_pool(reads, sl)
    assert engine._pool["E"] == n_reads
    for end in (False, True):
        batch = sample_windows(reads, 300, sl, end=end,
                               rng=np.random.default_rng(end), pad_to=1)
        got = engine.start_pass_pool(batch.chosen, batch.n_valid, end).finish()
        want = engine.count_one_end(batch.windows, batch.n_valid)
        assert got[2] == want[2]
        for a, b in zip(got[:2], want[:2]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
