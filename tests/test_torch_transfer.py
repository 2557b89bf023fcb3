"""The port's window upload path vs the JAX package's, on the CPU.

The packers (``core/codec.py``, numpy), the native gather and sparse-N
packer (``io/native.py``), the torch unpackers and ``Engine.device_windows``
against the JAX codec's packers and ``jnp`` unpackers, and the sampler's
``warn_sink=``/``gather=False`` against the JAX sampler, rng state
included.  Every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from approx_counter_tpu.core import codec as jax_codec  # noqa: E402
from approx_counter_tpu.io.fastx import Reads as JaxReads  # noqa: E402
from approx_counter_tpu.sample.sampler import (  # noqa: E402
    sample_windows as jax_sample,
)
from approx_counter_tpu_torch.core import codec  # noqa: E402
from approx_counter_tpu_torch.core.codec import BASE_N, BASE_PAD, NCAP  # noqa: E402
from approx_counter_tpu_torch.io import native  # noqa: E402
from approx_counter_tpu_torch.io.fastx import Reads  # noqa: E402
from approx_counter_tpu_torch.params import Params  # noqa: E402
from approx_counter_tpu_torch.pipeline import Engine, run_pipeline  # noqa: E402
from approx_counter_tpu_torch.sample.sampler import sample_windows  # noqa: E402
from test_torch_pipeline import jax_numpy_paths  # noqa: E402,F401


def sampled_batch(seed, n, m, n_valid, end, n_ns=0):
    """A batch as the sampler makes it: ``n_valid`` rows of real bases
    (``m`` of them at an end, ``m - 1`` and a pad column at a start), the
    other rows pad, ``n_ns`` Ns at random in the real region."""
    rng = np.random.default_rng(seed)
    ncols = m if end else m - 1
    w = np.full((n, m), BASE_PAD, np.uint8)
    w[:n_valid, :ncols] = rng.integers(0, 4, (n_valid, ncols))
    if n_valid and n_ns:
        w[rng.integers(0, n_valid, n_ns), rng.integers(0, ncols, n_ns)] = BASE_N
    return w


def _broken(kind):
    w = sampled_batch(10, 40, 21, 30, True, 5)
    if kind == "pad_inside":
        w[7, 3] = BASE_PAD   # pad inside the valid region
    else:
        w[9, 11] = 6         # a symbol no sampler writes (the dense format
    return w                 # holds 3 bits)


# (name, batch, n_valid, whether the sparse format takes it)
CASES = [
    ("start", sampled_batch(1, 300, 101, 277, False), 277, True),
    ("end", sampled_batch(2, 300, 101, 300, True), 300, True),
    ("start_ns", sampled_batch(3, 200, 101, 190, False, 500), 190, True),
    ("end_ns_ragged", sampled_batch(4, 64, 13, 60, True, 40), 60, True),
    ("n_valid_0", sampled_batch(5, 1, 101, 0, False), 0, True),
    ("n_valid_1", sampled_batch(6, 1, 101, 1, True, 3), 1, True),
    ("n_valid_1_start", sampled_batch(7, 1, 31, 1, False), 1, True),
    ("m_8", sampled_batch(9, 50, 8, 50, True, 9), 50, True),
    ("past_ncap", sampled_batch(8, 600, 101, 600, True, 6000), 600, False),
    ("pad_inside", _broken("pad_inside"), 30, False),
    ("junk", _broken("junk"), 30, False),
]
IDS = [c[0] for c in CASES]
CASES = [c[1:] for c in CASES]

# the jnp unpackers, jitted as the JAX package runs them (op by op they
# compile every op anew for each shape)
JNP_UNPACK = {name: jax.jit(getattr(jax_codec, name), static_argnames="m")
              for name in ("unpack_windows_jnp", "unpack_windows_sparse_jnp",
                           "unpack_windows_sparse_t_jnp")}


@pytest.mark.parametrize("w,n_valid,sparse", CASES, ids=IDS)
def test_packers_match_jax(w, n_valid, sparse):
    planes, m = codec.pack_windows_host(w)
    want_planes, want_m = jax_codec.pack_windows_host(w)
    np.testing.assert_array_equal(planes, want_planes)
    assert m == want_m == w.shape[1]

    got = codec.pack_windows_sparse(w, n_valid)
    want = jax_codec.pack_windows_sparse(w, n_valid)  # its numpy path here
    assert (got is None) == (want is None) == (not sparse)
    ncols = codec.sparse_ncols(w, n_valid)
    nat = native.pack_windows_sparse_native(w, n_valid, ncols, NCAP)
    assert (nat is None) == (not sparse)
    if not sparse:
        return
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2] == ncols
    np.testing.assert_array_equal(nat[0], want[0])
    np.testing.assert_array_equal(nat[1], want[1])
    assert nat[1].dtype == np.int32 and len(nat[1]) == NCAP


def test_junk_past_bit_2_breaks_the_contract():
    """A symbol >= 8 has bit 2 clear; the packers still refuse it."""
    w = _broken("junk")
    w[9, 11] = 9
    assert jax_codec.pack_windows_sparse(w, 30) is None
    assert codec.pack_windows_sparse(w, 30) is None
    assert native.pack_windows_sparse_native(w, 30, 21, NCAP) is None


@pytest.mark.parametrize("w,n_valid,sparse", CASES, ids=IDS)
def test_unpackers_match_jax(w, n_valid, sparse):
    m = w.shape[1]
    planes, _ = jax_codec.pack_windows_host(w)
    got = codec.unpack_windows(torch.from_numpy(planes), m)
    np.testing.assert_array_equal(got.numpy(), w)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(JNP_UNPACK["unpack_windows_jnp"](jnp.asarray(planes), m=m)))
    if not sparse:
        return
    lo, n_idx, ncols, _ = jax_codec.pack_windows_sparse(w, n_valid)
    args = (torch.from_numpy(lo), torch.from_numpy(n_idx), n_valid, ncols, m)
    jargs = (jnp.asarray(lo), jnp.asarray(n_idx), np.int32(n_valid),
             np.int32(ncols))
    got = codec.unpack_windows_sparse(*args)
    want = np.asarray(JNP_UNPACK["unpack_windows_sparse_jnp"](*jargs, m=m))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), w)
    got_t = codec.unpack_windows_sparse_t(*args)
    want_t = np.asarray(JNP_UNPACK["unpack_windows_sparse_t_jnp"](*jargs,
                                                                m=m))
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_t.numpy(), w.T)
    assert got_t.dtype == torch.uint8 and got_t.is_contiguous()


@pytest.mark.parametrize("w,n_valid,sparse", CASES, ids=IDS)
def test_device_windows_round_trip(w, n_valid, sparse):
    """``Engine.device_windows`` on the CPU: text-major windows equal to
    the batch (sparse or dense), the row mask of the first ``n_valid``."""
    engine = Engine(Params(k=5, sl=w.shape[1] - 1), "cpu")
    windows_t, row_mask = engine.device_windows(w, n_valid)
    np.testing.assert_array_equal(windows_t.numpy(), w.T)
    np.testing.assert_array_equal(row_mask.numpy(),
                                  np.arange(w.shape[0]) < n_valid)


def test_noncontiguous_batch_packs_as_its_copy():
    w = sampled_batch(11, 80, 101, 70, True, 20)
    view = np.asfortranarray(w)
    assert not view.flags.c_contiguous
    got = native.pack_windows_sparse_native(view, 70, 101, NCAP)
    want = native.pack_windows_sparse_native(w, 70, 101, NCAP)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        Engine(Params(k=5, sl=100), "cpu").device_windows(view, 70)[0].numpy(),
        w.T)


def test_gather_windows_native_matches_numpy():
    rng = np.random.default_rng(12)
    buf = rng.integers(0, 5, 5000).astype(np.uint8)
    starts = rng.integers(0, 5000 - 31, 300)
    out = np.full((310, 32), BASE_PAD, np.uint8)
    native.gather_windows_native(buf, starts, 31, out)
    want = np.full((310, 32), BASE_PAD, np.uint8)
    want[:300, :31] = buf[starts[:, None] + np.arange(31)]
    np.testing.assert_array_equal(out, want)
    native.gather_windows_native(buf, starts[:0], 31, out)  # nothing to do
    with pytest.raises(ValueError, match="outside buf"):
        native.gather_windows_native(buf, np.array([4990]), 31, out)
    with pytest.raises(ValueError, match="cannot take"):
        native.gather_windows_native(buf, starts, 33, out)


def test_native_packer_without_gxx_raises(tmp_path, monkeypatch):
    """No g++, no packer: the upload path raises instead of packing with
    numpy."""
    from approx_counter_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_builds", {})
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    w = sampled_batch(13, 8, 21, 8, True)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        Engine(Params(k=5, sl=20), "cpu").device_windows(w, 8)


def _reads(seed, n_reads, lo, hi):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, n_reads)
    buf = rng.integers(0, 5, int(lens.sum())).astype(np.uint8)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return buf, offsets


@pytest.mark.parametrize("sn,end,v,gather", [
    (50, False, 0, True),
    (50, True, 2, True),
    (50, True, 2, False),
    (500, False, 2, False),   # sn past the eligible reads: the whole walk
    (0, True, 2, True),
    (1, False, 2, True),
])
def test_sample_windows_matches_jax(sn, end, v, gather, capsys):
    buf, offsets = _reads(14, 400, 5, 120)
    sl = 30
    rngs = [np.random.default_rng(99), np.random.default_rng(99)]
    sinks = [[], []]
    got = sample_windows(Reads(buf=buf, offsets=offsets), sn, sl, end=end,
                         rng=rngs[0], pad_to=1, v=v, warn_sink=sinks[0],
                         gather=gather)
    want = jax_sample(JaxReads(buf=buf, offsets=offsets), sn, sl, end=end,
                      rng=rngs[1], pad_to=1, v=v, warn_sink=sinks[1],
                      gather=gather)
    assert capsys.readouterr().err == ""  # every warning went to the sinks
    assert sinks[0] == sinks[1]
    assert bool(sinks[0]) == (v >= 2 and sn > 0)
    assert got.n_valid == want.n_valid
    np.testing.assert_array_equal(got.chosen, want.chosen)
    if gather:
        np.testing.assert_array_equal(got.windows, want.windows)
    else:
        assert got.windows is None is want.windows
    assert rngs[0].bit_generator.state == rngs[1].bit_generator.state
    assert rngs[0].integers(1 << 62) == rngs[1].integers(1 << 62)


# --- dispatch and finish ----------------------------------------------------


def test_a_failed_pass_raises_from_finish(tmp_path, monkeypatch):
    """An exception on the worker thread comes out of ``finish()``, and a
    run whose pass fails raises it; nothing carries on."""
    engine = Engine(Params(k=5, sl=20), "cpu")

    def broken(*args):
        raise RuntimeError("pass failed")

    monkeypatch.setattr(engine, "_count", broken)
    pending = engine.start_pass(sampled_batch(15, 8, 21, 8, True), 8)
    with pytest.raises(RuntimeError, match="pass failed"):
        pending.finish()
    monkeypatch.setattr(Engine, "_count", broken)
    fa = tmp_path / "r.fasta"
    fa.write_text("".join(f">r{i}\n{'ACGTTGCA' * 8}\n" for i in range(6)))
    with pytest.raises(RuntimeError, match="pass failed"):
        run_pipeline(Params(input_file=str(fa), output=str(tmp_path / "o"),
                            k=5, sl=20, sn=6, v=0, seed=1), device="cpu")
    assert not list(tmp_path.glob("o_*"))


def test_a_failed_run_waits_for_its_prefetched_pass(tmp_path, monkeypatch):
    """A run whose start pass fails while its end pass is prefetched waits
    for the end pass before it raises, and leaves no thread of its engine
    running: no pass outlives ``run_pipeline``."""
    import threading
    import time

    count, calls, returned = Engine._count, [], []

    def failing_start(self, *args):
        calls.append(threading.current_thread())
        if len(calls) == 1:  # the start pass; the end pass is dispatched
            raise RuntimeError("pass failed")
        time.sleep(0.2)
        out = count(self, *args)
        returned.append(threading.current_thread())
        return out

    monkeypatch.setattr(Engine, "_count", failing_start)
    fa = tmp_path / "r.fasta"
    fa.write_text("".join(f">r{i}\n{'ACGTTGCA' * 8}\n" for i in range(6)))
    with pytest.raises(RuntimeError, match="pass failed"):
        run_pipeline(Params(input_file=str(fa), output=str(tmp_path / "o"),
                            k=5, sl=20, sn=6, v=0, seed=1), device="cpu")
    assert len(calls) == 2 and returned == calls[1:]
    assert not calls[0].is_alive()  # the engine's worker thread
    assert not list(tmp_path.glob("o_*"))


def test_count_one_end_counts_on_the_callers_thread(monkeypatch):
    """``count_one_end`` does not count on the calling thread: it is
    ``start_pass(...).finish()``, so its pass runs on the engine's worker
    thread as a dispatched one does, and both give the same."""
    import threading

    engine = Engine(Params(k=5, sl=20, limit=7), "cpu")
    count, threads = Engine._count, []

    def spy(self, *args):
        if self is engine:  # no other engine's pass enters the record
            threads.append(threading.current_thread())
        return count(self, *args)

    monkeypatch.setattr(Engine, "_count", spy)
    batch = sampled_batch(15, 8, 21, 8, True)
    try:
        inline = engine.count_one_end(batch, 8)
        pending = engine.start_pass(batch, 8).finish()
    finally:
        engine.close()
    assert len(threads) == 2 and threads[0] is threads[1]
    assert threads[0] is not threading.current_thread()
    for a, b in zip(inline[:2], pending[:2]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert inline[2] == pending[2]


@pytest.mark.parametrize("mode", ["mr2", "from_exact", "multihost"])
def test_every_segment_runs_on_the_worker_thread(tmp_path, monkeypatch,
                                                 mode):
    """Through the CLI's ``run`` on the CPU, every segment of every pass
    (``_FusedGraph.run``) runs on the engine's worker thread and none on
    the calling one: ``-mr 2`` (pipelined passes), ``--from-exact`` (the
    resume pass) and a one-rank ``--multihost`` run (both ends in
    flight)."""
    import threading

    from approx_counter_tpu_torch import pipeline
    from approx_counter_tpu_torch.__main__ import run
    from approx_counter_tpu_torch.config.cli import resolve_params

    rng = np.random.default_rng(23)
    fa = tmp_path / "r.fasta"
    fa.write_text("".join(
        f">r{i}\n{''.join('ACGT'[c] for c in rng.integers(0, 4, 90))}\n"
        for i in range(40)))
    argv = [str(fa), "-k", "6", "-sl", "30", "-sn", "30", "-lim", "10",
            "-v", "0", "--seed", "4"]
    if mode == "from_exact":
        assert run(resolve_params(argv + ["-o", str(tmp_path / "a"), "-e",
                                          str(tmp_path / "e")]), "cpu") == 0
    extra = {"mr2": ["-mr", "2"],
             "from_exact": ["--from-exact", str(tmp_path / "e_0.start")],
             "multihost": ["--multihost"]}[mode]
    run_seg, threads = pipeline._FusedGraph.run, []

    def spy(self, *values):
        threads.append(threading.current_thread())
        return run_seg(self, *values)

    monkeypatch.setattr(pipeline._FusedGraph, "run", spy)
    prm = resolve_params(argv + extra + ["-o", str(tmp_path / "o")])
    assert run(prm, "cpu") == 0
    assert len(threads) == (4 if mode == "mr2" else 2)
    assert threading.current_thread() not in threads
    assert all(t.name.startswith("pass") for t in threads)
