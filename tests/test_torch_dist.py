"""The port's ``dist/`` package on the CPU vs the JAX package's, in process.

The same seeded inputs go through both: the global bottom-k cut
(``select_from_gathered``, ``global_bottomk_mask``), the 64-bit priority
draws, the streaming bottom-k sampler at one process, the sharded counts at
world size 1 and the whole multihost orchestrator, whose exports, stderr
and stdout (timestamps stripped) must be byte-equal to the JAX
orchestrator's on the conftest's 8 virtual devices.  No tolerance: every
comparison is exact.  Runs of several processes are
``test_torch_multiprocess.py``'s.
"""

import gzip
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from approx_counter_tpu.dist import sampling as jax_sampling  # noqa: E402
from approx_counter_tpu.dist.multihost import (  # noqa: E402
    run_pipeline_multihost as jax_run_multihost,
)
from approx_counter_tpu.io.fastx import read_fastx as jax_read_fastx  # noqa: E402
from approx_counter_tpu.params import Params as JaxParams  # noqa: E402
from approx_counter_tpu_torch.dist import sampling  # noqa: E402
from approx_counter_tpu_torch.dist.multihost import (  # noqa: E402
    run_pipeline_multihost,
    shard_paths,
)
from approx_counter_tpu_torch.io.fastx import Reads  # noqa: E402
from approx_counter_tpu_torch.params import Params  # noqa: E402
from test_torch_modes import _normalize  # noqa: E402
from test_torch_pipeline import _write_fasta, jax_numpy_paths  # noqa: E402,F401

PAD = np.uint64(0xFFFFFFFFFFFFFFFF)


# --- the global cut ---------------------------------------------------------


def _gathered(rng, pc, sn, n_local, pool):
    """[pc, sn] uint64: rank r's first ``n_local[r]`` entries are sorted
    draws from ``pool`` (few values, so ties), the rest the pad."""
    gp = np.full((pc, sn), PAD, np.uint64)
    for r, n in enumerate(n_local):
        gp[r, :n] = np.sort(rng.choice(pool, int(n)))
    return gp


def test_select_from_gathered_splits_ties_by_rank():
    gp = np.array([[1, 5, 5, PAD], [5, 5, 9, PAD]], np.uint64)
    # cutoff 5: the 1 is in, 3 slots for 4 tied 5s, rank 0 first
    for fn in (sampling.select_from_gathered,
               jax_sampling.select_from_gathered):
        np.testing.assert_array_equal(fn(gp, 4), [3, 1])
        np.testing.assert_array_equal(fn(gp, 6), [3, 3])  # all real entries


@pytest.mark.parametrize("seed", range(8))
def test_select_from_gathered_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pc, sn = int(rng.integers(2, 6)), int(rng.integers(1, 12))
    n_local = rng.integers(0, sn + 1, pc)
    pool = rng.integers(0, 1 << 64, int(rng.integers(1, 6)), dtype=np.uint64)
    gp = _gathered(rng, pc, sn, n_local, pool)
    got = sampling.select_from_gathered(gp, sn)
    np.testing.assert_array_equal(got, jax_sampling.select_from_gathered(gp, sn))
    assert got.sum() == min(sn, n_local.sum())
    assert (got <= n_local).all()
    # the low 32 bits, as the processes exchange them (pads count as real)
    g32 = gp.astype(np.uint32)
    np.testing.assert_array_equal(sampling.select_from_gathered(g32, sn),
                                  jax_sampling.select_from_gathered(g32, sn))


class _Sent(Exception):
    """Carries the array a rank hands to the all-gather."""


def _sent(module, monkeypatch, prio, sn, pc, rank):
    def capture(local):
        raise _Sent(local)

    monkeypatch.setattr(module, "_allgather_rows", capture)
    with pytest.raises(_Sent) as e:
        module.global_bottomk_mask(prio, sn, pc, rank)
    return e.value.args[0]


@pytest.mark.parametrize("seed", range(6))
def test_global_bottomk_mask_matches_jax(monkeypatch, seed):
    """Every rank's mask and kept counts.  What a rank sends travels as the
    collective carries it: through ``process_allgather`` with JAX's 64-bit
    types off (``jnp.asarray``: the low 32 bits) for the JAX package, as
    the same bits through ``torch.distributed.all_gather`` for the port."""
    rng = np.random.default_rng(100 + seed)
    pc, sn = int(rng.integers(2, 5)), int(rng.integers(1, 10))
    pool = rng.integers(0, 1 << 64, int(rng.integers(2, 12)), dtype=np.uint64)
    pool[0] = pool[1] + np.uint64(1 << 32)  # equal low 32 bits
    prios = [np.sort(rng.choice(pool, int(rng.integers(0, sn + 1))))
             for _ in range(pc)]
    results = {}
    for module, carry in ((jax_sampling, lambda a: np.asarray(jnp.asarray(a))),
                          (sampling, lambda a: a)):
        rows = np.stack([carry(_sent(module, monkeypatch, p, sn, pc, r))
                         for r, p in enumerate(prios)])
        monkeypatch.setattr(module, "_allgather_rows", lambda local: rows)
        results[module.__name__] = [
            module.global_bottomk_mask(p, sn, pc, r)
            for r, p in enumerate(prios)]
    want, got = results.values()
    for (wm, wk), (gm, gk) in zip(want, got):
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gk, wk)
    one = sampling.global_bottomk_mask(prios[0], sn, 1, 0)
    assert one[0].all() and one[1].tolist() == [len(prios[0])]


# --- the draws and the heap -------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_batched_draws_equal_scalar_draws(seed):
    """One ``integers`` call of size 2n per chunk gives the scalar calls'
    values in order, and leaves the generator where they leave it."""
    batched, scalar = np.random.default_rng(seed), np.random.default_rng(seed)
    for n in (1, 3, 250, 1):
        got = batched.integers(0, 1 << 64, size=2 * n, dtype=np.uint64)
        want = np.array([scalar.integers(0, 1 << 64, dtype=np.uint64)
                         for _ in range(2 * n)], np.uint64)
        np.testing.assert_array_equal(got[0::2], want[0::2])
        np.testing.assert_array_equal(got[1::2], want[1::2])
        assert got.max() >= np.uint64(1 << 63) or n < 100
    assert (batched.integers(0, 1 << 64, dtype=np.uint64)
            == scalar.integers(0, 1 << 64, dtype=np.uint64))


class _ListRng:
    """Hands out fixed priorities, one per call, as ``integers`` would."""

    def __init__(self, values):
        self.values = iter(values)

    def integers(self, *args, **kwargs):
        return np.uint64(next(self.values))


@pytest.mark.parametrize("sn,end,chunks", [(3, False, (5, 9, 1, 7)),
                                           (5, True, (20, 2)),
                                           (1, True, (4, 4, 4, 10)),
                                           (0, False, (6,)),
                                           (30, False, (8, 8))])
def test_bottomk_keeps_the_heaps_items_under_repeats(sn, end, chunks):
    """Priorities from 4 values, so most are repeats: the kept set is the
    JAX heap's (a later read replaces only on a strictly smaller
    priority), in its order, with the same windows."""
    rng = np.random.default_rng(sn + 10 * end)
    n = sum(chunks)
    prio = rng.choice(np.array([3, 9, 9 << 40, 1 << 63], np.uint64), n)
    seqs = [rng.integers(0, 5, int(rng.integers(24, 40))).astype(np.uint8)
            for _ in range(n)]
    want = jax_sampling._BottomK(sn, 10, end, _ListRng(prio))
    for s in seqs:
        want.offer(s)
    got = sampling._BottomK(sn, 10, end)
    first = 0
    for size in chunks:
        batch = seqs[first:first + size]
        reads = Reads(buf=np.concatenate(batch),
                      offsets=np.concatenate([[0], np.cumsum(
                          [len(s) for s in batch])]).astype(np.int64))
        got.offer(reads, np.arange(size), prio[first:first + size])
        first += size
    w_prio, _, w_wins = want.items()
    g_prio, g_wins = got.items()
    np.testing.assert_array_equal(g_prio, w_prio)
    assert len(g_wins) == len(w_wins) == min(sn, n)
    for g, w in zip(g_wins, w_wins):
        np.testing.assert_array_equal(g, w)
    assert got.n_offered == want.n_offered == n


# --- the sampler at one process ---------------------------------------------


def _shards(tmp_path, gz=True):
    """Two shard files, the second gzip, with reads shorter than sl and
    shorter than 2 sl among them."""
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    _write_fasta(a, 21, 45, 10, 140, n_frac=0.01)
    _write_fasta(b, 22, 30, 50, 200, wrap=60)
    if not gz:
        return [str(a), str(b)]
    with open(b, "rb") as f, gzip.open(str(b) + ".gz", "wb") as g:
        g.write(f.read())
    return [str(a), str(b) + ".gz"]


@pytest.mark.parametrize("sn,chunk_size,end_is_start", [
    (20, 1 << 22, False),
    (20, 97, False),
    (7, 300, True),
    (500, 1 << 22, False),  # above the eligible count: every eligible read
    (0, 1 << 22, False),
])
def test_distributed_sample_windows_matches_jax(tmp_path, capsys, sn,
                                                chunk_size, end_is_start):
    paths = _shards(tmp_path)
    out = []
    for module in (jax_sampling, sampling):
        res = module.distributed_sample_windows(
            paths, sn, 30, rng=np.random.default_rng(5), process_count=1,
            process_index=0, row_mult=8, chunk_size=chunk_size,
            end_is_start=end_is_start, v=2)
        out.append((res, capsys.readouterr().err))
    (w_start, w_end, w_n, w_g), w_err = out[0]
    (g_start, g_end, g_n, g_g), g_err = out[1]
    assert g_err == w_err and "Cut size is longer" in w_err
    assert (g_n, g_g) == (w_n, w_g) == (75, (g_start.n_valid, g_end.n_valid))
    for g, w in ((g_start, w_start), (g_end, w_end)):
        assert g.n_valid == w.n_valid
        np.testing.assert_array_equal(g.windows, w.windows)
    n_elig = sum(int((jax_read_fastx(p).lengths >= 60).sum()) for p in paths)
    assert 0 < n_elig < 75
    assert g_start.n_valid == g_end.n_valid == min(sn, n_elig)


def test_shard_paths_deal_files_round_robin():
    paths = [f"f{i}" for i in range(7)]
    assert shard_paths(paths, 1, 3) == ["f1", "f4"]
    assert sorted(sum((shard_paths(paths, r, 3) for r in range(3)), [])) == paths
    assert shard_paths(paths, 0, 1) == paths


# --- the counting step at world size 1 --------------------------------------


def test_sharded_counts_and_full_step_at_one_rank():
    """Without a process group ``approx_counts_sharded`` is ``approx_counts``
    and ``full_step`` on an engine built as the multihost orchestrator
    builds it (``sharded=True``) is ``Engine.count_one_end``."""
    from approx_counter_tpu_torch.dist.mesh import (
        approx_counts_sharded,
        full_step,
        process_count,
    )
    from approx_counter_tpu_torch.kernels.bpm import approx_counts, build_peq
    from approx_counter_tpu_torch.pipeline import Engine

    assert process_count() == 1
    rng = np.random.default_rng(9)
    k = 8
    codes = torch.from_numpy(rng.integers(0, 1 << 16, 40).astype(np.int64))
    wins = rng.integers(0, 6, (30, 64)).astype(np.uint8)
    valid = torch.from_numpy(rng.random(64) < 0.9)
    args = (build_peq(codes, k), torch.from_numpy(wins), valid, k, 2)
    assert torch.equal(approx_counts_sharded(*args), approx_counts(*args))

    windows = rng.integers(0, 4, (48, 25)).astype(np.uint8)
    windows[40:] = 5
    prm = Params(k=k, sl=24, limit=12)
    want = Engine(prm, "cpu").count_one_end(windows, 40)
    got = full_step(Engine(prm, "cpu", sharded=True), windows, 40)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    assert got[2] == want[2]


NCCL = "cpu:gloo,cuda:nccl"


@pytest.mark.parametrize("env,n_dev,pid,nproc,want", [
    # torchrun's local rank and local size win over explicit arguments
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2", "WORLD_SIZE": "4"}, 2,
     3, 4, (1, NCCL)),
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, 1, None, None,
     (0, "gloo")),
    # explicit arguments: the rank picks the card, the count the backend
    ({}, 4, 3, 4, (3, NCCL)),
    ({}, 2, 3, 4, (1, "gloo")),
    ({}, 1, 1, 2, (0, "gloo")),
    # neither: rank 0 of WORLD_SIZE
    ({}, 8, None, None, (0, NCCL)),
    ({"WORLD_SIZE": "2"}, 1, None, None, (0, "gloo")),
])
def test_cuda_layout_picks_the_card_and_backend(env, n_dev, pid, nproc,
                                                want):
    from approx_counter_tpu_torch.dist.mesh import cuda_layout

    assert cuda_layout(env, n_dev, pid, nproc) == want


def test_rank_device_follows_the_rank_without_torchrun(monkeypatch):
    """Ranks started by hand (no ``LOCAL_RANK``) take the card of their
    rank, not all ``cuda:0``; a host without a card raises."""
    from approx_counter_tpu_torch.dist import mesh

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh.rank_device(5) == torch.device("cuda", 2)
    assert mesh.rank_device() == torch.device("cuda", 0)  # no group: rank 0
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh.rank_device(5) == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.rank_device(0)


# --- the whole run --------------------------------------------------------


def run_both(tmp_path, capsys, paths, **kw):
    """Both packages' multihost orchestrator at one process on the same shard
    files and params; per package (rc, stdout, stderr, {file: bytes})."""
    outputs = {}
    for tag, run in (("jax", lambda p: jax_run_multihost(JaxParams(**p))),
                     ("torch", lambda p: run_pipeline_multihost(
                         Params(**p), device="cpu"))):
        d = tmp_path / tag
        d.mkdir()
        prm = dict(kw, input_file=",".join(paths), multihost=True,
                   output=str(d / "out.txt"), exact_out=str(d / "exact.txt"))
        rc = run(prm)
        cap = capsys.readouterr()
        files = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
        outputs[tag] = (rc, _normalize(cap.out), cap.err, files)
    return outputs["jax"], outputs["torch"]


CASES = {
    # sub-sampled top-N over a plain and a gzip shard, Ns, short reads
    "top_n_two_shards": dict(prm=dict(k=9, sl=30, sn=40, limit=20, v=1,
                                      seed=3), files=4),
    # one file, sn above the read count: the clamp warning
    "one_file_clamp": dict(prm=dict(k=8, sl=25, sn=500, limit=15, v=1,
                                    seed=1), one_file=True, files=4),
    "sk2": dict(prm=dict(k=8, sl=30, sn=50, limit=15, solid_km=2, v=1,
                         seed=4), files=4),
    "from_exact": dict(prm=dict(k=9, sl=30, sn=40, limit=20, v=1, seed=2),
                       resume=True, files=2),
    # the reference's skip_end bug: muted, the end pass re-samples starts
    "quirks_se_v0": dict(prm=dict(k=8, sl=25, sn=30, limit=25, skip_end=True,
                                  compat_quirks=True, v=0, seed=5), files=4),
    # -mr 2 at -v 2: per-run streams, [stats] lines, short-read warnings
    "mr2_v2": dict(prm=dict(k=8, sl=30, sn=35, limit=12, nb_of_runs=2, v=2,
                            seed=6), files=8),
    # two-word codes, a forbidden list, --max-error 3
    "k17_fk_maxerr3": dict(prm=dict(k=17, sl=40, sn=30, limit=25, max_error=3,
                                    v=1, seed=8), forbid=True, files=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_pipeline_multihost_matches_jax(tmp_path, capsys, case):
    cfg = CASES[case]
    paths = _shards(tmp_path)
    if cfg.get("one_file"):
        paths = paths[:1]
    prm = dict(cfg["prm"])
    if cfg.get("forbid"):
        (tmp_path / "forbid.txt").write_text(
            "ACGTCCTAGCATTGCAG\nCGTCCTAGCATTGCAGG\n")
        prm["forbid_kmer"] = str(tmp_path / "forbid.txt")
    if cfg.get("resume"):
        d = tmp_path / "prior"
        d.mkdir()
        assert jax_run_multihost(JaxParams(
            **prm, input_file=",".join(paths), multihost=True,
            output=str(d / "o"), exact_out=str(d / "e"))) == 0
        capsys.readouterr()
        prm["from_exact"] = str(d / "e_0.start")
    want, got = run_both(tmp_path, capsys, paths, **prm)
    assert want[0] == got[0] == 0
    assert got[1] == want[1]  # stdout, timestamps stripped
    assert got[2] == want[2]  # stderr
    assert list(got[3]) == list(want[3])
    assert len(want[3]) == cfg["files"]
    for name, data in want[3].items():
        assert got[3][name] == data, name
        assert data, name


def test_identity_sampling_equals_the_whole_file(tmp_path, capsys):
    """Above the eligible count the sample is every eligible read of both
    shards, so the two-shard run exports what a run on their concatenation
    exports."""
    paths = _shards(tmp_path, gz=False)
    whole = tmp_path / "whole.fasta"
    whole.write_bytes(b"".join(open(p, "rb").read() for p in paths))
    n_reads = len(jax_read_fastx(str(whole)))
    prm = dict(k=8, sl=30, sn=500, limit=15, v=0, seed=1, multihost=True)
    files = []
    for name, inputs in (("shards", ",".join(paths)), ("whole", str(whole))):
        assert run_pipeline_multihost(Params(
            **prm, input_file=inputs, output=str(tmp_path / name),
            exact_out=str(tmp_path / f"{name}_e")), device="cpu") == 0
        files.append([(tmp_path / f"{name}{s}_0.{e}").read_bytes()
                      for s in ("", "_e") for e in ("start", "end")])
    assert files[0] == files[1] and all(files[0])
    assert capsys.readouterr().err.count("Sequence set too small") == 2
    assert n_reads == 75


def test_missing_resume_file_multihost_like_jax(tmp_path, capsys,
                                                monkeypatch):
    """``--multihost`` with a missing ``--from-exact`` file: the JAX CLI's
    exit code and stderr, ``COULD NOT OPEN FILE 2``."""
    from approx_counter_tpu.__main__ import main as jax_main
    from approx_counter_tpu_torch.__main__ import run as torch_cli_run
    from approx_counter_tpu_torch.config.cli import resolve_params

    monkeypatch.setenv("APPROX_COUNTER_CACHE", "off")
    paths = _shards(tmp_path)
    argv = [",".join(paths), "--multihost", "-o", str(tmp_path / "o"),
            "--from-exact", str(tmp_path / "missing.txt"), "-k", "9", "-sl",
            "30", "-v", "0"]
    assert jax_main(argv) == 1
    want = capsys.readouterr()
    assert torch_cli_run(resolve_params(argv), "cpu") == 1
    got = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)
    assert got.err == "/!\\ ERROR: COULD NOT OPEN FILE 2\n"
