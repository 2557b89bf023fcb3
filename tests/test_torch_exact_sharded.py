"""The multihost step's exact stage on 2 and 4 gloo ranks in subprocesses,
against the JAX package's exact stage on the whole batch.

Each case is one seeded window batch dealt to the ranks row by row; each
rank counts only its rows, and every rank's selection, ``n_unique``,
``n_pass``, ``n_keep`` and ``had_n`` must equal
``exact_count_select_rows`` on every row at once, with no tolerance:
they are integers. Each case runs a sharded engine's whole fixed-cap
pass (``Engine(sharded=True)._count``: the three segments of
``dist/mesh.py``, the collectives on the passes' own process group, one
fetch), whose approximate ranking must also equal the single-device pass
on the whole batch, and which may reach the host only through its one
fetch per run (``Tensor.item``, ``tolist``, ``cpu`` and ``numpy`` raise
inside it). The cases cover top-N and solid mode, k = 9, 16 and 32
(negative int64 codes), a forbidden list, ties in count at the ``limit``
cut, a rank with no valid windows, a rank with no rows, no valid window
at all, Ns in the windows, and an owner hash replaced by a constant, so
that one rank owns every code and its bucket overflows: the step reruns
at a doubled bucket, and every rank reruns alike. One more case runs
``full_step`` on each rank with ``gather_windows`` made to raise and
records what each rank's engine uploads: its own rows only, with the
single-device pass's result.

One process group per rank count runs every case (importing torch takes
seconds a process); every init and ``communicate`` has a timeout.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu.core.codec import join_code, split_code  # noqa: E402
from approx_counter_tpu.core.complexity import (  # noqa: E402
    adjust_threshold,
    lc_sum_threshold,
)
from approx_counter_tpu.count.exact import exact_count_select_rows  # noqa: E402
from test_multiprocess import _free_port  # noqa: E402
from test_torch_exact import _windows  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180  # seconds per rank, init and run
RANKS = (2, 4)

WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
repo, pid, nproc, port, case_dir = sys.argv[1:6]
sys.path.insert(0, repo)
from approx_counter_tpu_torch import pipeline
from approx_counter_tpu_torch.dist import mesh
from approx_counter_tpu_torch.params import Params
from approx_counter_tpu_torch.pipeline import Engine
mesh.initialize(f"tcp://127.0.0.1:{port}", int(nproc), int(pid),
                device_type="cpu", timeout=120)
rank, n = int(pid), int(nproc)
mix = mesh.owner_rank


def no_gather(*a, **kw):
    raise AssertionError("full_step all-gathered the ranks' windows")


def full_step_case(case, wins, valid):
    uploads = []
    real = Engine.device_windows

    def spy(self, windows, n_valid):
        uploads.append([list(windows.shape), int(n_valid)])
        return real(self, windows, n_valid)

    # this rank's valid rows first, then two pad rows
    mine = np.concatenate([wins[valid], np.full((2, wins.shape[1]), 5,
                                                np.uint8)])
    Engine.device_windows, mesh.gather_windows = spy, no_gather
    engine = Engine(Params(**case["prm"]), "cpu", sharded=True)
    try:
        (ec, ecnt), (ac, acnt), stats = mesh.full_step(
            engine, mine, int(valid.sum()))
    finally:
        engine.close()
        Engine.device_windows = real
    traffic.extend(engine.traffic)
    return dict(exact_codes=ec, exact_counts=ecnt, approx_codes=ac,
                approx_counts=acnt), dict(stats, uploads=uploads,
                                          shard=[list(mine.shape),
                                                 int(valid.sum())])


SYNCS = ("item", "tolist", "cpu", "numpy")
saved = {name: getattr(torch.Tensor, name) for name in SYNCS}
fetch = pipeline._fetch


def refuse(name):
    def method(self, *a, **kw):
        raise AssertionError(f"Tensor.{name} before the pass's fetch")
    return method


def engine_case(case, wins, valid, forbidden):
    # the case through a sharded engine's whole pass, every host sync but
    # its fetch refused: its results, the survivors of the owners' filters,
    # the fetches and the sizes it ran at
    fetches = []

    def one_fetch(t):
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
        fetches.append(1)
        out = fetch(t)
        for name in SYNCS:
            setattr(torch.Tensor, name, refuse(name))
        return out

    prm = Params(k=case["k"], sl=wins.shape[1] - 1, limit=case["limit"],
                 solid_km=case["solid_km"], param_lc=2.0)
    engine = Engine(prm, "cpu", sharded=True)
    engine.forbidden = torch.from_numpy(forbidden.view(np.int64))
    windows_t = torch.from_numpy(np.ascontiguousarray(wins.T))
    positions = engine._positions(wins.shape)
    pipeline._fetch = one_fetch
    for name in SYNCS:
        setattr(torch.Tensor, name, refuse(name))
    try:
        (ec, ecnt), (ac, acnt), stats = engine._count(
            windows_t, torch.from_numpy(valid), positions)
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
        pipeline._fetch = fetch
        engine.close()
    (report,) = engine.traffic
    traffic.append(report)
    return dict(codes=ec, counts=ecnt, approx_codes=ac,
                approx_counts=acnt), dict(stats, n_pass=report["n_pass"],
                                          fetches=len(fetches),
                                          sizes=report["sizes"])


traffic = []


try:
    with open(f"{case_dir}/cases.json") as f:
        cases = json.load(f)
    for case in cases:
        d = np.load(f"{case_dir}/{case['name']}.npz")
        rows = d[f"shard{n}"] == rank
        wins, valid = d["windows"][rows], d["valid"][rows]
        if case.get("full_step"):
            arrays, scalars = full_step_case(case, wins, valid)
        else:
            mesh.owner_rank = ((lambda codes, n_ranks: torch.zeros_like(
                codes)) if case["one_owner"] else mix)
            arrays, scalars = engine_case(case, wins, valid, d["forbidden"])
        np.savez(f"{case_dir}/{case['name']}.rank{rank}.out.npz", **arrays)
        with open(f"{case_dir}/{case['name']}.rank{rank}.json", "w") as f:
            json.dump(scalars, f)
    print("@@ traffic", json.dumps(traffic), flush=True)
finally:
    torch.distributed.destroy_process_group()
"""


def _lc_thr(k, param_lc=2.0):
    return int(lc_sum_threshold(adjust_threshold(param_lc, 16, k), k))


def _jax_exact(wins_t, valid, k, lc_thr, forbidden, limit, solid_km):
    """The JAX package's exact stage on the whole batch: (codes u64, counts
    u64, n_unique, n_pass, n_keep, had_n)."""
    fhi, flo = split_code(forbidden)
    ex = exact_count_select_rows(
        wins_t, valid, k, np.int32(lc_thr), fhi, flo, np.int32(limit),
        np.int32(solid_km), cap=4096,
        n_forbidden=len(forbidden), use_solid=solid_km > 0, transposed=True)
    n_keep = int(ex["n_keep"])
    codes = join_code(np.asarray(ex["sel_hi"])[:n_keep],
                      np.asarray(ex["sel_lo"])[:n_keep])
    counts = np.asarray(ex["sel_count"])[:n_keep].astype(np.uint64)
    return dict(codes=codes, counts=counts, n_unique=int(ex["n_unique"]),
                n_pass=int(ex["n_pass"]), n_keep=n_keep,
                had_n=int(ex["had_n"]))


def _deal(valid, kind, seed):
    """Row -> rank for each rank count.  ``mixed``: at random;
    ``invalid_last``: the last rank holds only invalid rows (and every
    invalid row); ``none_last``: the last rank holds no row."""
    rng = np.random.default_rng(seed)
    out = {}
    for n in RANKS:
        if kind == "mixed":
            out[f"shard{n}"] = rng.integers(0, n, len(valid))
        elif kind == "invalid_last":
            out[f"shard{n}"] = np.where(valid, rng.integers(0, n - 1,
                                                            len(valid)), n - 1)
        else:
            out[f"shard{n}"] = rng.integers(0, n - 1, len(valid))
    return out


#: name -> (k, solid_km, limit, shard kind, one owner, forbidden, GT-rich)
CASES = {
    "top_k16_ties": (16, 0, 40, "mixed", False, False, False),
    "top_k9_forbidden": (9, 0, 40, "mixed", False, True, False),
    "top_k32": (32, 0, 40, "mixed", False, False, True),
    "top_k16_rank_without_valid_windows": (16, 0, 40, "invalid_last", False,
                                           False, False),
    "top_k16_one_owner": (16, 0, 40, "mixed", True, False, False),
    "top_k9_limit_above_n_pass": (9, 0, 100000, "mixed", False, False,
                                  False),
    "top_k16_nothing_valid": (16, 0, 40, "mixed", False, False, False),
    "solid_k16": (16, 2, 40, "mixed", False, False, False),
    "solid_k32": (32, 2, 40, "mixed", False, True, True),
    "solid_k9_rank_without_rows": (9, 2, 40, "none_last", False, False,
                                   False),
    "solid_k32_one_owner": (32, 2, 40, "mixed", True, False, True),
    # nearly every k-mer distinct: one owner gets more than a bucket holds
    "top_k16_one_owner_distinct": (16, 0, 40, "mixed", True, False, False),
    "solid_k9_one_owner_distinct": (9, 1, 40, "mixed", True, True, False),
}

#: the ``full_step`` case's parameters and batch
FULL_STEP = dict(k=8, sl=24, limit=12)


def _distinct_windows(seed, n=96, m=41):
    """``[m, n]`` random windows, ~1% N, the last 5 rows invalid: nearly
    every k-mer of k >= 9 occurs once."""
    rng = np.random.default_rng(seed)
    wins = rng.integers(0, 4, (n, m)).astype(np.uint8)
    wins[rng.random((n, m)) < 0.01] = 4
    row_mask = np.ones(n, bool)
    row_mask[-5:] = False
    wins[-5:] = 5
    return np.ascontiguousarray(wins.T), row_mask


def _write_cases(d):
    """Writes every case's batch and ``cases.json`` under ``d``; returns
    {case: the JAX package's result on the whole batch}."""
    cases, want = [], {}
    for i, (name, (k, solid_km, limit, kind, one_owner, with_forbidden,
                   gt)) in enumerate(CASES.items()):
        wins_t, valid = _windows(100 + i, n=96, pair=(2, 3) if gt else (0, 3))
        if name.endswith("_distinct"):
            wins_t, valid = _distinct_windows(100 + i)
        if name.endswith("nothing_valid"):
            valid[:] = False
        lc_thr = _lc_thr(k)
        forbidden = np.empty(0, np.uint64)
        if with_forbidden:  # two selected codes and one never seen
            first = _jax_exact(wins_t, valid, k, lc_thr, forbidden, limit,
                               solid_km)["codes"]
            forbidden = np.array(sorted({int(first[0]), int(first[-1]),
                                         (1 << (2 * k)) - 2}), np.uint64)
        np.savez(d / f"{name}.npz", windows=np.ascontiguousarray(wins_t.T),
                 valid=valid, forbidden=forbidden,
                 **_deal(valid, kind, i))
        cases.append(dict(name=name, k=k, lc_thr=lc_thr, limit=limit,
                          solid_km=solid_km, one_owner=one_owner))
        want[name] = _jax_exact(wins_t, valid, k, lc_thr, forbidden, limit,
                                solid_km)
    rng = np.random.default_rng(11)
    wins = rng.integers(0, 4, (90, FULL_STEP["sl"] + 1)).astype(np.uint8)
    wins[rng.random(wins.shape) < 0.01] = 4
    wins[1::4] = wins[0]  # repeats: counts above one
    np.savez(d / "full_step.npz", windows=wins, valid=np.ones(90, bool),
             **_deal(np.ones(90, bool), "mixed", 99))
    cases.append(dict(name="full_step", full_step=True, prm=FULL_STEP))
    with open(d / "cases.json", "w") as f:
        json.dump(cases, f)
    return want


def _communicate(procs):
    """(rc, stdout, stderr) of every process; kills them all on a hang."""
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            results.append((p.returncode, out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both rank counts' process groups, started together while the JAX
    references are computed: ``(want, {n: (directory, traffic of each
    rank)})``."""
    dirs, procs = {}, {}
    d0 = tmp_path_factory.mktemp("sharded")
    want = _write_cases(d0)
    for n in RANKS:
        dirs[n] = tmp_path_factory.mktemp(f"ranks{n}")
        for f in d0.iterdir():
            (dirs[n] / f.name).write_bytes(f.read_bytes())
        port = str(_free_port())
        procs[n] = [subprocess.Popen(
            [sys.executable, "-c", WORKER, REPO, str(pid), str(n), port,
             str(dirs[n])], stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for pid in range(n)]
    out = {}
    for n in RANKS:
        results = _communicate(procs[n])
        for rc, _, err in results:
            assert rc == 0, err[-3000:]
        out[n] = dirs[n], [json.loads(so.split("@@ traffic ", 1)[1])
                           for _, so, _ in results]
    return want, out


def _rank_result(d, name, rank):
    arrays = dict(np.load(d / f"{name}.rank{rank}.out.npz"))
    with open(d / f"{name}.rank{rank}.json") as f:
        return arrays, json.load(f)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n", RANKS)
def test_sharded_exact_stage_matches_jax_on_the_whole_batch(ranks, n, name):
    want, out = ranks
    d, _ = out[n]
    w = want[name]
    for rank in range(n):
        arrays, scalars = _rank_result(d, name, rank)
        for key in ("n_unique", "n_pass", "n_keep", "had_n"):
            assert scalars[key] == w[key], (rank, key)
        np.testing.assert_array_equal(arrays["codes"].view(np.uint64),
                                      w["codes"])
        np.testing.assert_array_equal(arrays["counts"].astype(np.uint64),
                                      w["counts"])


def test_the_cases_reach_what_they_name(ranks):
    """Ties at the cut, Ns, negative codes, solid selections longer than
    ``limit``, and an empty result where nothing is valid."""
    want, _ = ranks
    ties = _jax_exact(*_tie_case_inputs(), 41, 0)["counts"]
    assert ties[39] == ties[40]
    assert all(want[name]["had_n"] > 0 for name in CASES
               if not name.endswith("nothing_valid"))
    for name in ("top_k32", "solid_k32", "solid_k32_one_owner"):
        assert (want[name]["codes"] >= 1 << 63).any(), name
    assert want["solid_k16"]["n_keep"] > 40
    assert want["top_k16_nothing_valid"]["n_keep"] == 0
    limit_above = want["top_k9_limit_above_n_pass"]
    assert limit_above["n_keep"] == limit_above["n_pass"] > 40


def _tie_case_inputs():
    wins_t, valid = _windows(100, n=96)
    return wins_t, valid, 16, _lc_thr(16), np.empty(0, np.uint64)


@pytest.mark.parametrize("n", RANKS)
def test_owners_split_the_codes(ranks, n):
    """The traffic each rank records (each case's pass, then
    ``full_step``'s): with the mixing hash every rank owns codes and sends
    most of its own away; with one owner only rank 0 owns any."""
    _, out = ranks
    _, traffic = out[n]
    names = list(CASES) + ["full_step"]
    for rank, calls in enumerate(traffic):
        assert [c["rank"] for c in calls] == [rank] * len(names)
        by = dict(zip(names, calls))
        assert by["top_k16_ties"]["owned"] > 0
        assert (by["top_k16_one_owner"]["owned"] > 0) == (rank == 0)
        assert by["top_k16_ties"]["sent"] < by["top_k16_ties"]["local"]
        assert by["top_k16_ties"]["sent"] > 0
    no_rows = [calls[list(CASES).index("solid_k9_rank_without_rows")]
               for calls in traffic]
    assert no_rows[-1]["local"] == 0 and no_rows[-1]["owned"] > 0


@pytest.mark.parametrize("n", RANKS)
def test_every_rank_reruns_alike(ranks, n):
    """Each case's (cap, bucket) reruns are the same on every rank; a
    constant owner hash on nearly distinct k-mers overflows the first
    bucket, so the step reruns at a doubled one (at most one holding every
    position of the largest batch); the mixing hash never reruns at these
    sizes."""
    _, out = ranks
    d, _ = out[n]
    for name, (*_, one_owner, _, _) in CASES.items():
        sizes = [_rank_result(d, name, rank)[1]["sizes"]
                 for rank in range(n)]
        assert all(s == sizes[0] for s in sizes), name
        runs = sizes[0]
        for (cap0, b0), (cap1, b1) in zip(runs, runs[1:]):
            # a bucket doubled (or cut to every position of the largest
            # batch) at the same cap, or else a cap regrown
            assert ((cap0 == cap1 and b0 < b1 <= 2 * b0 and b1 % 128 == 0)
                    or (b0 == b1 and cap0 < cap1)), name
        if name.endswith("_distinct"):
            assert runs[-1][1] > runs[0][1], name
        elif not one_owner:
            assert len(runs) == 1, name


@pytest.fixture(scope="module")
def single_device(ranks):
    """Each case's single-device fused pass on the whole batch (the port's
    ``Engine`` on the CPU, the JAX pass's equal): {case: result}."""
    from approx_counter_tpu_torch.params import Params
    from approx_counter_tpu_torch.pipeline import Engine

    _, out = ranks
    d, _ = out[RANKS[0]]
    with open(d / "cases.json") as f:
        cases = {c["name"]: c for c in json.load(f)}
    got = {}
    for name in CASES:
        case, data = cases[name], np.load(d / f"{name}.npz")
        wins = data["windows"]
        engine = Engine(Params(k=case["k"], sl=wins.shape[1] - 1,
                               limit=case["limit"], solid_km=case["solid_km"],
                               param_lc=2.0), "cpu")
        engine.forbidden = torch.from_numpy(data["forbidden"].view(np.int64))
        try:
            got[name] = engine._count(
                torch.from_numpy(np.ascontiguousarray(wins.T)),
                torch.from_numpy(data["valid"]))
        finally:
            engine.close()
    return got


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n", RANKS)
def test_sharded_engine_pass_matches_jax_and_one_device(ranks, single_device,
                                                        n, name):
    """The engine's whole sharded pass on every rank: the counters and
    approximate ranking of the single-device pass on the whole batch, and
    one fetch per run of the step, the host reached through nothing
    else."""
    want, out = ranks
    d, _ = out[n]
    w = want[name]
    (_, (s_codes, s_counts), s_stats) = single_device[name]
    for rank in range(n):
        arrays, scalars = _rank_result(d, name, rank)
        for key in ("n_unique", "n_keep", "had_n"):
            assert scalars[key] == s_stats[key], (rank, key)
        assert scalars["fetches"] == len(scalars["sizes"])
        np.testing.assert_array_equal(arrays["approx_codes"], s_codes)
        np.testing.assert_array_equal(arrays["approx_counts"], s_counts)


@pytest.mark.parametrize("n", RANKS)
def test_full_step_uploads_only_the_ranks_own_rows(ranks, n):
    """``full_step`` never calls ``gather_windows`` (it raises in the ranks)
    and each rank's engine uploads one batch, its own shard; every rank
    gets the single-device pass's result on the whole batch."""
    from approx_counter_tpu_torch.params import Params
    from approx_counter_tpu_torch.pipeline import Engine

    _, out = ranks
    d, _ = out[n]
    data = np.load(d / "full_step.npz")
    engine = Engine(Params(**FULL_STEP), "cpu")
    try:
        (ec, ecnt), (ac, acnt), stats = engine.count_one_end(
            data["windows"], len(data["windows"]))
    finally:
        engine.close()
    assert len(ec) == FULL_STEP["limit"]
    for rank in range(n):
        arrays, scalars = _rank_result(d, "full_step", rank)
        assert scalars["uploads"] == [scalars["shard"]]
        assert scalars["shard"][1] == int((data[f"shard{n}"] == rank).sum())
        for key in ("n_unique", "n_keep", "had_n"):
            assert scalars[key] == stats[key], key
        np.testing.assert_array_equal(arrays["exact_codes"], ec)
        np.testing.assert_array_equal(arrays["exact_counts"], ecnt)
        np.testing.assert_array_equal(arrays["approx_codes"], ac)
        np.testing.assert_array_equal(arrays["approx_counts"], acnt)
