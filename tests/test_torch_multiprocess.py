"""The port's ``--multihost`` orchestrator in 2 and 4 OS processes, joined by
``torch.distributed`` over gloo on the CPU.

Each rank is a subprocess that calls ``dist/mesh.py:initialize`` once and
then ``run_pipeline_multihost(prm, device="cpu")`` for each of a list of
runs (one process group per rank count, as importing torch dominates a
rank's start).  At identity sampling N ranks must export the bytes of one
rank and of the single-device ``--stream`` run; unbalanced shards must fill
the whole sample; below identity the ranks' exports must equal the JAX
package's own two-process run on the same shards and seed (the per-rank
seeds and draws); and counts all-reduced twice must fail that comparison.
Every process group has an init timeout and every ``communicate`` a
timeout, so a hang fails the test.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_multiprocess import WORKER as JAX_WORKER, _free_port  # noqa: E402
from test_torch_pipeline import _strip_ms  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180  # seconds per rank, init and run

WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
repo, pid, nproc, port, runs_json = sys.argv[1:6]
sys.path.insert(0, repo)
from approx_counter_tpu_torch.dist import mesh
from approx_counter_tpu_torch.dist.multihost import run_pipeline_multihost
from approx_counter_tpu_torch.params import Params
from approx_counter_tpu_torch import pipeline
mesh.initialize(f"tcp://127.0.0.1:{port}", int(nproc), int(pid),
                device_type="cpu", timeout=120)
all_reduce = torch.distributed.all_reduce
events = []
start_pass, finish = pipeline.Engine.start_pass, pipeline._PendingPass.finish


def spy_start(self, *a, **kw):
    events.append("dispatch")
    return start_pass(self, *a, **kw)


def spy_finish(self):
    events.append("fetch")
    return finish(self)


pipeline.Engine.start_pass = spy_start
pipeline._PendingPass.finish = spy_finish


def twice(t, *a, **kw):
    all_reduce(t, *a, **kw)
    all_reduce(t, *a, **kw)


try:
    for name, prm, mode in json.loads(runs_json):
        for stream in (sys.stdout, sys.stderr):
            print(f"@@ {name}", file=stream, flush=True)
        torch.distributed.all_reduce = (twice if mode == "all_reduce_twice"
                                        else all_reduce)
        events.clear()
        rc = run_pipeline_multihost(Params(**prm), device="cpu")
        sys.stdout.flush()
        print(f"@@ rc {rc}", file=sys.stderr, flush=True)
        print(f"@@ events {json.dumps(events)}", file=sys.stderr, flush=True)
finally:
    torch.distributed.destroy_process_group()
"""

#: The JAX two-process worker's fixed parameters (tests/test_multiprocess.py)
COMMON = dict(k=6, sl=12, limit=10, seed=1, multihost=True)


def _seqs(n=20, length=40, seed=1234):
    from approx_counter_tpu.core.codec import codes_to_seq

    rng = np.random.default_rng(seed)
    return [codes_to_seq(rng.integers(0, 4, length)) for _ in range(n)]


def _write_shards(directory, seqs, owner, n_shards):
    """Shard files ``shard<i>.fasta``; read i goes to ``owner(i)``.  Also
    writes every read to ``all.fasta``.  Returns the shard paths."""
    directory.mkdir(exist_ok=True)
    paths = [directory / f"shard{i}.fasta" for i in range(n_shards)]
    files = [open(p, "w") for p in paths]
    with open(directory / "all.fasta", "w") as fall:
        for i, s in enumerate(seqs):
            rec = f">r{i}\n{s}\n"
            fall.write(rec)
            files[owner(i)].write(rec)
    for f in files:
        f.close()
    return [str(p) for p in paths]


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


def run_ranks(n, runs, events=None):
    """``runs``, a list of ``(name, prm, mode)``, one after the other on
    ``n`` gloo ranks -> ``{name: [(rc, stdout, stderr) of each rank]}``.
    ``events`` gets ``{name: [each rank's pass dispatches and fetches, in
    order]}``."""
    port = str(_free_port())
    results = _communicate([
        subprocess.Popen([sys.executable, "-c", WORKER, REPO, str(pid),
                          str(n), port, json.dumps(runs)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(n)])
    for rc, _, err in results:
        assert rc == 0, err[-3000:]
    by_run = {name: [] for name, _, _ in runs}
    for _, out, err in results:
        outs = dict(re.findall(r"^@@ (\w+)\n(.*?)(?=^@@ |\Z)", out,
                               re.S | re.M))
        for name, text in re.findall(r"^@@ (\w+)\n(.*?)(?=^@@ \w+\n|\Z)",
                                     err, re.S | re.M):
            rc = re.search(r"^@@ rc (\d+)\n", text, re.M)
            by_run[name].append((int(rc.group(1)), outs[name],
                                 text[:rc.start()]))
            ev = re.search(r"^@@ events (.*)\n", text, re.M)
            if events is not None:
                events.setdefault(name, []).append(json.loads(ev.group(1)))
    assert all(len(v) == n for v in by_run.values()), by_run
    return by_run


#: The JAX worker on the JAX package's numpy paths: as the in-process
#: tests' ``jax_numpy_paths`` fixture does, its native library reports
#: itself not built, since ``tests/test_io.py`` may be writing it meanwhile.
_IMPORT = "from approx_counter_tpu.params import Params\n"
assert JAX_WORKER.count(_IMPORT) == 1
JAX_NUMPY_WORKER = JAX_WORKER.replace(_IMPORT, (
    "import approx_counter_tpu.io.native as _native\n"
    "def _not_built():\n"
    "    raise ImportError('native library not used')\n"
    "_native._load = _not_built\n") + _IMPORT)


#: The JAX package's orchestrator on its numpy paths, one jax.distributed
#: group running the runs of the JSON list in argv[5] one after the other
#: (as ``WORKER`` does for the port).  Each run's Python-level stdout and
#: stderr go to files of their own under argv[6], so that the notices the
#: collectives' native code prints into the process's stdout stay out.
JAX_RUNS_WORKER = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                           process_id=pid)
sys.path.insert(0, sys.argv[4])
import approx_counter_tpu.io.native as _native
def _not_built():
    raise ImportError('native library not used')
_native._load = _not_built
from approx_counter_tpu.params import Params
from approx_counter_tpu.dist.multihost import run_pipeline_multihost
for name, prm in json.loads(sys.argv[5]):
    stem = f"{sys.argv[6]}/{name}.rank{pid}"
    with open(f"{stem}.out", "w") as out, open(f"{stem}.err", "w") as err:
        sys.stdout, sys.stderr = out, err
        try:
            rc = run_pipeline_multihost(Params(**prm))
        finally:
            sys.stdout, sys.stderr = sys.__stdout__, sys.__stderr__
    with open(f"{stem}.rc", "w") as f:
        f.write(str(rc))
"""


def start_jax_runs(n, runs, out_dir):
    """``JAX_RUNS_WORKER`` on ``n`` processes, started: their Popens."""
    port = str(_free_port())
    env = {k: v_ for k, v_ in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    return [subprocess.Popen(
        [sys.executable, "-c", JAX_RUNS_WORKER, str(pid), str(n), port, REPO,
         json.dumps(runs), str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for pid in range(n)]


def jax_run_results(procs, runs, out_dir):
    """``{run: [(rc, stdout, stderr) of each process]}`` once the processes
    of ``start_jax_runs`` have ended."""
    for rc, _, err in _communicate(procs):
        assert rc == 0, err[-3000:]
    return {name: [tuple([int((out_dir / f"{name}.rank{r}.rc").read_text())]
                         + [(out_dir / f"{name}.rank{r}.{x}").read_text()
                            for x in ("out", "err")])
                   for r in range(len(procs))] for name, _ in runs}


def run_jax_ranks(n, paths, out, exact, sn, v):
    """The JAX package's multihost orchestrator on ``n`` jax.distributed
    processes (tests/test_multiprocess.py's worker)."""
    port = str(_free_port())
    env = {k: v_ for k, v_ in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    script = [sys.executable, "-c", JAX_NUMPY_WORKER]
    tail = [port, REPO, ",".join(paths), out, exact, str(sn), str(v)]
    return _communicate([
        subprocess.Popen(script + [str(pid), str(n)] + tail, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(n)])


def _exports(directory, stem):
    return {p.name[len(stem):]: p.read_bytes()
            for p in sorted(directory.glob(f"{stem}_*"))}


def _assert_ok(results):
    for rc, _, err in results:
        assert rc == 0, err[-3000:]


#: per rank count, the unbalanced case's shard sizes and sn
UNBALANCED = {2: ((3, 17), 10), 4: ((1, 2, 3, 14), 12)}


def _mode_runs(d, n, stem):
    """Runs below identity on shards holding Ns, to hold against the JAX
    orchestrator: ``modes``, -mr 2 -sk 2 -v 2; ``resume``, --from-exact on that
    run's first end export.  Writes the shards the first time."""
    path = d / "modes"
    if not path.exists():
        seqs = _seqs(n=40, seed=7)
        seqs = [s[:3] + "N" + s[4:] if i % 5 == 0 else s
                for i, s in enumerate(seqs)]
        _write_shards(path, seqs, lambda i: i % n, n)
    shards = ",".join(str(path / f"shard{i}.fasta") for i in range(n))

    def prm(name, **kw):
        return dict(COMMON, input_file=shards, sn=25, output=str(
            path / f"{stem}_{name}"), exact_out=str(path / f"{stem}e_{name}"),
            **kw)

    return [("modes", prm("modes", v=2, nb_of_runs=2, solid_km=2)),
            ("resume", prm("resume", v=1, from_exact=str(
                path / f"{stem}e_modes_0.end")))]


def _runs(d, n):
    """The runs of ``n`` ranks, their shards written under ``d``."""
    def prm(case, paths, stem=None, **kw):
        stem = stem or case
        return dict(COMMON, input_file=",".join(paths), output=str(
            d / case / stem), exact_out=str(d / case / f"{stem}e"), **kw)

    ident = _write_shards(d / "identity", _seqs(), lambda i: i % n, n)
    sizes, sn = UNBALANCED[n]
    bounds = np.cumsum(sizes)
    unbal = _write_shards(d / "unbalanced", _seqs(), lambda i: int(
        np.searchsorted(bounds, i, "right")), n)
    runs = [("identity", prm("identity", ident, "mh", sn=100, v=1), "ok"),
            ("unbalanced", prm("unbalanced", unbal, "mh", sn=sn, v=1), "ok")]
    runs += [(name, prm, "ok") for name, prm in _mode_runs(d, n, "mh")]
    if n == 2:
        below = _write_shards(d / "below", _seqs(n=40, seed=99),
                              lambda i: i % 2, 2)
        runs += [
            ("below", prm("below", below, "mh", sn=13, v=1), "ok"),
            ("twice", prm("below", below, "bad", sn=13, v=1),
             "all_reduce_twice"),
            # last: only rank 0 exports, and it fails
            ("export_failure", dict(prm("identity", ident, sn=100, v=0),
                                    output=str(d / "no" / "dir")), "ok")]
    return runs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every run of ``_runs`` at 2 and at 4 ranks, each rank count one
    process group, and meanwhile the JAX orchestrator's ``_mode_runs`` on
    as many processes: ``{n: (directory, {run: results of each rank})}``, with
    ``"events"``: ``{n: {run: each rank's dispatches and fetches}}`` and
    ``"jax"``: ``{n: {run: results of each JAX process}}``."""
    dirs, runs, jax = {}, {}, {}
    for n in (2, 4):
        dirs[n] = tmp_path_factory.mktemp(f"ranks{n}")
        runs[n] = _runs(dirs[n], n)
        jax_runs = _mode_runs(dirs[n], n, "jax")
        jax[n] = (start_jax_runs(n, jax_runs, dirs[n]), jax_runs)
    out = {"events": {}, "jax": {}}
    try:
        for n in (2, 4):
            out[n] = dirs[n], run_ranks(n, runs[n],
                                        out["events"].setdefault(n, {}))
    finally:
        for n in (2, 4):
            out["jax"][n] = jax_run_results(*jax[n], dirs[n])
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_identity_n_ranks_equal_one_rank_and_stream(ranks, tmp_path, capsys,
                                                    n):
    """tests/test_multiprocess.py:48: at identity sampling (sn above the
    read count) every rank count exports the one-rank and the ``--stream``
    bytes; rank 0 prints the one-rank stdout and the other ranks nothing."""
    from approx_counter_tpu_torch.dist.multihost import run_pipeline_multihost
    from approx_counter_tpu_torch.params import Params
    from approx_counter_tpu_torch.pipeline import run_pipeline

    d, by_run = ranks[n]
    d = d / "identity"
    results = by_run["identity"]
    _assert_ok(results)
    shards = ",".join(str(d / f"shard{i}.fasta") for i in range(n))
    prm = dict(COMMON, input_file=shards, sn=100, v=1)
    assert run_pipeline_multihost(Params(**prm, output=str(tmp_path / "one"),
                                         exact_out=str(tmp_path / "onee")),
                                  device="cpu") == 0
    one_out = capsys.readouterr().out
    stream = dict(COMMON, input_file=str(d / "all.fasta"), sn=100,
                  v=0, stream=True, multihost=False)
    assert run_pipeline(Params(**stream, output=str(tmp_path / "s"),
                               exact_out=str(tmp_path / "se")),
                        device="cpu") == 0
    for (ours, od), one, ref in ((("mh", d), "one", "s"),
                                 (("mhe", d), "onee", "se")):
        got = _exports(od, ours)
        assert len(got) == 2
        assert got == _exports(tmp_path, one) == _exports(tmp_path, ref)
    assert "Number of sequences found: 20." in results[0][1]
    assert "Number of sequences found: 20." in one_out
    assert all(out == "" for _, out, _ in results[1:])


@pytest.mark.parametrize("n", [2, 4])
def test_unbalanced_shards_fill_the_budget(ranks, n):
    """tests/test_multiprocess.py:103,155: small shards do not undersample
    the global budget -- rank 0 reports a sample of exactly ``sn``."""
    d, by_run = ranks[n]
    results = by_run["unbalanced"]
    sn = UNBALANCED[n][1]
    _assert_ok(results)
    assert f"Sampled {sn} sequences" in results[0][1]
    assert "Number of sequences found: 20." in results[0][1]
    assert all("Sampled" not in out for _, out, _ in results[1:])
    exact = (d / "unbalanced" / "mhe_0.start").read_text().splitlines()
    total = sum(int(line.split("\t")[1]) for line in exact)
    # sn start windows of 12 bases, k=6 -> at most 7 k-mers each
    assert 0 < total <= 7 * sn


def _program_lines(stdout):
    """The run's own lines of a stdout, timestamps stripped: the parameter
    echo before the first timestamped line, then every timestamped line.
    The JAX workers' gloo threads print connection notices into the same
    stream, interleaved piece by piece; those are dropped."""
    first = re.search(r"^\[[^\]\n]* ms\]\t", stdout, flags=re.M)
    head = stdout[:first.start()] if first else stdout
    return head.splitlines() + [
        line.split("\t", 1)[1]
        for line in re.findall(r"\[[^\]\n]* ms\]\t[^\n]*", stdout)]


@pytest.fixture(scope="module")
def jax_below(ranks):
    """The JAX package's two-process run on the ``below`` shards at sn=13,
    v=1 (stems ``jax``, ``jaxe``): (directory, results of each process)."""
    d = ranks[2][0] / "below"
    paths = [str(d / f"shard{i}.fasta") for i in range(2)]
    return d, run_jax_ranks(2, paths, str(d / "jax"), str(d / "jaxe"), 13, 1)


def test_two_ranks_below_identity_match_jax(ranks, jax_below):
    """sn below the eligible count: the draws of each rank's generator
    (seed + 1000003 * rank) and the global cut decide the sample, so the
    exports and rank 0's stdout must equal the JAX package's two-process
    run on the same shards."""
    d, want = jax_below
    got = ranks[2][1]["below"]
    _assert_ok(want)
    _assert_ok(got)
    for ours, theirs in (("mh", "jax"), ("mhe", "jaxe")):
        g = _exports(d, ours)
        assert len(g) == 2
        assert g == _exports(d, theirs)
    assert "Sampled 13 sequences" in got[0][1]
    assert _strip_ms(got[0][1]).splitlines() == _program_lines(want[0][1])


def test_program_lines_drop_interleaved_gloo_notices():
    """The JAX stdout filter keeps the run's lines whole when gloo's
    notices arrive in pieces between them."""
    stdout = ("Kmer size:             6\nSampling length        12\n"
              "[1.5 ms]\tStreaming pass\n[Gloo] Rank 3 is connected to "
              "[Gloo] Rank 1 is connected to 72 peer ranks. Expected number"
              " of connected peer ranks is : 7\n7 peer ranks. \n"
              "[2 ms]\t\tNumber of kmer found: 91\n")
    assert _program_lines(stdout) == [
        "Kmer size:             6", "Sampling length        12",
        "Streaming pass", "\tNumber of kmer found: 91"]


def test_counts_all_reduced_twice_fail_the_comparison(ranks, jax_below):
    """tests/test_dist.py:336: a broken merge (every count summed over the
    ranks twice, so doubled) must not pass the comparison the test above
    makes: the exact exports still equal the JAX run's, the approximate
    ones do not."""
    d, want = jax_below
    _assert_ok(want)
    _assert_ok(ranks[2][1]["twice"])
    assert _exports(d, "bade") == _exports(d, "jaxe")
    bad, good = _exports(d, "bad"), _exports(d, "jax")
    assert set(bad) == set(good) == {"_0.start", "_0.end"}
    for name in good:
        assert bad[name] != good[name], name
        counts = [int(x) for x in re.findall(rb"\t(\d+)", good[name])]
        assert sum(counts) > 0


def test_export_failure_exits_1_on_every_rank(ranks):
    """Only rank 0 exports; when that fails, the failure is all-gathered so
    every rank returns 1 instead of waiting on the next collective."""
    results = ranks[2][1]["export_failure"]
    assert [rc for rc, _, _ in results] == [1, 1]
    assert "Failed to export approximate k-mer count" in results[0][2]
    assert "Failed to export" not in results[1][2]
    # the end pass was in flight when the start pass's export failed: each
    # rank dispatched both ends and fetched one, and still returned (the
    # subprocesses' timeouts turn a hang into a failure)
    assert ranks["events"][2]["export_failure"] == [
        ["dispatch", "dispatch", "fetch"]] * 2


def _mask_stats(line: str) -> str:
    """The numbers of a ``[stats]`` line (times and rates) become ``#``,
    as ``tests/test_torch_modes.py`` masks them."""
    if "[stats]" in line:
        return re.sub(r"\d[\d.e+-]*", "#", line)
    return line


@pytest.mark.parametrize("run", ["modes", "resume"])
@pytest.mark.parametrize("n", [2, 4])
def test_n_ranks_match_the_jax_orchestrator(ranks, n, run):
    """Below identity, with Ns in the reads: -mr 2 -sk 2 -v 2 and
    --from-exact on its export export the JAX orchestrator's bytes on as many
    processes; rank 0's stdout (timestamps stripped, ``[stats]`` numbers
    masked) and stderr (the lines JAX itself may write aside) are the JAX
    rank 0's, and no other rank prints."""
    d, by_run = ranks[n]
    got, want = by_run[run], ranks["jax"][n][run]
    _assert_ok(got)
    _assert_ok(want)
    d = d / "modes"
    ours, theirs = _exports(d, f"mh_{run}"), _exports(d, f"jax_{run}")
    assert len(ours) == (4 if run == "modes" else 2)
    assert ours == theirs
    assert _exports(d, f"mhe_{run}") == _exports(d, f"jaxe_{run}")
    assert ([_mask_stats(x) for x in _strip_ms(got[0][1]).splitlines()]
            == [_mask_stats(x) for x in _strip_ms(want[0][1]).splitlines()])
    program_err = "".join(line for line in want[0][2].splitlines(True)
                          if line.startswith(("/!\\", "Path: ")))
    assert got[0][2] == program_err
    if run == "modes":
        assert "/!\\ WARNING: This dataset contained" in got[0][2]
    else:
        assert "Resuming from" in got[0][1]
    assert all(out == "" and err == "" for _, out, err in got[1:])


def test_both_ends_are_in_flight_before_either_fetch(ranks):
    """Every rank dispatches both ends of a run before it fetches either,
    as the JAX orchestrator does: at -mr 2 once per run."""
    for n in (2, 4):
        events = ranks["events"][n]
        both = ["dispatch", "dispatch", "fetch", "fetch"]
        for run in ("identity", "unbalanced", "resume"):
            assert events[run] == [both] * n, (n, run)
        assert events["modes"] == [both * 2] * n, n
