"""The four-rank cell on the CPU: the chunk files, the reference's
multihost sample against the port's, and the launcher at four gloo ranks.

Ranks are subprocesses joined over gloo on the CPU, as ``ranks.py``
starts them on the cards; each process group has a timeout, and each
launch a deadline, so a hang fails a test."""

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from benchmark import generate, harness, ranks
from benchmark.harness import BENCH, ROOT
from benchmark.reference import adaptfinder as ref
from benchmark.reference import multihost as ref_multihost
from benchmark.tests.conftest import launch, shrink

CELL = "porechop_abi.multihost4"
SEED = 2**31 + 4242
CHUNKED = json.loads((BENCH / "traffic" / "nanopore_chunked.json")
                     .read_text())


def tiny_cell():
    return shrink(harness.load_cell(CELL))


def test_chunk_files_concatenate_to_the_one_file(tmp_path):
    """At the cell's size: 13 files, 12 of 4,000 reads and 1 of 2,000,
    whose bytes end to end are ``write_fasta``'s file at that seed; the
    four ranks get 14,000, 12,000, 12,000 and 12,000 reads."""
    one = tmp_path / "one.fa"
    lengths = generate.write_fasta(str(one), CHUNKED, SEED)
    paths, chunk_lengths = generate.write_chunks(str(tmp_path / "reads"),
                                                 CHUNKED, SEED)
    assert len(paths) == 13
    assert np.array_equal(lengths, chunk_lengths)
    data = [open(p, "rb").read() for p in paths]
    assert b"".join(data) == one.read_bytes()
    reads = [d.count(b">") for d in data]
    assert reads == [4000] * 12 + [2000]
    assert [sum(reads[i] for i in idx)
            for idx in ref_multihost.deal(13, 4)] == [14000] + [12000] * 3


SAMPLE = textwrap.dedent(r"""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    repo, rank, world, port, out, files, sn, sl, seed = sys.argv[1:10]
    sys.path.insert(0, repo)
    from approx_counter_tpu_torch.dist import mesh
    from approx_counter_tpu_torch.dist.multihost import shard_paths
    from approx_counter_tpu_torch.dist.sampling import (
        distributed_sample_windows)
    rank, world = int(rank), int(world)
    if world > 1:
        mesh.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                        device_type="cpu", timeout=120)
    mine = shard_paths(files.split(","), rank, world)
    rng = np.random.default_rng(int(seed) + 1000003 * rank)
    got = {}
    for run in range(2):
        a, b, _, _ = distributed_sample_windows(
            mine, int(sn), int(sl), rng, world, rank)
        got[f"{run}start"] = a.windows[:a.n_valid, :int(sl)]
        got[f"{run}end"] = b.windows[:b.n_valid]
    np.savez(out, **got)
""")


def port_sample(tmp_path, files, world, sn, sl, seed) -> list:
    """Each rank's windows of two runs from the port's
    ``distributed_sample_windows``, at ``world`` gloo ranks."""
    port = ranks.free_port()
    outs = [str(tmp_path / f"w{world}_{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", SAMPLE, str(ROOT), str(r), str(world),
         str(port), outs[r], ",".join(files), str(sn), str(sl), str(seed)],
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    return [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("sn", [600, 150])
def test_reference_sample_equals_the_port(tmp_path, sn):
    """Rank by rank, run by run, the same windows in the same order as the
    port's streaming bottom-k sample at 1, 2 and 4 ranks, on the tiny
    chunk files (13 of them), with more and with fewer eligible reads than
    ``sn`` on a rank."""
    cell = tiny_cell()
    files, _ = generate.write_chunks(str(tmp_path / "reads"), cell.traffic,
                                     SEED)
    read = [ref.read_fasta(p) for p in files]
    sl, seed = 60, SEED + 7
    for world in (1, 2, 4):
        got = port_sample(tmp_path, files, world, sn, sl, seed)
        sampler = ref_multihost.Sampler(read, world, sn, sl, seed)
        for run in range(2):
            for end in ("start", "end"):
                want = sampler.rank_windows(run, end == "end")
                for r in range(world):
                    assert np.array_equal(got[r][f"{run}{end}"], want[r]), (
                        world, run, end, r)
                assert len(sampler.windows(run, end == "end")) == min(
                    sn, 800)


def test_a_rank_seed_moves_the_sample(tmp_path):
    cell = tiny_cell()
    files, _ = generate.write_chunks(str(tmp_path / "reads"), cell.traffic,
                                     SEED)
    read = [ref.read_fasta(p) for p in files]
    a = ref_multihost.Sampler(read, 4, 150, 60, SEED).windows(0, False)
    b = ref_multihost.Sampler(read, 4, 150, 60, SEED + 1).windows(0, False)
    assert a.shape == b.shape and not np.array_equal(a, b)


def result_of(got) -> dict:
    assert got.rc == 0, got.err
    lines = got.out[0].splitlines()
    return json.loads(lines[-1])


def test_four_ranks_run_the_same_jobs_and_rank_0_alone_prints():
    got = launch(tiny_cell(), control=True)
    line = result_of(got)
    assert line["correct"] and line["jobs"] >= 1
    assert all(v == 0 for v in line["program"].values()), line
    # the hamming control, judged on the same passes, is not correct
    assert any(v > 0 for v in line["control"].values()), line
    assert all(out == "" for out in got.out[1:])
    counts = [int(e.split(f"rank {r}: ")[1].split()[0])
              for r, e in enumerate(got.err)]
    assert counts == [line["jobs"]] * 4, got.err


def test_the_result_line():
    cell = tiny_cell()
    got = launch(cell)
    card, result = (json.loads(x) for x in got.out[0].splitlines()[-2:])
    assert result["correct"] and result["failed"] == 0, result
    assert result["device"]["count"] == 4
    assert set(result["metrics"]) == {"windows_per_s", "job_ms_p50",
                                      "setup_s"}
    assert list(result)[-1] == "checks"
    assert card["card"]["name"] == "cpu"


def test_rank_0_alone_traces():
    """Under ``--trace 1`` rank 0 traces its window and reports its own
    busy and window seconds; a profiler started on another rank fails."""
    got = launch(tiny_cell(), trace=True, setup=(
        "import torch.profiler\n"
        "if rank != 0: torch.profiler.profile = None"))
    result = result_of(got)
    assert result["correct"] and result["failed"] == 0, result
    dev = result["device"]
    assert 0 <= dev["busy_s"] <= dev["window_s"], dev
    assert "windows_per_s" not in result["metrics"]


def test_another_ranks_seed_in_the_reference_is_not_correct():
    got = launch(tiny_cell(), setup=(
        "from benchmark.reference import multihost as m\n"
        "m.rank_seed = lambda seed, r: seed + m.RANK_STRIDE * ((r + 1) % 4)"))
    result = json.loads(got.out[0].splitlines()[-1])
    assert not result["correct"], result


@pytest.mark.parametrize("setup,why", [
    ("if rank == 2: os._exit(3)", "exits early"),
    ("import time\nif rank == 2: time.sleep(600)", "hangs"),
    ("import types\nif rank == 1: sys.modules['jax'] = types.ModuleType('jax')",
     "loads JAX"),
    # rank 0's check, after the window's look, loads JAX
    ("import types\nfrom benchmark import check\njudge = check.judge\n"
     "def loads(*a, **k):\n"
     "    sys.modules['jax'] = types.ModuleType('jax')\n"
     "    return judge(*a, **k)\n"
     "if rank == 0: check.judge = loads",
     "loads JAX after the window"),
])
def test_a_failed_rank_fails_the_launch(setup, why):
    """Every rank is killed, nothing is printed, and the launch fails
    within its deadline (a set-up deadline of 30 s here)."""
    import time

    start = time.monotonic()
    got = launch(tiny_cell(), setup=setup, setup_s=30.0)
    assert got.rc != 0, why
    assert time.monotonic() - start < 120, why
    assert not any(x.startswith('{"correct"') for out in got.out
                   for x in out.splitlines()), why
