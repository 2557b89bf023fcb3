"""Solid mode at its loosest threshold, ``-sk 1``: every distinct k-mer
of the sampled windows is a candidate, so ``n_keep`` outgrows the first
cap many times over and every pass reruns once at a regrown cap.

On the CPU: a whole run through ``__main__.run`` on the benchmark's
generated reads, its printed numbers and exported rows held to the plain
reference (``benchmark/reference/adaptfinder.py``) as the benchmark's
check scores them, its exact export whole; and the pass's ``rerun`` span
and ``approx.launches`` mark under a profiler.  Marked ``cuda``: the count
kernel split over several launches, at the ``solid_k1`` configuration's
full size (two launches an end) and with ``MAX_GRID_Y`` cut to 7, against
the plain versions.  This file imports no JAX; on the GPU host run the
``cuda`` tests with ``python -m pytest --noconftest -m cuda
tests/test_torch_solid_all.py``.
"""

import contextlib
import io
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity  # noqa: E402

from approx_counter_tpu_torch import pipeline  # noqa: E402
from approx_counter_tpu_torch.__main__ import run  # noqa: E402
from approx_counter_tpu_torch.config.cli import resolve_params  # noqa: E402
from approx_counter_tpu_torch.count.exact import pass_cap  # noqa: E402
from approx_counter_tpu_torch.kernels import bpm  # noqa: E402
from approx_counter_tpu_torch.params import Params  # noqa: E402
from approx_counter_tpu_torch.pipeline import Engine  # noqa: E402
from benchmark import check, generate  # noqa: E402
from benchmark.reference import adaptfinder as ref  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TRAFFIC = json.loads(
    (ROOT / "benchmark" / "traffic" / "nanopore_synthetic.json").read_text())
#: the benchmark's reads at a size the CPU runs in seconds
SMALL = dict(TRAFFIC, reads=800, length_min=130, length_max=400,
             n_rate=0.01)
ARGS = ["-sn", "300", "-sl", "50", "-k", "12", "-lim", "40",
        "--max-error", "2", "-sk", "1", "-v", "1"]
SEED = 2**31 + 977


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """One ``-sk 1`` run on the CPU with an exact export: the parameters,
    the log, the warnings, the exports by name and the reads' path."""
    tmp = tmp_path_factory.mktemp("solid_all")
    fasta = str(tmp / "reads.fa")
    generate.write_fasta(fasta, SMALL, SEED)
    prm = resolve_params(ARGS + ["--seed", str(SEED), "-o",
                                 str(tmp / "o"), "-e", str(tmp / "e"),
                                 fasta])
    log, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(log), contextlib.redirect_stderr(err):
        rc = run(prm, "cpu")
    assert rc == 0, err.getvalue()
    files = {f: (tmp / f).read_bytes().decode()
             for f in sorted(os.listdir(tmp)) if f != "reads.fa"}
    return prm, log.getvalue(), err.getvalue(), files, fasta


def test_a_small_run_outgrows_the_first_cap_tenfold(small_run):
    _, log, _, files, _ = small_run
    kept = [int(x) for x in re.findall(r"Number of kmer kept:\s+(\d+)", log)]
    assert len(kept) == 2
    assert min(kept) >= 10 * pass_cap(40)
    assert sorted(files) == ["e_0.end", "e_0.start", "o_0.end", "o_0.start"]


@pytest.mark.parametrize("p,end", [(0, "start"), (1, "end")])
def test_stats_and_rows_equal_the_reference(small_run, p, end):
    """The pass's printed numbers and every exported row, scored as the
    benchmark's check scores a solid-mode pass (every row's k-mer solid,
    its count the reference's, CompareCount order; a sample of the solid
    k-mers left out ranked after the last row), read 0."""
    prm, log, err, files, fasta = small_run
    buf, offsets = ref.read_fasta(fasta)
    windows = ref.Sampler(buf, offsets, prm.sn, prm.sl, SEED).windows(
        p, end == "end")
    stats = check.pass_stats(log, err, 2)[p]
    assert set(stats) == {"n_valid", "n_unique", "n_keep", "had_n"}
    out = dict(lines=files[f"o_0.{end}"].splitlines(), stats=stats)
    got = check.judge_pass(windows, prm, out, np.random.default_rng(p),
                           check.SOLID_SAMPLE, "cpu")
    assert got == dict(stats_wrong=0, rows_wrong=0, unranked_wrong=0)
    assert len(out["lines"]) == prm.limit


@pytest.mark.parametrize("p,end", [(0, "start"), (1, "end")])
def test_exact_export_is_every_kmer_in_compare_count_order(small_run, p,
                                                            end):
    prm, _, _, files, fasta = small_run
    buf, offsets = ref.read_fasta(fasta)
    windows = ref.Sampler(buf, offsets, prm.sn, prm.sl, SEED).windows(
        p, end == "end")
    ex = ref.exact_stage(windows, prm.k, prm.param_lc, prm.limit, 1, "cpu")
    assert files[f"e_0.{end}"].splitlines() == ref.export_lines(
        ex["codes"], ex["counts"], prm.k)


def _windows(n: int, m: int, seed: int) -> np.ndarray:
    """``n`` random windows of ``m`` bases, a third of them sharing a
    stretch, so some k-mers repeat."""
    rng = np.random.default_rng(seed)
    wins = rng.integers(0, 4, (n, m)).astype(np.uint8)
    wins[::3, 5:35] = rng.integers(0, 4, 30).astype(np.uint8)
    return wins


@pytest.mark.parametrize("solid", [1, 0], ids=["sk1", "top"])
def test_a_regrown_pass_is_one_rerun_span(monkeypatch, solid):
    """Under a profiler a pass marks ``approx.launches`` once, with the
    launches the count kernel's wrapper made over the pass (here counted
    by a stand-in for the CPU, which launches nothing): at ``-sk 1`` the
    first cap's run and the regrown cap's, each split over launches of 7
    groups, the rerun in one ``rerun`` span that holds its ``fetch``; a
    top-N pass the first cap's launches and no ``rerun`` span."""
    real = pipeline.approx_counts

    def counted(peq, *args, **kw):
        counted.launches += len(bpm.word_launches(-(-peq.shape[0] // 32)))
        return real(peq, *args, **kw)

    counted.launches = 0
    monkeypatch.setattr(pipeline, "approx_counts", counted)
    monkeypatch.setattr(bpm, "MAX_GRID_Y", 7)
    n, m, n_valid = 64, 41, 57
    engine = Engine(Params(k=12, sl=m - 1, limit=30, solid_km=solid), "cpu")
    try:
        # every thread: the passes count on the engine's worker
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU],
                experimental_config=torch.profiler._ExperimentalConfig(
                    profile_all_threads=True)) as prof:
            _, _, stats = engine.count_one_end(_windows(n, m, 7), n_valid)
    finally:
        engine.close()
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    names = [e.name for e in events]
    launches = [int(x[len("approx.launches="):]) for x in names
                if x.startswith("approx.launches=")]
    reruns = [e for e in events if e.name == "rerun"]
    first = len(bpm.word_launches(pass_cap(30) // 32))
    if solid:
        cap = -(-stats["n_keep"] // pipeline.CT) * pipeline.CT
        assert cap > pass_cap(30)
        assert launches == [first + len(bpm.word_launches(cap // 32))] == [
            counted.launches]
        (span,) = reruns
        assert names.count("regrow.reruns=1") == 1
        inside = [e.name for e in events
                  if span.time_range.start <= e.time_range.start
                  and e.time_range.end <= span.time_range.end]
        assert "fetch" in inside
    else:
        assert launches == [first] == [counted.launches] == [3]
        assert reruns == [] and "regrow.reruns=1" not in names


@pytest.mark.cuda
def test_launches_of_seven_groups_equal_the_plain_counts(monkeypatch):
    """With ``MAX_GRID_Y`` cut to 7, 3,000 candidates (94 words) take 14
    launches, each writing its own slice, and give the plain version's
    counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    monkeypatch.setattr(bpm, "MAX_GRID_Y", 7)
    rng = np.random.default_rng(5)
    k, maxerr, C, W, m = 16, 2, 3000, 512, 101
    wins = rng.integers(0, 4, (W, m)).astype(np.uint8)
    codes = rng.integers(0, 1 << 32, C, dtype=np.int64)
    # 64 candidates cut from the windows, so some counts are not 0
    codes[:64] = (wins[:64, 10:10 + k].astype(np.int64)
                  << 2 * np.arange(k - 1, -1, -1)).sum(1)
    peq = bpm.build_peq(torch.from_numpy(codes), k)
    windows_t = torch.from_numpy(wins.T.copy())
    valid = torch.ones(W, dtype=torch.bool)
    want = bpm.approx_counts_ref(peq, windows_t, valid, k, maxerr)
    before = bpm.approx_counts.launches
    got = bpm.approx_counts(peq.cuda(), windows_t.cuda(), valid.cuda(), k,
                            maxerr=maxerr)
    plan = bpm.word_launches(-(-C // 32))
    assert len(plan) == 14
    assert bpm.approx_counts.launches - before == len(plan)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert int(want[:64].min()) > 0


#: candidates compared a launch slice at full size
PER_SLICE = 16_384


@pytest.mark.cuda
def test_split_counts_at_full_size_equal_the_reference(tmp_path):
    """The ``solid_k1`` configuration on the ``nanopore_synthetic`` reads:
    two passes of one job through the engine (three kernel launches each:
    the first cap's and two at the regrown cap), then the count kernel
    on the engine's own candidates, all ~2.7 M of them in two launches, and
    16,384 candidates of each launch's slice (the second's 500 highest
    counts among them) against the plain reference, exactly.  The engine's
    top ``limit`` equals the ranking of those counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    from approx_counter_tpu_torch.io.fastx import read_fastx
    from approx_counter_tpu_torch.sample.sampler import sample_windows

    config = json.loads(
        (ROOT / "benchmark" / "configs" / "solid_k1.json").read_text())
    fasta = str(tmp_path / "reads.fa")
    generate.write_fasta(fasta, TRAFFIC, SEED)
    prm = resolve_params(config["args"] + ["--seed", str(SEED), fasta])
    k, device = prm.k, torch.device("cuda", 0)
    reads = read_fastx(fasta)
    rng = np.random.default_rng(prm.seed)
    buf, offsets = ref.read_fasta(fasta)
    sampler = ref.Sampler(buf, offsets, prm.sn, prm.sl, prm.seed)
    pick = np.random.default_rng(SEED + 1)
    split = bpm.MAX_GRID_Y * 32
    engine = Engine(prm, device)
    try:
        for p, end in enumerate((False, True)):
            batch = sample_windows(reads, prm.sn, prm.sl, end=end, rng=rng,
                                   pad_to=1)
            windows = sampler.windows(p, end)
            n, width = windows.shape
            assert batch.n_valid == n == prm.sn
            np.testing.assert_array_equal(batch.windows[:n, :width],
                                          windows)
            before = bpm.approx_counts.launches
            (codes, _), (top_codes, top_counts), stats = \
                engine.count_one_end(batch.windows, batch.n_valid)
            assert bpm.approx_counts.launches - before == 3
            n_keep = stats["n_keep"]
            assert n_keep == len(codes) > split + PER_SLICE
            windows_t, row_mask = engine.device_windows(batch.windows,
                                                        batch.n_valid)
            cand = torch.from_numpy(codes.view(np.int64)).to(device)
            before = bpm.approx_counts.launches
            counts = bpm.approx_counts(bpm.build_peq(cand, k), windows_t,
                                       row_mask, k, maxerr=prm.max_error)
            counts = counts.cpu().numpy()
            assert bpm.approx_counts.launches - before == 2
            first = pick.choice(split, PER_SLICE, replace=False)
            second = split + np.argsort(-counts[split:], kind="stable")
            rest = pick.choice(second[500:], PER_SLICE - 500, replace=False)
            for idx in (first, np.concatenate([second[:500], rest])):
                want = ref.approx_counts(codes[idx], windows, k,
                                         prm.max_error, device, block=1024)
                bad = int((counts[idx].astype(np.uint64) != want).sum())
                print(f"[solid_all] pass {p} slice of {len(idx)}: "
                      f"{bad} mismatches")
                assert bad == 0
            ranked = ref.rank(codes, counts.astype(np.uint64), k, prm.limit)
            np.testing.assert_array_equal(top_codes, ranked[0])
            np.testing.assert_array_equal(top_counts, ranked[1])
    finally:
        engine.close()

