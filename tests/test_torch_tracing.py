"""The port's spans and counters (``approx_counter_tpu_torch/tracing.py``).

A ``--profile`` run's Chrome trace holds a ``torch.profiler`` range for
each layer's work, on the thread that does it, and the counters'
``name=value`` marks, whose values the run's own shapes and log
reckon: ``upload.bytes`` from the batches' and the pool's sizes,
``regrow.reruns`` from the passes whose ``n_keep`` outgrew the first cap.
With no profiler recording, spans and counters make no range at all, and
the exports are the same bytes either way.  The ``cuda`` test holds the
eager and capture spans, which only a card has, to the engine's worker
thread; this file imports no JAX, so it runs on the GPU host with
``python -m pytest --noconftest -m cuda tests/test_torch_tracing.py``.
"""

import contextlib
import io
import json
import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu_torch import tracing  # noqa: E402
from approx_counter_tpu_torch.__main__ import run  # noqa: E402
from approx_counter_tpu_torch.config.cli import resolve_params  # noqa: E402
from approx_counter_tpu_torch.core.codec import NCAP  # noqa: E402
from approx_counter_tpu_torch.count.exact import pass_cap  # noqa: E402

ADAPTER = "AATGTACTTCGTTCAGTTACGTATTGCT"
SL, SN, N_READS = 40, 100, 300
#: reads of 60-299 bases, so 2 * SL = 80 leaves some too short to sample
MIN_LEN, MAX_LEN = 60, 300


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Reads with the adapter at their start, no N."""
    rng = np.random.default_rng(11)
    path = tmp_path_factory.mktemp("reads") / "reads.fa"
    lengths = rng.integers(MIN_LEN, MAX_LEN, N_READS)
    with open(path, "w") as f:
        for i, n in enumerate(lengths):
            body = "".join("ACGT"[c] for c in rng.integers(0, 4, n))
            f.write(f">r{i}\n{(ADAPTER + body)[:n]}\n")
    return path, lengths


def run_cli(tmp_path, fasta_path, *flags, profile=True, device="cpu"):
    """``__main__.run`` on ``flags`` (k 10, sl 40, sn 100, limit 30, an
    exact export); returns (exit code, stdout, the exports by name, the
    trace's ranges as ``(name, thread)`` in order)."""
    out = tmp_path / "out"
    out.mkdir(parents=True)
    argv = [str(fasta_path), "-o", str(out / "o"), "-e", str(out / "e"),
            "-k", "10", "-sl", str(SL), "-sn", str(SN), "-lim", "30",
            "--seed", "3", *flags]
    if profile:
        argv += ["--profile", str(tmp_path / "prof")]
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = run(resolve_params(argv), device)
    files = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
    ranges = []
    if profile:
        with open(tmp_path / "prof" / "trace.json") as f:
            events = json.load(f)["traceEvents"]
        ranges = [(e["name"], e["tid"]) for e in sorted(
            events, key=lambda e: e.get("ts", 0))
                  if e.get("cat") == "user_annotation"]
    return rc, log.getvalue(), files, ranges


def marks(ranges, counter):
    prefix = counter + "="
    return [int(n[len(prefix):]) for n, _ in ranges if n.startswith(prefix)]


def sparse_bytes(rows: int) -> int:
    """One batch of ``rows`` windows of ``SL + 1`` columns in the sparse-N
    format: 2 bits a base padded to 8-base words, and the N list."""
    return rows * math.ceil((SL + 1) / 8) * 2 + NCAP * 4


def test_a_profiled_run_holds_every_span(tmp_path, fasta):
    """Every span but the card's own (``eager``, ``capture``, ``upload
    wait``) on a CPU run with a pool, two runs and an exact export; the
    fetch on the engine's worker thread, the rest on the caller's."""
    rc, _, files, ranges = run_cli(tmp_path, fasta[0], "-mr", "2",
                                   "--device-pool", "on")
    assert rc == 0 and len(files) == 8
    names = {n for n, _ in ranges}
    assert {"parse", "engine", "pool", "sample", "pack", "upload", "wait",
            "fetch", "export", "close", "prefetch", "start pass",
            "end pass"} <= names
    assert not {"eager", "capture", "upload wait"} & names
    main = {t for n, t in ranges if n == "parse"}
    assert len(main) == 1
    assert {t for n, t in ranges if n == "fetch"}.isdisjoint(main)
    for n in ("engine", "pool", "sample", "pack", "upload", "wait",
              "export", "close"):
        assert {t for m, t in ranges if m == n} == main, n
    # 2 runs x 2 ends, each end's approximate and exact export
    assert sum(n == "export" for n, _ in ranges) == 8
    assert sum(n == "sample" for n, _ in ranges) == 4


@pytest.mark.parametrize("flags", [(), ("-mr", "3", "--device-pool", "on")],
                         ids=["plain", "pool"])
def test_upload_bytes_are_the_batches_bytes(tmp_path, fasta, flags):
    """A plain pass ships its sampled windows (sparse-N); a pool run ships
    each end's pool once and then one uint16 index vector a pass (its rows
    and ``n_valid`` in two slots)."""
    _, lengths = fasta
    eligible = int(np.count_nonzero(lengths >= 2 * SL))
    rows = min(SN, eligible)
    rc, _, _, ranges = run_cli(tmp_path, fasta[0], *flags)
    assert rc == 0
    if flags:
        want = [sparse_bytes(eligible)] * 2 + [(rows + 2) * 2] * 6
    else:
        want = [sparse_bytes(rows)] * 2
    assert marks(ranges, "upload.bytes") == want


def test_regrow_reruns_count_the_passes_past_the_first_cap(tmp_path, fasta):
    """Solid mode keeps every k-mer seen twice: a pass whose logged
    ``n_keep`` outgrows ``pass_cap(limit)`` runs once more (here the end
    pass, not the start)."""
    rc, log, _, ranges = run_cli(tmp_path, fasta[0], "-sk", "2", "-k", "5",
                                 "-v", "1")
    assert rc == 0
    kept = [int(x) for x in re.findall(r"Number of kmer kept:\s+(\d+)", log)]
    assert len(kept) == 2
    want = sum(n > pass_cap(30) for n in kept)
    assert 0 < want < len(kept)
    assert sum(marks(ranges, "regrow.reruns")) == want


def test_exports_are_the_same_bytes_with_and_without_the_profiler(
        tmp_path, fasta):
    got = [run_cli(tmp_path / tag, fasta[0], "-mr", "2", "-sk", "2",
                   "--device-pool", "on", profile=tag == "on")
           for tag in ("off", "on")]
    assert got[0][0] == got[1][0] == 0
    assert len(got[0][2]) == 8 and got[0][2] == got[1][2]


def test_no_range_while_nothing_records(tmp_path, fasta, monkeypatch):
    """With no profiler, spans and counters never reach
    ``record_function``: a whole run passes with it raising."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tracing.span("x"):
        tracing.count("y", 1)
    rc, _, files, _ = run_cli(tmp_path, fasta[0], "-mr", "2", "-sk", "2",
                              "--device-pool", "on", profile=False)
    assert rc == 0 and len(files) == 8


def test_spans_and_marks_while_a_profiler_records():
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            tracing.count("things", 7)
    names = [e.name for e in prof.events()]
    assert "outer" in names and "things=7" in names
    with tracing.span("after"):
        pass


@pytest.mark.cuda
def test_eager_and_capture_run_on_the_worker_thread(tmp_path, fasta):
    """On the card: a segment's eager first run and its capture are spans
    of the engine's worker thread, which also fetches, and no ``warm-up``
    span is left; the caller waits for it and its uploads wait on the
    staging buffers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    rc, _, files, ranges = run_cli(tmp_path, fasta[0], "-mr", "2",
                                   device="cuda")
    assert rc == 0 and len(files) == 8
    main = {t for n, t in ranges if n == "parse"}
    worker = {t for n, t in ranges if n in ("eager", "capture")}
    assert worker and worker.isdisjoint(main)
    assert {t for n, t in ranges if n == "fetch"} <= worker
    names = [n for n, _ in ranges]
    assert names.count("eager") >= 1 and names.count("capture") >= 1
    # -mr 2: four passes, each at most one eager run or one capture
    assert names.count("eager") + names.count("capture") <= 4
    assert "warm-up" not in names
    assert "upload wait" in names
