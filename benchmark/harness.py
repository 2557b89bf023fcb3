"""One run of one benchmark cell.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Everything the
harness knows of it is found by name:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): ``args``,
  the adaptFinder command line without input, output and seed;
- ``traffic/<traffic>.json``: the parameters of ``generate.py``'s FASTA
  file (or, with ``reads_per_file``, its chunk files);
- ``workloads/<cell>.json``: ``trace_jobs`` (jobs in a traced window) and
  ``check_passes`` (passes the check works out again);
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``, for
  each metric ``BENCHMARK.json`` gives the cell.

A run writes the FASTA file from the seed into a directory under
``TMPDIR`` (flushed to disk within set-up, so that no writeback of it
falls in the window), runs one warm-up job, and then the window: one
client runs jobs back to back, each one adaptFinder invocation as
Porechop_ABI makes it, ``approx_counter_tpu_torch.__main__.run`` on the
cell's arguments with its own ``--seed``, its exports in that directory
(read back and removed after the job) and its log and warnings kept in
memory; between jobs the CUDA caching allocator's cache is emptied.  A job
counts if it starts inside the window, which ends when the last one
returns.  With ``trace`` the window runs under ``torch.profiler`` for at
most ``trace_jobs`` jobs.  Standard error gets the set-up's phases and
the cores the process kept busy over the window (``host_load``).

That is ``run_cell``, a cell on one card.  A cell on several runs as that
many rank processes of the program's ``--multihost`` path (``ranks.py``),
each through the same ``Jobs`` and ``window``, and rank 0 through the
same ``outcome``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

from benchmark import check, generate
from benchmark.trace import Trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "approx_counter_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list      # BENCHMARK.json's entries for this cell
    per_layer: list


def load_spec(root: Path = ROOT, pending: bool = False) -> dict:
    """``root/BENCHMARK.json``; with ``pending``, the cells of
    ``root/benchmark/pending.json`` (measured and left out of it) moved in:
    their configurations, cells and new per-layer metrics, and their names
    added to the ``workloads`` of the metrics it lists under ``also_in``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    if not pending:
        return spec
    more = json.loads((root / "benchmark" / "pending.json").read_text())
    names = [w["name"] for w in more["workloads"]]
    spec["per_layer"] = [
        dict(m, workloads=m["workloads"] + names)
        if m["name"] in more["also_in"] else m for m in spec["per_layer"]]
    for key in ("configs", "workloads", "per_layer"):
        spec[key] = spec[key] + more[key]
    return spec


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, or of its
    ``pending.json`` (``load_spec``), and its files."""
    spec = load_spec(root)
    if name not in {w["name"] for w in spec["workloads"]}:
        spec = load_spec(root, pending=True)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]

    def ours(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(
        name=name, chips=cell["chips"],
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                           .read_text()),
        workload=json.loads((BENCH / "workloads" / f"{name}.json")
                            .read_text()),
        end_to_end=ours(spec["end_to_end"]), per_layer=ours(spec["per_layer"]))


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def derive(seed: int, index: int) -> int:
    """A seed of its own for stream ``index`` of a run (0: the FASTA
    file, 1: the warm-up job, 2 on: the window's jobs)."""
    return int(np.random.SeedSequence([seed % (1 << 64), index])
               .generate_state(1, np.uint32)[0])


@dataclasses.dataclass
class Job:
    seed: int
    start: float
    wall_s: float
    rc: int
    log: str
    err: str
    exports: list         # each pass's approximate export (bytes or None)


class Jobs:
    """Runs adaptFinder jobs on one input (a FASTA file, or a comma-joined
    list of them) and device; ``exports``: whether this process reads and
    removes the exports (in a multihost cell rank 0 alone writes them)."""

    def __init__(self, args: list, fasta: str, workdir: str, device,
                 exports: bool = True):
        from approx_counter_tpu_torch.config.cli import resolve_params

        self.args, self.fasta, self.device = list(args), fasta, device
        self.exports = exports
        self.out = os.path.join(workdir, "out")
        self.prm = resolve_params(self.argv(0))
        ends = ("start",) if self.prm.skip_end else ("start", "end")
        self.passes = [(r, e) for r in range(self.prm.nb_of_runs)
                       for e in ends]

    def argv(self, seed: int) -> list:
        return self.args + ["--seed", str(seed), "-o", self.out, self.fasta]

    def run(self, seed: int) -> Job:
        import torch

        from approx_counter_tpu_torch.__main__ import run
        from approx_counter_tpu_torch.config.cli import resolve_params

        prm = resolve_params(self.argv(seed))
        log, err = io.StringIO(), io.StringIO()
        start = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log), \
                    contextlib.redirect_stderr(err):
                rc = run(prm, self.device)
        except Exception:  # a job that raises is a failed job
            rc = -1
            err.write(traceback.format_exc())
        wall = time.perf_counter() - start
        if self.device.type == "cuda":
            # as a new process would: each run's engine captures its CUDA
            # graphs in private memory pools, and the caching allocator
            # keeps a released pool's blocks reserved (about 0.5 GB a job)
            # until the cache is emptied, so jobs back to back would fill
            # the card
            torch.cuda.empty_cache()
        exports = []
        for r, end in self.passes if self.exports else ():
            path = f"{self.out}_{r}.{end}"
            try:
                with open(path, "rb") as f:
                    exports.append(f.read())
                os.remove(path)
            except FileNotFoundError:
                exports.append(None)
        return Job(seed, start, wall, rc, log.getvalue(), err.getvalue(),
                   exports)


@dataclasses.dataclass
class Run:
    """What a run's metric readers and check see."""
    cell: Cell
    seed: int
    device: object
    fasta: str
    prm: object           # the cell's parsed arguments
    passes: list          # (run, end) of each pass of a job
    windows_per_pass: int
    setup_s: float
    window_s: float
    jobs: list
    trace: Trace | None
    card: dict

    def derive(self, index: int) -> int:
        return derive(self.seed, index)

    def pass_work(self, job: Job) -> list:
        """Each pass's ``(end, n_valid, n_keep)``: ``n_keep`` from the log,
        or, in top-N mode, the export's rows; None where neither says."""
        stats = check.pass_stats(job.log, job.err, len(self.passes))
        out = []
        for (_, end), st, raw in zip(self.passes, stats, job.exports):
            n_keep = st.get("n_keep")
            if n_keep is None and self.prm.solid_km == 0 and raw is not None:
                n_keep = raw.count(b"\n")
            out.append((end, st.get("n_valid", self.windows_per_pass),
                        n_keep))
        return out


def card_info(device) -> dict:
    """The card's name, SMs and compute capability, and from
    ``nvidia-smi`` its power limit (W) and largest SM clock (MHz)."""
    import subprocess

    import torch

    if device.type != "cuda":
        return dict(name=device.type)
    props = torch.cuda.get_device_properties(device)
    info = dict(name=torch.cuda.get_device_name(device),
                sm_count=props.multi_processor_count,
                capability=f"{props.major}.{props.minor}")
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        power, clock = (float(x) for x in line.strip().split(","))
        info.update(power_limit_w=power, max_sm_clock_mhz=clock)
    except (OSError, ValueError, subprocess.SubprocessError) as e:
        info["nvidia_smi"] = f"not read: {e}"
    return info


def windows_per_pass(prm, lengths: np.ndarray) -> int:
    """Windows a pass samples: ``-sn`` (clamped to the reads) of the reads
    long enough for both ends."""
    sn = min(prm.sn, len(lengths))
    return int(min(sn, np.count_nonzero(lengths >= 2 * prm.sl)))


def host_load(own_cpu_s: float, window_s: float) -> str:
    """One line: the cores this process kept busy over the window (its
    threads' CPU time over the window's), so a slow run shows whether it
    was short of CPU or waited."""
    return (f"host: window {window_s:.3f} s, this process "
            f"{own_cpu_s / window_s:.3f} cores")


def window(jobs: Jobs, seed: int, seconds: float, limit: int | None,
           trace: bool, agree=None):
    """Jobs back to back for ``seconds`` (and at most ``limit``); with
    ``trace`` under ``torch.profiler``, each job in a ``bench job`` range.
    Before each job ``agree`` (if given) turns this process's decision to
    go on into the one every rank takes.  Returns the jobs, the window's
    seconds and the trace."""
    import torch

    cuda = jobs.device.type == "cuda"
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = torch.profiler.profile(
            activities=acts, acc_events=True,
            experimental_config=torch.profiler._ExperimentalConfig(
                profile_all_threads=True))
        prof.start()
    done = []
    cpu0 = time.process_time()
    start = time.perf_counter()
    while True:
        go = time.perf_counter() - start < seconds and (
            limit is None or len(done) < limit)
        if not (go if agree is None else agree(go)):
            break
        with (torch.profiler.record_function("bench job") if trace
              else contextlib.nullcontext()):
            done.append(jobs.run(derive(seed, 2 + len(done))))
    if cuda:
        torch.cuda.synchronize(jobs.device)
    window_s = time.perf_counter() - start
    sys.stderr.write(host_load(time.process_time() - cpu0, window_s) + "\n")
    if prof is None:
        return done, window_s, None
    prof.stop()
    return done, window_s, Trace.from_profiler(prof)


@dataclasses.dataclass
class Outcome:
    result: dict          # the result line's keys but ``checks``
    checks: dict          # the compared numbers
    card: dict
    control: dict | None  # the numbers of the control, when asked for


def write_inputs(traffic: dict, workdir: str, seed: int):
    """The traffic's reads written from ``seed`` into ``workdir`` and
    flushed to disk: one FASTA file, or with ``reads_per_file`` its chunk
    files (``generate.write_chunks``).  Returns the program's input
    argument (the paths, comma-joined) and the read lengths."""
    if "reads_per_file" in traffic:
        paths, lengths = generate.write_chunks(
            os.path.join(workdir, "reads"), traffic, seed)
    else:
        paths = [os.path.join(workdir, "reads.fa")]
        lengths = generate.write_fasta(paths[0], traffic, seed)
    for path in paths:
        with open(path, "rb") as f:
            os.fsync(f.fileno())
    return ",".join(paths), lengths


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None, control: bool = False) -> Outcome:
    """One run of ``cell`` in a new directory under ``TMPDIR``, removed
    at the end.  ``t_start`` is when the process started (set-up runs from
    there); with ``control`` the configuration's control
    (``check.control_kind``) is judged on the same passes after the
    program."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    workdir = tempfile.mkdtemp(prefix="bench-")
    try:
        t_fasta = time.perf_counter()
        fasta, lengths = write_inputs(cell.traffic, workdir, derive(seed, 0))
        t_warm = time.perf_counter()
        jobs = Jobs(cell.config["args"], fasta, workdir, device)
        warm = jobs.run(derive(seed, 1))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_end = time.perf_counter()
        setup_s = t_end - t_start
        sys.stderr.write(
            f"setup: {setup_s:.3f} s; start to the FASTA file "
            f"{t_fasta - t_start:.3f}, FASTA file {t_warm - t_fasta:.3f}, "
            f"warm-up job {t_end - t_warm:.3f}\n")
        done, window_s, tr = window(
            jobs, seed, seconds, cell.workload["trace_jobs"] if trace
            else None, trace)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        run = Run(cell=cell, seed=seed, device=device, fasta=fasta,
                  prm=jobs.prm, passes=jobs.passes,
                  windows_per_pass=windows_per_pass(jobs.prm, lengths),
                  setup_s=setup_s, window_s=window_s, jobs=done, trace=tr,
                  card=card_info(device))
        return outcome(run, warm, peak, control)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def outcome(run: Run, warm: Job, peak: int, control: bool) -> Outcome:
    """What a run reports once its window has closed: the metrics of its
    cell, the check, the device (``peak`` its memory), the breakdown.  The
    CUDA cache is emptied before the check."""
    import torch

    cell, device, done, tr = run.cell, run.device, run.jobs, run.trace
    metrics = {}
    for m in (cell.per_layer if tr is not None else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    if device.type == "cuda":
        torch.cuda.empty_cache()
    nums = check.judge(run)
    nums["jobs_failed"] += int(warm.rc != 0)
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=run.card["name"], count=cell.chips,
               memory_peak_bytes=peak)
    result = dict(correct=check.correct(nums),
                  attempted=len(done),
                  failed=sum(j.rc != 0 for j in done),
                  metrics=metrics, device=dev)
    if tr is not None:
        dev.update(busy_s=tr.busy_s(), window_s=run.window_s)
        result["breakdown"] = tr.breakdown()
    if done:
        walls = np.array([j.wall_s for j in done]) * 1e3
        sys.stderr.write(
            f"{len(done)} jobs; wall ms at 10/25/50/75/90/100%: "
            + " ".join(f"{v:.1f}" for v in np.percentile(
                walls, [10, 25, 50, 75, 90, 100])) + "\n")
    failed = [j for j in [warm] + done if j.rc != 0]
    if failed:
        sys.stderr.write(f"{len(failed)} jobs failed; the first one's "
                         f"errors:\n{failed[0].err[-2000:]}\n")
    return Outcome(result, nums, run.card, check.judge(
        run, control=check.control_kind(run.prm)) if control else None)


def report(got: Outcome) -> None:
    """Print a run's card line and result line on standard output, the
    compared numbers with their limits last on standard error and last in
    the result line."""
    result, nums, card = got.result, got.checks, got.card
    card["memory_peak_bytes"] = result["device"]["memory_peak_bytes"]
    print(json.dumps(dict(card=card)))
    result["checks"] = {k: dict(value=v, limit=check.LIMITS[k])
                        for k, v in nums.items()}
    for k, v in nums.items():
        sys.stderr.write(f"check {k}: {v} (limit {check.LIMITS[k]})\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
