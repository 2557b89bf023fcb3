"""A cell on several cards: its ranks, and the launcher that runs them.

A cell whose ``chips`` is more than 1 runs the port's ``--multihost``
path as ``chips`` rank processes on this host, one card each, as
``torchrun`` would start them: ``launch`` starts them with its
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` 127.0.0.1 and a free
``MASTER_PORT``; ``OMP_NUM_THREADS`` the host's cores over the ranks
unless set), each rank's standard output and error in a log of its own in
the run's directory under ``TMPDIR``, and waits for them.

Each rank (``rank_main``) joins the process group once through
``dist/mesh.py:initialize``, as the program's ``__main__`` does, on
``cuda:<LOCAL_RANK>`` with a finite collective timeout, and makes a gloo
group of its own for the harness.  For each seed: rank 0 writes the
traffic's files and hands their names to the others; every rank runs the
warm-up job and then the window, the same jobs with the same ``--seed``
each (``harness.window``): before each job rank 0 decides whether the
window goes on and broadcasts its decision on the gloo group, so no rank
is left inside a collective.  After the window every rank checks that it
loaded no JAX and hands rank 0 its peak device memory; the ranks but 0
are then done.  Rank 0 alone times the jobs, reads their exports, traces
its window under ``--trace 1`` (the others run untraced, so ``busy_s``
and ``window_s`` are both rank 0's), runs the metric readers on its trace
and the check, looks again for JAX, and prints: the card and result
lines (``harness.report``) or, with ``--control``, one line a seed with
the program's and the control's compared numbers.  Set-up (``setup_s``) runs from the start of
the launching process to rank 0's window, on ``time.monotonic``, which
every process of the host shares: the ranks' start, their CUDA contexts,
the process group, the files and the warm-up job.

``launch`` waits with a deadline: until rank 0 opens its window, the
set-up's (a first run builds the kernels); after that, the window, the
check and a margin.  A rank that fails, or one still running at the
deadline, has every rank killed (each with the processes it started),
and the launch fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: a rank's command, before its arguments: ``rank_main`` of this module
RANK_CMD = [sys.executable, "-c",
            "import sys; sys.path.insert(0, sys.argv[1]); "
            "from benchmark import ranks; "
            "sys.exit(ranks.rank_main(sys.argv[2:]))", str(ROOT)]
#: seconds a launch waits for rank 0's window to open (a first run builds)
SETUP_S = 900.0
#: seconds it waits after a window has opened, beyond the window: the
#: traced run's reading, the check and the control
AFTER_S = 240.0
#: seconds a collective of the process group waits for a slower rank
COLLECTIVE_TIMEOUT_S = 300.0
#: the file rank 0 touches as each window opens
OPENED = "window"


@dataclasses.dataclass
class Launched:
    rc: int               # 0, or the worst rank's (1 for a rank killed)
    out: list             # each rank's standard output
    err: list             # each rank's standard error


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cell, seeds: list, seconds: float, trace: bool, *,
           control: bool = False, device: str = "cuda",
           t0: float | None = None, rank_cmd: list | None = None,
           setup_s: float = SETUP_S, after_s: float = AFTER_S) -> Launched:
    """Run ``cell`` (``harness.Cell``) on ``cell.chips`` ranks, one run a
    seed in one process group, and wait for them (module docstring).
    ``t0``: when the launching process started, on ``time.monotonic``."""
    t0 = time.monotonic() if t0 is None else t0
    world = cell.chips
    workdir = tempfile.mkdtemp(prefix="bench-")
    procs, logs = [], []
    old = signal.getsignal(signal.SIGTERM)

    def stop(signum, frame):
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, stop)
    try:
        path = os.path.join(workdir, "cell.json")
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(cell), f)
        args = ["--cell", path, "--workdir", workdir,
                "--seeds", ",".join(str(s) for s in seeds),
                "--seconds", str(seconds), "--trace", str(int(trace)),
                "--control", str(int(control)), "--device", device,
                "--t0", repr(t0)]
        base = dict(os.environ, WORLD_SIZE=str(world),
                    LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(free_port()))
        base.setdefault("OMP_NUM_THREADS",
                        str(max(1, (os.cpu_count() or 1) // world)))
        for r in range(world):
            logs.append([os.path.join(workdir, f"rank{r}.{x}")
                         for x in ("out", "err")])
            with open(logs[-1][0], "w") as out, open(logs[-1][1], "w") as err:
                procs.append(subprocess.Popen(
                    (rank_cmd or RANK_CMD) + args, stdout=out, stderr=err,
                    stdin=subprocess.DEVNULL, cwd=ROOT,
                    env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                    start_new_session=True))
        rc = wait(procs, os.path.join(workdir, OPENED), seconds, setup_s,
                  after_s)
    finally:
        for p in procs:
            kill(p)
        signal.signal(signal.SIGTERM, old)
        texts = [[Path(x).read_text(errors="replace") if os.path.exists(x)
                  else "" for x in pair] for pair in logs]
        shutil.rmtree(workdir, ignore_errors=True)
    return Launched(rc, [t[0] for t in texts], [t[1] for t in texts])


def wait(procs: list, opened: str, seconds: float, setup_s: float,
         after_s: float) -> int:
    """Wait for every rank to exit 0, or for the first to fail, or for the
    deadline: ``setup_s`` from now until the file ``opened`` exists, then
    ``seconds + after_s`` from its last touch.  Returns 0, or the worst
    rank's exit code (1 for a rank killed by a signal or at the
    deadline)."""
    start = time.time()
    while True:
        rcs = [p.poll() for p in procs]
        bad = [rc for rc in rcs if rc not in (None, 0)]
        if bad:
            return max(max(bad), 1)
        if all(rc == 0 for rc in rcs):
            return 0
        try:
            deadline = os.stat(opened).st_mtime + seconds + after_s
        except FileNotFoundError:
            deadline = start + setup_s
        if time.time() > deadline:
            late = [r for r, rc in enumerate(rcs) if rc is None]
            sys.stderr.write(f"ranks {late} still running at the deadline: "
                             "killed\n")
            return 1
        time.sleep(0.1)


def kill(proc) -> None:
    """Kill ``proc`` and every process of its process group, and reap it."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.wait()
    try:  # what it started may outlive it
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def rank_main(argv=None) -> int:
    """One rank of a launch (module docstring); its arguments are
    ``launch``'s, its rank and the group from ``torchrun``'s
    environment."""
    p = argparse.ArgumentParser()
    for flag in ("--cell", "--workdir", "--seeds", "--device"):
        p.add_argument(flag, required=True)
    for flag in ("--seconds", "--t0"):
        p.add_argument(flag, type=float, required=True)
    for flag in ("--trace", "--control"):
        p.add_argument(flag, type=int, required=True)
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from approx_counter_tpu_torch.dist import mesh
    from benchmark import harness

    with open(args.cell) as f:
        cell = harness.Cell(**json.load(f))
    mesh.initialize(device_type=args.device, timeout=COLLECTIVE_TIMEOUT_S)
    device = (mesh.rank_device() if args.device == "cuda"
              else torch.device("cpu"))
    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=COLLECTIVE_TIMEOUT_S))
    rc = 0
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            got = run_rank(cell, seed, args, device, group)
            if got is None:
                continue
            if isinstance(got, int):
                rc = got
                break
            # the readers and the check ran after the window's look
            found = harness.forbidden_modules()
            if found:
                sys.stderr.write(f"loaded before the result: "
                                 f"{', '.join(found)}\n")
                rc = 1
                break
            if args.control:
                from benchmark.control import readings

                print(json.dumps(readings(got, seed)), flush=True)
            else:
                harness.report(got)
    finally:
        dist.destroy_process_group()
    return rc


def run_rank(cell, seed: int, args, device, group):
    """One seed's run on this rank: set-up, the window, the gather; on
    rank 0 then the readers and the check (``harness.Outcome``).  None on
    the other ranks; 1 where this process loaded JAX."""
    import torch
    import torch.distributed as dist

    from benchmark import harness

    rank = dist.get_rank()
    lead = rank == 0
    cuda = device.type == "cuda"
    t_files = time.monotonic()
    names = [None]
    if lead:
        names[0], lengths = harness.write_inputs(
            cell.traffic, args.workdir, harness.derive(seed, 0))
    dist.broadcast_object_list(names, 0, group=group)
    t_warm = time.monotonic()
    jobs = harness.Jobs(cell.config["args"], names[0], args.workdir, device,
                        exports=lead)
    warm = jobs.run(harness.derive(seed, 1))
    if cuda:
        torch.cuda.synchronize(device)
    t_end = time.monotonic()
    setup_s = t_end - args.t0
    sys.stderr.write(
        f"rank {rank} setup: {setup_s:.3f} s; start to the files "
        f"{t_files - args.t0:.3f}, files {t_warm - t_files:.3f}, warm-up "
        f"job {t_end - t_warm:.3f}\n")

    def agree(go: bool) -> bool:
        flag = torch.tensor([int(go)])
        dist.broadcast(flag, 0, group=group)
        return bool(flag.item())

    if lead:
        Path(args.workdir, OPENED).touch()
    traced = bool(args.trace) and lead
    done, window_s, tr = harness.window(
        jobs, seed, args.seconds,
        cell.workload["trace_jobs"] if traced else None, traced, agree)
    found = harness.forbidden_modules()
    if found:
        sys.stderr.write(f"loaded after the window: {', '.join(found)}\n")
        return 1
    mine = torch.tensor(
        [torch.cuda.max_memory_allocated(device) if cuda else 0])
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine, group=group)
    sys.stderr.write(f"rank {rank}: {len(done)} jobs in the window, "
                     f"{sum(j.rc != 0 for j in done)} failed; peak "
                     f"{int(mine)} B\n")
    if not lead:
        return None
    run = harness.Run(
        cell=cell, seed=seed, device=device, fasta=names[0], prm=jobs.prm,
        passes=jobs.passes,
        windows_per_pass=harness.windows_per_pass(jobs.prm, lengths),
        setup_s=setup_s, window_s=window_s, jobs=done, trace=tr,
        card=harness.card_info(device))
    return harness.outcome(run, warm, int(max(every)), bool(args.control))
