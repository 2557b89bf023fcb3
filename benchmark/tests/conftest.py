"""Shared fixtures: the benchmark's cells at a size the CPU runs in
seconds (800 reads of 130-400 bases, in 13 chunk files where the cell has
them, 600 windows of 60 bases a pass, k = 12, 40 candidates), with every
other setting as the cell has it."""

import os
import sys
import textwrap

import pytest

TINY_TRAFFIC = dict(reads=800, length_min=130, length_max=400, n_rate=0.01)
TINY_ARGS = ["-sn", "600", "-sl", "60", "-k", "12", "-lim", "40",
             "--max-error", "2"]


def shrink(cell, runs: int = 2):
    """``cell`` cut to the tiny size: its mode flags (``-sk``, ``-mr`` at
    ``runs``) kept."""
    args = list(TINY_ARGS)
    tail = cell.config["args"]
    for flag in ("-sk", "-mr"):
        if flag in tail:
            value = tail[tail.index(flag) + 1]
            args += [flag, str(runs) if flag == "-mr" else value]
    args += [flag for flag in ("--multihost",) if flag in tail]
    cell.config = dict(cell.config, args=args)
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC)
    if "reads_per_file" in cell.traffic:
        # as many files as the cell has, the last one half full
        cell.traffic["reads_per_file"] = TINY_TRAFFIC["reads"] * 2 // 25
    cell.workload = dict(cell.workload, trace_jobs=2, check_passes=3)
    return cell


@pytest.fixture
def tiny():
    from benchmark import harness

    return lambda name, runs=2: shrink(harness.load_cell(name), runs)


#: a rank's command in the launcher's tests: ``setup`` (code run first,
#: with ``rank``), then ``ranks.rank_main``; a token among its arguments
#: finds the launch's processes afterwards
BOOT = textwrap.dedent(r"""
    import os, sys
    sys.path.insert(0, sys.argv[1])
    rank = int(os.environ["RANK"])
    exec(sys.argv[3])
    from benchmark import ranks
    sys.exit(ranks.rank_main(sys.argv[4:]))
""")


def launch(cell, setup: str = "", control: bool = False, trace=False,
           **kw):
    """``ranks.launch`` of ``cell`` at its ranks over gloo on the CPU, one
    seed and a window of 1 s, ``setup`` run first in every rank; fails
    when a process of the launch outlives it."""
    from benchmark import ranks
    from benchmark.harness import ROOT

    token = f"bench-test-{os.getpid()}-{id(cell)}"
    got = ranks.launch(cell, [2**31 + 4242], 1.0, trace, control=control,
                       device="cpu",
                       rank_cmd=[sys.executable, "-c", BOOT, str(ROOT),
                                 token, setup], **kw)
    assert not left_over(token)
    return got


def left_over(token: str) -> list:
    """Processes whose command line holds ``token``."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if token.encode() in f.read():
                    out.append(int(pid))
        except OSError:
            pass
    return out
