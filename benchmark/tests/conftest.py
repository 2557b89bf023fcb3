"""Shared fixtures: the benchmark's cells at a size the CPU runs in
seconds (800 reads of 130-400 bases, 600 windows of 60 bases a pass,
k = 12, 40 candidates), with every other setting as the cell has it."""

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
    cell.config = dict(cell.config, args=args)
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC)
    cell.workload = dict(cell.workload, trace_jobs=2, check_passes=3)
    return cell


@pytest.fixture
def tiny():
    from benchmark import harness

    return lambda name, runs=2: shrink(harness.load_cell(name), runs)
