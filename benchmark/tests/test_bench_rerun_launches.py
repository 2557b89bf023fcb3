"""The readers of the program's ``rerun`` spans and ``approx.launches``
marks (``pass.rerun_ms``, ``kernel.nfa_sliced_launches``) on hand-made
traces: a job's spans add up, marks add up per job over the traced jobs,
and a program that makes neither (the parent of these readers, an
untraced run) reads None, so the result leaves the metric out."""

from types import SimpleNamespace

import pytest

from benchmark.tests.test_bench_program_spans import MS, read, run_of

#: job 1 runs two passes, each rerun once at a regrown cap (3 launches a
#: pass: one at the first cap, two at the regrown one); job 2 runs one
#: pass that reruns nothing (1 launch); the rerun outside every job and
#: the ``eager`` span nested in a rerun are not counted as reruns
SOLID = [
    (0, 1 * MS, "engine"), (10 * MS, 11 * MS, "engine"),
    (2 * MS, 5 * MS, "rerun"), (2 * MS, 4 * MS, "eager"),
    (6 * MS, 8 * MS, "rerun"),
    (5 * MS, 5 * MS, "approx.launches=3"),
    (8 * MS, 8 * MS, "approx.launches=3"),
    (12 * MS, 12 * MS, "approx.launches=1"),
    (30 * MS, 35 * MS, "rerun"), (31 * MS, 31 * MS, "approx.launches=9"),
]


def test_readers_on_a_solid_trace():
    run = run_of(SOLID)
    # job 1: 3 + 2 ms of rerun, job 2: none
    assert read("pass.rerun_ms", run) == pytest.approx(2.5)
    assert read("kernel.nfa_sliced_launches", run) == 3.5


@pytest.mark.parametrize("name", ["pass.rerun_ms",
                                  "kernel.nfa_sliced_launches"])
def test_none_without_the_spans_and_marks(name):
    """An untraced run, a program older than the spans (its ``engine``
    span and ``regrow.reruns`` marks alone) and one whose traced jobs
    rerun nothing: None for the span, and for the counter where no pass
    marked it."""
    assert read(name, SimpleNamespace(trace=None)) is None
    older = run_of([(0, 1 * MS, "engine"), (10 * MS, 11 * MS, "engine"),
                    (2 * MS, 3 * MS, "eager"),
                    (3 * MS, 3 * MS, "regrow.reruns=1")])
    assert read(name, older) is None


def test_a_pass_without_rerun_still_counts_its_launches():
    run = run_of([(0, 1 * MS, "engine"), (10 * MS, 11 * MS, "engine"),
                  (2 * MS, 2 * MS, "approx.launches=1"),
                  (13 * MS, 13 * MS, "approx.launches=1")])
    assert read("pass.rerun_ms", run) is None
    assert read("kernel.nfa_sliced_launches", run) == 1.0
