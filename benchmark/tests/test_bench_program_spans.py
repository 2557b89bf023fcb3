"""The readers of the program's own spans and counter marks, on
hand-made traces: a span or mark belongs to the job whose range holds its
start, worker-thread spans count like any other, marks add up per job, and
a run with no such span or mark (an older program, an untraced run) reads
None, or 0 for a counter of a program that records counters."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.metrics import program_spans
from benchmark.trace import JOB, Trace

MS = 1_000_000


def run_of(ranges):
    """A run whose trace holds two jobs (0-10 ms, 10-20 ms) and
    ``ranges``."""
    return SimpleNamespace(trace=Trace(
        [], [(0, 10 * MS, JOB), (10 * MS, 20 * MS, JOB)] + ranges, []))


#: one job of each kind: job 1 captures twice (once on the worker thread
#: at a regrown cap), job 2 once; a span outside every job is left out
PROGRAM = [
    (0, 1 * MS, "engine"), (10 * MS, 11 * MS, "engine"),
    (1 * MS, 2 * MS, "sample"), (12 * MS, 15 * MS, "sample"),
    (2 * MS, 3 * MS, "warm-up"), (3 * MS, 5 * MS, "capture"),
    (6 * MS, 7 * MS, "warm-up"), (7 * MS, 8 * MS, "capture"),
    (11 * MS, 12 * MS, "warm-up"), (12 * MS, 14 * MS, "capture"),
    # starts in job 1, ends in job 2: job 1's
    (9 * MS, 11 * MS, "export"), (16 * MS, 17 * MS, "export"),
    (17 * MS, 18 * MS, "export"),
    (30 * MS, 40 * MS, "capture"),
    (2 * MS, 2 * MS, "upload.bytes=1000"), (5 * MS, 5 * MS,
                                            "upload.bytes=24"),
    (13 * MS, 13 * MS, "upload.bytes=500"),
    (6 * MS, 6 * MS, "regrow.reruns=1"), (8 * MS, 8 * MS, "regrow.reruns=1"),
    (31 * MS, 31 * MS, "regrow.reruns=1"),
]


def read(name, run):
    return harness.reader(name)(run)


def test_spans_and_marks_go_to_the_job_that_holds_their_start():
    run = run_of(PROGRAM)
    assert program_spans.span_seconds(run, "export") == [0.002, 0.002]
    assert program_spans.mark_totals(run, "upload.bytes") == [1024, 500]
    assert program_spans.mark_totals(run, "regrow.reruns") == [2, 0]


def test_readers_on_a_program_trace():
    run = run_of(PROGRAM)
    # job 1: 1 + 2 + 1 + 1 ms of warm-up and capture; job 2: 1 + 2
    assert read("pass.capture_ms", run) == pytest.approx(4.0)
    assert read("pass.regrow_reruns", run) == 1.0
    assert read("dispatch.sample_ms", run) == pytest.approx(2.0)
    assert read("dispatch.upload_bytes", run) == 762.0
    assert read("export.ms", run) == pytest.approx(2.0)


NEW = ["pass.capture_ms", "pass.regrow_reruns", "dispatch.sample_ms",
       "dispatch.upload_bytes", "export.ms"]


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_program_spans(name):
    """An untraced run, and a traced program older than these spans (only
    its pass ranges), read None: the result leaves the metric out."""
    assert read(name, SimpleNamespace(trace=None)) is None
    older = run_of([(1 * MS, 5 * MS, "start pass"),
                    (2 * MS, 3 * MS, "prefetch")])
    assert read(name, older) is None


def test_counters_read_zero_where_the_program_counts_none():
    """A program with spans but no rerun in any traced job reads 0
    reruns, not None."""
    run = run_of([(0, 1 * MS, "engine"), (10 * MS, 11 * MS, "engine"),
                  (2 * MS, 3 * MS, "upload.bytes=8")])
    assert read("pass.regrow_reruns", run) == 0.0
    assert read("dispatch.upload_bytes", run) == 4.0
    assert read("pass.capture_ms", run) is None
