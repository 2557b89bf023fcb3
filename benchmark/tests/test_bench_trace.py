"""Reading a trace: the device's busy time, kernel sums by job and the
breakdown, on hand-made events."""

from benchmark.trace import JOB, Trace, median

MS = 1_000_000


def make():
    dev = [(1 * MS, 3 * MS, "nfa_sliced_kernel<16, 2>", "kernel"),
           (2 * MS, 4 * MS, "add_kernel", "kernel"),
           (6 * MS, 7 * MS, "Memcpy HtoD", "copy"),
           (12 * MS, 13 * MS, "add_kernel", "kernel")]
    ranges = [(0, 10 * MS, JOB), (10 * MS, 20 * MS, JOB),
              (5 * MS, 6 * MS, "prefetch")]
    host = [(4 * MS, 5 * MS + MS // 2, "aten::sort")]
    return Trace(dev, ranges, host)


def test_busy_and_window():
    tr = make()
    assert tr.window() == (0, 20 * MS)
    assert tr.busy(0, 20 * MS) == [(1 * MS, 4 * MS), (6 * MS, 7 * MS),
                                   (12 * MS, 13 * MS)]
    assert abs(tr.busy_s() - 0.005) < 1e-12


def test_kernel_sums_by_job():
    tr = make()
    (a, b), (c, d) = tr.jobs()
    assert tr.device_sum(a, b, lambda n: "nfa_sliced_kernel" in n) == 0.002
    assert tr.device_sum(a, b, lambda n: "nfa_sliced" not in n) == 0.002
    assert tr.device_sum(c, d, lambda n: True) == 0.001
    assert [(s, t) for s, t in tr.named("prefetch")] == [(5 * MS, 6 * MS)]


def test_breakdown():
    got = make().breakdown()
    ops = dict(got["device_ops"])
    assert ops["add_kernel"] == 0.003 and ops["Memcpy HtoD"] == 0.001
    gaps = dict(got["idle_gaps"])
    # the gap 4-6 ms: its midpoint is in ``prefetch`` and in the sort
    assert gaps["prefetch: aten::sort"] == 0.002
    assert abs(gaps[f"{JOB}: python"] - 0.013) < 1e-12
    assert abs(sum(gaps.values()) - 0.015) < 1e-12
    assert len(got["device_ops"]) <= 10 and len(got["idle_gaps"]) <= 10


def test_median_skips_missing():
    assert median([None, 1.0, 3.0]) == 2.0
    assert median([None]) is None


def test_device_readers_total_over_the_traced_jobs():
    """The count kernel's ms a job and the other kernels' ms a job are the
    traced jobs' totals over their number, not a median that jumps with
    a job that launches the kernel once less."""
    from types import SimpleNamespace

    from benchmark import harness

    run = SimpleNamespace(trace=make())
    # job 1: 2 ms of count kernel, 2 of others; job 2: 0 and 1
    assert harness.reader("kernel.nfa_sliced_ms")(run) == 1.0
    assert harness.reader("pass.device_ms")(run) == 1.5
    assert harness.reader("kernel.nfa_sliced_ms")(
        SimpleNamespace(trace=None)) is None
