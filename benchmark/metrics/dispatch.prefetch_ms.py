"""Host ms of the program's ``prefetch`` range (sampling, packing and
shipping the next pass while one counts), median over every range in the
traced jobs."""

from benchmark.trace import median


def read(run):
    if run.trace is None:
        return None
    return median((t - s) / 1e6 for s, t in run.trace.named("prefetch"))
