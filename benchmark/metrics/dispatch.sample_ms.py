"""Host ms of the program's ``sample`` span (one pass's sampling of read
windows, or under ``--stream`` one run's reservoir pass), median over
every span in the traced jobs."""

from benchmark.metrics.program_spans import spans
from benchmark.trace import median


def read(run):
    per = spans(run, "sample")
    if per is None:
        return None
    return median((t - s) / 1e6 for job in per for s, t in job)
