"""Host ms a job spends writing its exports: the program's ``export``
spans (one per ``export_counter`` call), each traced job's total, median
over the jobs."""

from benchmark.metrics.program_spans import span_seconds
from benchmark.trace import median


def read(run):
    per = span_seconds(run, "export")
    return None if per is None else median(s * 1e3 for s in per)
