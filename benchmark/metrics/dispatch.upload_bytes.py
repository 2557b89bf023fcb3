"""Bytes a job hands to the device for its windows: the program's
``upload.bytes`` marks (each array given to ``Engine._upload``: packed
batches, the device pool's planes, pool index vectors), the traced jobs'
total over their number."""

from benchmark.metrics.program_spans import mark_totals


def read(run):
    per = mark_totals(run, "upload.bytes")
    return None if not per else sum(per) / len(per)
