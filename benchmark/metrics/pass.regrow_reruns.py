"""Passes run again at a larger cap (or, sharded, a larger bucket) a job:
the program's ``regrow.reruns`` marks, the traced jobs' total over their
number."""

from benchmark.metrics.program_spans import mark_totals


def read(run):
    per = mark_totals(run, "regrow.reruns")
    return None if not per else sum(per) / len(per)
