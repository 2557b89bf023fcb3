"""Host ms a job spends in passes run again at a regrown cap (or,
sharded, a larger bucket): the program's ``rerun`` spans on the engine's
worker thread, each from the rerun's call through its fetch, so they hold
its device time.  The traced jobs' total over their number, as
``pass.capture_ms`` reads its spans; None where the program makes no such
span (an older program, or a run whose traced jobs rerun nothing)."""

from benchmark.metrics.program_spans import span_seconds


def read(run):
    per = span_seconds(run, "rerun")
    return None if per is None else sum(per) * 1e3 / len(per)
