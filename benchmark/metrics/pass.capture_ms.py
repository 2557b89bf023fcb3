"""Host ms a job spends making the fused pass's CUDA graphs: the
program's ``warm-up`` (the body run once eagerly) and ``capture``
(``capture_begin`` to ``capture_end``) spans on the engine's worker
thread, the traced jobs' total over their number.  A total and not a
median, because captures come in bursts: a solid-mode job captures at the
first cap and again at each regrown cap its graphs do not share."""

from benchmark.metrics.program_spans import span_seconds


def read(run):
    per = span_seconds(run, "warm-up", "capture")
    return None if per is None else sum(per) * 1e3 / len(per)
