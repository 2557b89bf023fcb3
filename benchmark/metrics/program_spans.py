"""The program's own spans and counter marks in a traced run, by job.

The program (``approx_counter_tpu_torch/tracing.py``) records a span as a
``torch.profiler`` range named for its layer's work (``sample``,
``warm-up``, ``capture``, ``export`` ...), on whichever thread does it,
and each increment of a counter as a mark: a range named
``"<counter>=<n>"`` at the point of the work.  A span or mark belongs to
the traced job whose ``bench job`` range holds its start.  A program that
records neither (one older than its ``engine`` span) gives every reader
here None.
"""

import bisect


def by_job(tr, keep) -> list:
    """For each traced job, the ranges ``(start, end, name)`` whose name
    ``keep`` accepts and whose start lies in that job's range."""
    jobs = tr.jobs()
    starts = [s for s, _ in jobs]
    out = [[] for _ in jobs]
    for s, t, n in tr.ranges:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < jobs[i][1] and keep(n):
            out[i].append((s, t, n))
    return out


def spans(run, *names) -> list | None:
    """Each traced job's spans called one of ``names``, ``(start, end)``
    in ns; None when no traced job holds one."""
    if run.trace is None:
        return None
    per = by_job(run.trace, lambda n: n in names)
    if not any(per):
        return None
    return [[(s, t) for s, t, _ in job] for job in per]


def span_seconds(run, *names) -> list | None:
    """Each traced job's seconds in the spans ``names``, summed; None when
    no traced job holds one."""
    per = spans(run, *names)
    if per is None:
        return None
    return [sum(t - s for s, t in job) / 1e9 for job in per]


def mark_totals(run, counter: str) -> list | None:
    """Each traced job's total of the counter's marks, 0 where a job has
    none; None when the run has no trace or its program records no
    counters (no ``engine`` span in any traced job)."""
    if run.trace is None or spans(run, "engine") is None:
        return None
    prefix = counter + "="
    per = by_job(run.trace, lambda n: n.startswith(prefix))
    return [sum(int(n[len(prefix):]) for _, _, n in job) for job in per]
