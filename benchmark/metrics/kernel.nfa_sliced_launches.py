"""Launches of the count kernel (``csrc/nfa_sliced.cu``) a job: the
program's ``approx.launches`` marks, one a pass, each the launches that
pass made (a graph's replays and a discarded first-cap run included; past
2,097,120 candidates a run takes two).  The traced jobs' total over their
number; None where the program makes no such mark (an older program)."""

from benchmark.metrics.program_spans import by_job

PREFIX = "approx.launches="


def read(run):
    if run.trace is None:
        return None
    per = by_job(run.trace, lambda n: n.startswith(PREFIX))
    if not any(per):
        return None
    return sum(int(n[len(PREFIX):]) for job in per
               for _, _, n in job) / len(per)
