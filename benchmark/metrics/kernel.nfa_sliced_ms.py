"""Device ms a job spends in the count kernel (``csrc/nfa_sliced.cu``,
``nfa_sliced_kernel``), every launch counted: the traced jobs' total over
their number.  A total and not a median, because a solid-mode job whose
two ends regrow to the same cap reuses the first end's graph and launches
the kernel once less at that cap, so a median over jobs jumps by a whole
launch with the share of such jobs."""


def read(run):
    tr = run.trace
    jobs = tr.jobs() if tr is not None else []
    if not jobs or not any("nfa_sliced_kernel" in op[2]
                           for op in tr.device_ops):
        return None
    return sum(tr.device_sum(s, t, lambda n: "nfa_sliced_kernel" in n)
               for s, t in jobs) * 1e3 / len(jobs)
