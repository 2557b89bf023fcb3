"""Device ms a job spends in every kernel but the count kernel (the
fused pass's exact stage, re-rank and packing, the pool's gather, the
unpacking of uploads): the traced jobs' total over their number."""


def read(run):
    tr = run.trace
    jobs = tr.jobs() if tr is not None else []
    if not jobs or not tr.device_ops:
        return None
    return sum(tr.device_sum(s, t, lambda n: "nfa_sliced_kernel" not in n)
               for s, t in jobs) * 1e3 / len(jobs)
