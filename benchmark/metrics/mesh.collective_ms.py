"""Device ms a job spends in the multihost step's collectives on rank 0's
card: the NCCL kernels (``nccl`` in the name: the exchange's
``all_to_all_single``, the selections' ``all_gather`` and the counts'
``all_reduce``), the traced jobs' total over their number.  A collective's
kernel runs from when this rank enters it until every rank has, so the
time includes the wait for a slower rank, not only the transfer.  None in
a run with no NCCL kernel (one card, or ranks over gloo)."""


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def read(run):
    tr = run.trace
    jobs = tr.jobs() if tr is not None else []
    if not jobs or not any(is_nccl(op[2]) for op in tr.device_ops):
        return None
    return sum(tr.device_sum(s, t, is_nccl) for s, t in jobs) * 1e3 / len(
        jobs)
