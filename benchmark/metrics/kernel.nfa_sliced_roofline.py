"""The count kernel's share of its roofline, %, over the traced jobs: the
least time their passes' counts need on this card (``nfa_sliced_work.py``)
over the device time of every launch of the kernel in them, so warm-up
launches and solid mode's discarded first-cap pass count as time lost.
Jobs whose passes' sizes cannot all be read are left out."""

from benchmark.metrics import nfa_sliced_work as work


def read(run):
    tr = run.trace
    card_peak = work.peak(run.card)
    if tr is None or card_peak is None:
        return None
    prm, need_s, spent_s = run.prm, 0.0, 0.0
    for job, (s, t) in zip(run.jobs, tr.jobs()):
        spent = tr.device_sum(s, t, lambda n: "nfa_sliced_kernel" in n)
        need = [(n_keep, n_valid, prm.sl + (end == "end"))
                for end, n_valid, n_keep in run.pass_work(job)]
        if spent > 0 and all(n is not None for n, _, _ in need):
            need_s += sum(work.least_s(c, w, m, prm.max_error, prm.k,
                                       card_peak) for c, w, m in need)
            spent_s += spent
    return 100.0 * need_s / spent_s if spent_s > 0 else None
