"""What a traced run reads from ``torch.profiler``.

The events are taken from the profiler in memory (no Chrome trace is
written): the device's operations (kernels, copies, fills), the host's
``record_function`` ranges (the program's ``start pass``, ``end pass``
and ``prefetch``, the harness's ``bench job``) and the host's operations
on the thread that runs the jobs, which name what the host was doing while
the device was idle.  Times are nanoseconds on the profiler's clock.
"""

from __future__ import annotations

import bisect
import collections

import numpy as np

#: the harness's range around each traced job
JOB = "bench job"
#: idle gaps shorter than this are summed under one label, unnamed
SHORT_GAP_NS = 20_000


class Trace:
    """Device operations ``(start, end, name, kind)`` in start order,
    host ranges ``(start, end, name)`` and the job thread's top-level
    host operations ``(start, end, name)``."""

    def __init__(self, device_ops: list, ranges: list, host_ops: list):
        self.device_ops = sorted(device_ops)
        self._dev_starts = [op[0] for op in self.device_ops]
        self.ranges = sorted(ranges)
        self.host_ops = _top_level(sorted(host_ops))
        self._host_starts = [op[0] for op in self.host_ops]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        device_ops, ranges, host = [], [], []
        job_threads = set()
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    device_ops.append((start, end, e.name(),
                                       _kind(e.name())))
            elif e.is_user_annotation():
                ranges.append((start, end, e.name()))
                if e.name() == JOB:
                    job_threads.add(e.start_thread_id())
            else:
                host.append((start, end, e.name(), e.start_thread_id()))
        host_ops = [(s, t, n) for s, t, n, tid in host if tid in job_threads]
        return cls(device_ops, ranges, host_ops)

    def named(self, name: str) -> list:
        """``(start, end)`` of every host range called ``name``."""
        return [(s, t) for s, t, n in self.ranges if n == name]

    def jobs(self) -> list:
        return self.named(JOB)

    def device_sum(self, start: int, end: int, keep) -> float:
        """Seconds of the kernels that start in ``[start, end)`` and whose
        name ``keep`` accepts, summed."""
        lo = bisect.bisect_left(self._dev_starts, start)
        hi = bisect.bisect_left(self._dev_starts, end)
        return sum(t - s for s, t, n, kind in self.device_ops[lo:hi]
                   if kind == "kernel" and keep(n)) / 1e9

    def busy(self, start: int, end: int) -> list:
        """The union of the device operations, clipped to
        ``[start, end)``: disjoint ``(start, end)`` intervals."""
        out = []
        for s, t, _, _ in self.device_ops:
            s, t = max(s, start), min(t, end)
            if s >= t:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [tuple(iv) for iv in out]

    def window(self) -> tuple:
        jobs = self.jobs()
        return (jobs[0][0], jobs[-1][1]) if jobs else (0, 0)

    def busy_s(self) -> float:
        """Seconds of the traced window in which the device ran anything."""
        return sum(t - s for s, t in self.busy(*self.window())) / 1e9

    def host_label(self, at: int) -> str:
        """What the host was doing at ``at``: the innermost range around
        it and the job thread's top-level operation, if any."""
        inner = min(((t - s, n) for s, t, n in self.ranges if s <= at < t),
                    default=(0, "outside the jobs"))[1]
        i = bisect.bisect_right(self._host_starts, at) - 1
        op = (self.host_ops[i][2] if i >= 0 and at < self.host_ops[i][1]
              else "python")
        return f"{inner}: {op}"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing, ``[name, seconds]`` each."""
        start, end = self.window()
        ops = collections.Counter()
        for s, t, n, _ in self.device_ops:
            if start <= s < end:
                ops[n] += (t - s) / 1e9
        gaps = collections.Counter()
        edge = start
        for s, t in self.busy(start, end) + [(end, end)]:
            if s - edge >= SHORT_GAP_NS:
                gaps[self.host_label((edge + s) // 2)] += (s - edge) / 1e9
            elif s > edge:
                gaps["gaps under 20 us"] += (s - edge) / 1e9
            edge = max(edge, t)
        return dict(device_ops=[[n, v] for n, v in ops.most_common(top)],
                    idle_gaps=[[n, v] for n, v in gaps.most_common(top)])


def _kind(name: str) -> str:
    """A device operation's kind by its name: a copy, a fill or a
    kernel."""
    if name.startswith("Memcpy"):
        return "copy"
    return "fill" if name.startswith("Memset") else "kernel"


def _top_level(ops: list) -> list:
    """The operations no other one encloses, from ops sorted by start."""
    out = []
    for s, t, n in ops:
        if out and s < out[-1][1]:
            continue
        out.append((s, t, n))
    return out


def median(values):
    """The median of ``values``, or None when there are none."""
    values = [v for v in values if v is not None]
    return float(np.median(values)) if values else None
