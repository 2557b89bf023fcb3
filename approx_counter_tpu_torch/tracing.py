"""The program's spans and counters, on ``torch.profiler``'s clock.

There is one recorder, ``torch.profiler``: ``--profile`` runs it over a
whole run (``profiled``), and a caller may run it around ``__main__.run``.
While it records, ``span(name)`` is a ``record_function`` range on the
thread that enters it, and ``count(name, n)`` puts a range named
``"<name>=<n>"`` of no real length at the point of the work, so a
counter's increments are events on the same timeline as the device's
operations, inside the span that caused them.  While nothing records both
cost one check of a flag: no range is made.

The flag is ``torch.autograd.profiler._is_profiler_enabled``, which the
profiler sets for the whole process when it starts.
``torch.autograd._profiler_enabled()`` is not used: it reads the calling
thread's state, which the engine's worker thread never has, and under
``profile_all_threads`` not even the thread that started the profiler.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.autograd.profiler as _profiler_state

#: the context ``span`` gives while nothing records (reusable, reentrant)
_NULL = contextlib.nullcontext()


def span(name: str):
    """A context: the range ``name`` while a profiler records, else one
    that does nothing."""
    if _profiler_state._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``: a mark ``"<name>=<n>"`` on the
    trace while a profiler records, else nothing."""
    if _profiler_state._is_profiler_enabled:
        with torch.profiler.record_function(f"{name}={n}"):
            pass


@contextlib.contextmanager
def profiled(profile_dir: str, device):
    """``torch.profiler`` over the block when ``profile_dir`` is set (CPU
    activity on every thread, the engine's worker among them, and CUDA
    activity on a CUDA device), its Chrome trace
    written on the way out, also when the block raises: to
    ``profile_dir/trace.json``, or ``profile_dir/trace.rank<r>.json`` in a
    process group; a plain block otherwise."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    # one recording cycle: acc_events keeps torch from warning that a new
    # cycle would clear the events
    prof = torch.profiler.profile(
        activities=activities, acc_events=True,
        experimental_config=torch.profiler._ExperimentalConfig(
            profile_all_threads=True))
    prof.start()
    try:
        yield
    finally:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        name = "trace.json"
        if torch.distributed.is_initialized():
            name = f"trace.rank{torch.distributed.get_rank()}.json"
        prof.export_chrome_trace(os.path.join(profile_dir, name))
