"""CLI entry point: ``python -m approx_counter_tpu_torch <input> [flags]``.

Flag-compatible with the reference ``adaptFinder`` binary
(approx_counter.cpp:604-669) and with ``python -m approx_counter_tpu``.
Runs on the first CUDA device; without one it exits 1 and never falls back
to the CPU.  ``--profile DIR`` records the run with ``torch.profiler`` and
writes a Chrome trace, ``DIR/trace.json``.
"""

from __future__ import annotations

import contextlib
import os
import sys


@contextlib.contextmanager
def profiled(profile_dir: str, device):
    """``torch.profiler`` over the block when ``profile_dir`` is set (CPU
    activity, and CUDA activity on a CUDA device), its Chrome trace
    written to ``profile_dir/trace.json`` on the way out, also when the
    block raises; a plain block otherwise."""
    if not profile_dir:
        yield
        return
    import torch

    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    # one recording cycle: acc_events keeps torch from warning that a new
    # cycle would clear the events
    prof = torch.profiler.profile(activities=activities, acc_events=True)
    prof.start()
    try:
        yield
    finally:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def run(prm, device) -> int:
    """``run_pipeline(prm)`` on ``device``, under the profiler when
    ``prm.profile_dir`` is set, with a missing file or malformed input
    mapped to exit 1 and its ``/!\\`` message.  Returns the exit code."""
    from approx_counter_tpu_torch.io.fastx import InputFormatError
    from approx_counter_tpu_torch.pipeline import run_pipeline

    try:
        with profiled(prm.profile_dir, device):
            return run_pipeline(prm, device=device)
    except FileNotFoundError as e:
        sys.stderr.write(f"/!\\ ERROR: COULD NOT OPEN FILE {e.args[0]}\n")
        return 1
    except InputFormatError as e:
        # Malformed input (COMPAT #19): exit 1 with the /!\ prefix.
        sys.stderr.write(f"/!\\ ERROR: {e}\n")
        return 1


def main(argv: list[str] | None = None) -> int:
    import torch

    from approx_counter_tpu_torch.config.cli import resolve_params
    from approx_counter_tpu_torch.io.logging import error

    prm = resolve_params(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        error("no CUDA device: the PyTorch port runs on an NVIDIA GPU")
        return 1
    return run(prm, torch.device("cuda"))


if __name__ == "__main__":
    sys.exit(main())
