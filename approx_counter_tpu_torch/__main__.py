"""CLI entry point: ``python -m approx_counter_tpu_torch <input> [flags]``.

Flag-compatible with the reference ``adaptFinder`` binary
(approx_counter.cpp:604-669) and with ``python -m approx_counter_tpu``.
Runs on the first CUDA device; without one it exits 1 and never falls back
to the CPU.  ``--profile DIR`` records the run with ``torch.profiler`` and
writes a Chrome trace, ``DIR/trace.json``.

``--multihost`` runs ``dist/multihost.py`` on this rank's card.  Under
``torchrun`` (``WORLD_SIZE`` > 1) the process group is joined from its
environment and left on the way out, and each rank's trace is
``DIR/trace.rank<r>.json``; without that environment the run has one rank.
"""

from __future__ import annotations

import os
import sys

from approx_counter_tpu_torch.tracing import profiled


def run(prm, device) -> int:
    """``run_pipeline(prm)``, or ``run_pipeline_multihost(prm)`` with
    ``prm.multihost``, on ``device``, under the profiler when
    ``prm.profile_dir`` is set, with a missing file or malformed input
    mapped to exit 1 and its ``/!\\`` message.  Returns the exit code."""
    from approx_counter_tpu_torch.io.fastx import InputFormatError
    from approx_counter_tpu_torch.pipeline import run_pipeline

    try:
        with profiled(prm.profile_dir, device):
            if prm.multihost:
                from approx_counter_tpu_torch.dist.multihost import (
                    run_pipeline_multihost,
                )

                return run_pipeline_multihost(prm, device=device)
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
    if not prm.multihost:
        return run(prm, torch.device("cuda"))

    from approx_counter_tpu_torch.dist import mesh

    if int(os.environ.get("WORLD_SIZE", 1)) <= 1:
        return run(prm, mesh.rank_device())
    mesh.initialize()
    try:
        return run(prm, mesh.rank_device())
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
