"""CLI entry point: ``python -m approx_counter_tpu_torch <input> [flags]``.

Flag-compatible with the reference ``adaptFinder`` binary
(approx_counter.cpp:604-669) and with ``python -m approx_counter_tpu``.
Runs on the first CUDA device; without one it exits 1 and never falls back
to the CPU.
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    import torch

    from approx_counter_tpu_torch.config.cli import resolve_params
    from approx_counter_tpu_torch.io.fastx import InputFormatError
    from approx_counter_tpu_torch.io.logging import error
    from approx_counter_tpu_torch.pipeline import run_pipeline

    prm = resolve_params(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        error("no CUDA device: the PyTorch port runs on an NVIDIA GPU")
        return 1
    try:
        return run_pipeline(prm, device=torch.device("cuda"))
    except FileNotFoundError as e:
        sys.stderr.write(f"/!\\ ERROR: COULD NOT OPEN FILE {e.args[0]}\n")
        return 1
    except InputFormatError as e:
        # Malformed input (COMPAT #19): exit 1 with the /!\ prefix.
        sys.stderr.write(f"/!\\ ERROR: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
