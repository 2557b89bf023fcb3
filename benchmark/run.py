"""Run one benchmark cell once on NVIDIA GPUs.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (``BENCHMARK.json``).  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit;
the numbers are also the last lines of standard error.  An earlier line
of standard output gives the card.  A cell on one card runs in this
process on ``cuda:0``; a cell on more runs as that many ranks of the
program's ``--multihost`` path, one a card (``ranks.py``), whose rank 0's
lines this process prints once every rank has ended well.  Without a CUDA
card, with fewer cards than the cell takes, with a rank that failed or
hung, or with JAX or the JAX package loaded once the window has closed,
it prints no result and exits 1 (or the failed rank's exit code).
"""

import time

T_START = time.perf_counter()
T_MONO = time.monotonic()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        sys.stderr.write(f"{args.workload} needs {cell.chips} CUDA card(s); "
                         f"found {torch.cuda.device_count()}\n")
        return 1
    if cell.chips > 1:
        return run_ranks(cell, args)
    got = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        sys.stderr.write(f"loaded after the window: {', '.join(found)}\n")
        return 1
    harness.report(got)
    return 0


def run_ranks(cell, args) -> int:
    """The cell as ``cell.chips`` ranks (``ranks.launch``): the other ranks'
    logs, then rank 0's on standard error, and rank 0's lines on standard
    output once every rank has ended with 0."""
    from benchmark import harness, ranks

    if "--multihost" not in cell.config["args"]:
        sys.stderr.write(f"{args.workload} takes {cell.chips} cards but its "
                         "configuration is not --multihost\n")
        return 1
    got = ranks.launch(cell, [args.seed], args.seconds, bool(args.trace),
                       t0=T_MONO)
    for r, err in enumerate(got.err[1:], 1):
        sys.stderr.write("".join(f"[rank {r}] {line}\n"
                                 for line in err[-4000:].splitlines()))
    sys.stderr.write(got.err[0])
    found = harness.forbidden_modules()
    if found:
        sys.stderr.write(f"loaded after the window: {', '.join(found)}\n")
        return 1
    if got.rc != 0:
        sys.stderr.write(f"a rank failed (exit code {got.rc}): no result\n")
        return got.rc
    sys.stdout.write(got.out[0])
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
