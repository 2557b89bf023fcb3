"""Run one benchmark cell once on an NVIDIA GPU.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (``BENCHMARK.json``).  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit;
the numbers are also the last lines of standard error.  An earlier line
of standard output gives the card.  Without a CUDA card, with fewer cards
than the cell takes, or with JAX or the JAX package loaded once the
window has closed, it prints no result and exits 1.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
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
    got = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), t_start=T_START)
    result, nums, card = got.result, got.checks, got.card
    found = harness.forbidden_modules()
    if found:
        sys.stderr.write(f"loaded after the window: {', '.join(found)}\n")
        return 1
    card["memory_peak_bytes"] = result["device"]["memory_peak_bytes"]
    print(json.dumps(dict(card=card)))
    result["checks"] = {k: dict(value=v, limit=harness.check.LIMITS[k])
                        for k, v in nums.items()}
    for k, v in nums.items():
        sys.stderr.write(f"check {k}: {v} (limit {harness.check.LIMITS[k]})\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
