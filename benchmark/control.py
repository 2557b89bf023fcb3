"""The readings a cell's limits are set from, on an NVIDIA GPU.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        --seconds 3

For each seed, in one process: a run of the cell at its own size with a
short window (``harness.run_cell``), the program's compared numbers (the
lower readings), and the configuration's control (``check.control_kind``:
the plain reference in the program's place with one guarantee broken,
``check.control_output``) judged on the same passes (the upper
readings).  One JSON line a seed, then one with the largest
lower and the smallest upper reading of each number.  The benchmark's own
runs never run the control.
"""

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA card\n")
        return 1
    from approx_counter_tpu_torch.config.cli import resolve_params

    kind = harness.check.control_kind(
        resolve_params(cell.config["args"] + ["reads.fa"]))
    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        got = harness.run_cell(cell, seed, args.seconds, False,
                               torch.device("cuda", 0), control=True)
        print(json.dumps(dict(seed=seed, jobs=got.result["attempted"],
                              program=got.checks, control=got.control,
                              correct=got.result["correct"])), flush=True)
        for key, v in got.checks.items():
            lower[key] = max(lower.get(key, v), v)
        for key, v in got.control.items():
            upper[key] = min(upper.get(key, v), v)
    print(json.dumps(dict(workload=args.workload, control=kind,
                          lower=lower, upper=upper)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
