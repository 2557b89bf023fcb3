"""The readings a cell's limits are set from, on an NVIDIA GPU.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        --seconds 3

For each seed, in one process (a cell on several cards: in one launch of
its ranks, ``ranks.py``): a run of the cell at its own size with a short
window (``harness.run_cell``), the program's compared numbers (the
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


def readings(got, seed: int) -> dict:
    """One seed's line: the program's and the control's numbers."""
    return dict(seed=seed, jobs=got.result["attempted"], program=got.checks,
                control=got.control, correct=got.result["correct"])


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

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        sys.stderr.write(f"needs {cell.chips} CUDA card(s)\n")
        return 1
    from approx_counter_tpu_torch.config.cli import resolve_params

    kind = harness.check.control_kind(
        resolve_params(cell.config["args"] + ["reads.fa"]))
    seeds = [int(s) for s in args.seeds.split(",")]
    if cell.chips > 1:
        from benchmark import ranks

        got = ranks.launch(cell, seeds, args.seconds, False, control=True)
        sys.stderr.write(got.err[0])
        if got.rc != 0:
            sys.stderr.write("".join(got.err[1:])[-4000:])
            return got.rc
        lines = (json.loads(x) for x in got.out[0].splitlines())
    else:
        lines = (readings(harness.run_cell(
            cell, seed, args.seconds, False, torch.device("cuda", 0),
            control=True), seed) for seed in seeds)
    lower, upper = {}, {}
    for line in lines:
        print(json.dumps(line), flush=True)
        for key, v in line["program"].items():
            lower[key] = max(lower.get(key, v), v)
        for key, v in line["control"].items():
            upper[key] = min(upper.get(key, v), v)
    print(json.dumps(dict(workload=args.workload, control=kind,
                          lower=lower, upper=upper)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
