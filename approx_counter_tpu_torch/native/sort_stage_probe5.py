"""Bitonic-stage probe on the card: the compare-exchange stage rate of a
hand-written sort, beside the library sort it would have to beat.

    python -m approx_counter_tpu_torch.native.sort_stage_probe5 [--device cuda]

Port of the JAX package's ``native/sort_stage_probe5.py``.  Its question:
can a hand-written blocked bitonic sort beat the library's flat 1-key sort
at P = 3,522,560 keys (about the exact stage's code count per end)?  A 4 M
element blocked bitonic sort needs ~210 compare-exchange stages per block
plus tile transposes for the sub-lane distances; the probe times them with
the stage network of ``kernels/sort_stage.py`` (``csrc/sort_stage.cu`` on
the card):

  (s1) 210 stages at an 8-row distance on int32 [32768, 128] (16 MB, the
       script's 4 blocks of [8192, 128]): the pure min/max throughput;
  (s2) 10 levels of 20 stages, each followed by a transpose of every
       128 x 128 tile: the lane-dimension handling cost.  That is 200
       stages, and the rate here divides by 200 (the script's line
       divides by 210).

and, as the reference point, ``torch.sort(stable=False)`` of P keys drawn
as the script draws them, twice: as int32 with the sign bit flipped (the
script's 32-bit unsigned keys, in the same order) and as int64 (the exact
stage's code dtype).  ``torch.sort`` also returns the permutation; no
values-only sort exists in torch.

Inputs come from ``np.random.default_rng(7)`` as in the script, one buffer
per timed call plus a spare for the warm-up.  Times are the best of 3
trials of the mean over ``ITERS`` calls, by CUDA events on the card (the
host clock with ``--device cpu``).  Lines go to stderr with the script's
``[bench]`` prefix.  Without a CUDA device it exits 1 unless ``--device
cpu`` asks for the plain version.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from approx_counter_tpu_torch.kernels.sort_stage import (
    LANES,
    stage_network,
    stages_run,
)

ROWS = 8192          # rows of one of the script's blocks
BLOCKS = 4           # 16 MB in all: the padded P = 4 M array
STAGES = 210         # in-block bitonic network depth (2^20)
TRANSPOSE_EVERY = 20
ITERS = 6
P = 3522560          # keys of the reference sort


def log(msg: str) -> None:
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


def time_chained(run, iters: int, device: torch.device,
                 trials: int = 3) -> float:
    """Seconds per call: ``run(i)`` must use input buffer ``i``, and
    ``run(iters)`` warms up on the spare buffer.  Returns the best of
    ``trials`` means over ``iters`` calls, timed by CUDA events on a card
    and by the host clock on the CPU."""
    t0 = time.perf_counter()
    run(iters)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"first call (warm-up, any kernel build included): "
        f"{time.perf_counter() - t0:.4f} s")
    best = None
    for _ in range(trials):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(iters):
                run(i)
            stop.record()
            stop.synchronize()
            dt = start.elapsed_time(stop) / 1e3 / iters
        else:
            t = time.perf_counter()
            for i in range(iters):
                run(i)
            dt = (time.perf_counter() - t) / iters
        best = dt if best is None else min(best, dt)
    return best


def make_probe(transpose_every: int, stages: int = STAGES):
    """The script's ``run``: the stage network on ``x``, returning
    ``out[:64, :1]``."""
    def run(x: torch.Tensor) -> torch.Tensor:
        return stage_network(x, stages, transpose_every)[:64, :1]

    return run


def main(argv: list[str] | None = None, *, rows: int = ROWS,
         blocks: int = BLOCKS, stages: int = STAGES, iters: int = ITERS,
         keys: int = P) -> int:
    """Run the probe; returns the exit code.  The keyword arguments shrink
    it for a test on the CPU."""
    ap = argparse.ArgumentParser(
        prog="python -m approx_counter_tpu_torch.native.sort_stage_probe5",
        description="Time the compare-exchange stage network against "
                    "torch.sort.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; exits 1 without a CUDA device) or "
                         "cpu (the plain version)")
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("sort_stage_probe5: no CUDA device", file=sys.stderr)
        return 1
    where = (f"{torch.cuda.get_device_name(device)}, CUDA events"
             if device.type == "cuda" else "cpu, host clock")

    rng = np.random.default_rng(7)
    xs = [torch.from_numpy(rng.integers(0, 1 << 31, (blocks * rows, LANES))
                           .astype(np.int32)).to(device)
          for _ in range(iters + 1)]
    elems = blocks * rows * LANES
    log(f"model: {stages} stages x {blocks} x {rows}x{LANES} int32 "
        f"({stages * elems / 1e9:.4f} G elem-stages) on {where}")
    for name, te in (("(s1) stages only", 0),
                     (f"(s2) + transpose/{TRANSPOSE_EVERY}", TRANSPOSE_EVERY)):
        fn = make_probe(te, stages)
        dt = time_chained(lambda i, f=fn: f(xs[i]), iters, device)
        run_stages = stages_run(stages, te)
        log(f"{name:22s}: {dt * 1e3:.4f} ms "
            f"({run_stages * elems / dt / 1e12:.4f} T elem-stages/s over the "
            f"{run_stages} stages run)")
    del xs

    # reference point in the same session: the library's flat 1-key sort
    ys = [rng.integers(0, 1 << 32, keys, dtype=np.uint64).astype(np.uint32)
          for _ in range(iters + 1)]
    for name, keyed in (
            ("int32, sign bit flipped", lambda y: (y ^ np.uint32(1 << 31))
             .view(np.int32)),
            ("int64", lambda y: y.astype(np.int64))):
        ts = [torch.from_numpy(keyed(y)).to(device) for y in ys]
        dt = time_chained(
            lambda i: torch.sort(ts[i], stable=False).values[:64], iters,
            device)
        log(f"torch.sort P={keys} {name} (same session): {dt * 1e3:.4f} ms")
        del ts
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
