#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):
  1. Card: print ``nvidia-smi`` name and power limit, build every CUDA
     kernel the phases use from ``approx_counter_tpu_torch/csrc`` with nvcc,
     print the build seconds and the ptxas register report.
  2. Kernel vs its plain torch version on the card, exact integer equality:
     the default-run shape (C=500, W=40,000, m=101, k=16, maxerr=2, with N
     and pad symbols and invalid tail windows) and small shapes at
     k in {2, 3, 16, 31, 32} x maxerr 0-3.  Both times at the main shape,
     from CUDA events, warm-up excluded.
  3. The default CLI run (sn=40000, sl=100, k=16, top-500, --max-error 2,
     both ends) on a seeded synthetic FASTA of 50,000 reads with planted
     adapters, through ``approx_counter_tpu_torch.__main__.main``: rc 0, the
     kernel launched on the main path, 4 exports of 500 lines with adapter
     k-mers on top.  Per-end wall time from the CLI's own log timestamps.
  4. The same CLI at -sn 3000 on the card, and ``run_pipeline`` on the CPU:
     all exports byte-equal.
The last two lines of stdout are one JSON object on the kernels and one
``{"ok": true, "device": ...}`` object.

Imports nothing of JAX.  Exits 1 when no CUDA device is present.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

KERNEL_SOURCE = "approx_counter_tpu_torch/csrc/nfa_sliced.cu"
KERNEL_REPLACES = "approx_counter_tpu/kernels/bpm.py:718"
SMALL_KS = (2, 3, 16, 31, 32)
START_ADAPTER = "AATGTACTTCGTTCAGTTACGTATTGCT"
END_ADAPTER = "GCAATACGTAACTGAACGAAGTACATT"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_build() -> None:
    from approx_counter_tpu_torch.kernels._build import nfa_sliced_build

    configs = [(k, e) for k in SMALL_KS for e in range(4)]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        builds = dict(zip(configs, ex.map(lambda c: nfa_sliced_build(*c),
                                          configs)))
    wall = time.perf_counter() - t0
    log(f"[build] {len(configs)} nfa_sliced libraries in {wall:.2f} s wall "
        f"(nvcc, parallel); k=16 maxerr=2 alone "
        f"{builds[(16, 2)].seconds:.2f} s")
    for cfg in ((16, 2), (32, 3)):
        for line in builds[cfg].log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] k={cfg[0]} maxerr={cfg[1]}: {line.strip()}")


def random_case(rng, C: int, W: int, m: int, k: int, n_invalid: int):
    """Seeded candidates and windows (symbols 0-5: N and pad included),
    with planted exact and 1-edit hits and ``n_invalid`` invalid tail
    windows.  Returns numpy (codes int64 [C], windows_t uint8 [m, W],
    valid bool [W])."""
    pats = rng.integers(0, 4, (C, k))
    codes = np.zeros(C, np.int64)
    for i in range(k):
        codes = (codes << 2) | pats[:, i]
    wins = rng.integers(0, 4, (W, m)).astype(np.uint8)
    wins[rng.random((W, m)) < 0.002] = 4
    wins[rng.random(W) < 0.05, -1] = 5
    rows = np.arange(0, W, 3)
    pos = rng.integers(0, m - k + 1, len(rows))
    for w, p in zip(rows, pos):
        pat = pats[w % C].astype(np.uint8).copy()
        if w % 2:
            pat[rng.integers(0, k)] = rng.integers(0, 4)
        wins[w, p:p + k] = pat
    valid = np.ones(W, bool)
    valid[W - n_invalid:] = False
    return codes, np.ascontiguousarray(wins.T), valid


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_kernel() -> dict:
    import torch

    from approx_counter_tpu_torch.kernels.bpm import (
        approx_counts,
        approx_counts_ref,
        build_peq,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(20)
    max_err = 0

    def check(C, W, m, k, e, n_invalid):
        nonlocal max_err
        codes, wins_t, valid = random_case(rng, C, W, m, k, n_invalid)
        peq = build_peq(torch.from_numpy(codes).to(dev), k)
        wt = torch.from_numpy(wins_t).to(dev)
        vt = torch.from_numpy(valid).to(dev)
        got = approx_counts(peq, wt, vt, k, maxerr=e)
        want = approx_counts_ref(peq, wt, vt, k, maxerr=e)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(
                f"kernel != plain at C={C} W={W} m={m} k={k} maxerr={e}: "
                f"max |diff| {err}")
        return peq, wt, vt

    for k in SMALL_KS:
        for e in range(4):
            check(40, 300, 40, k, e, 7)
    log(f"[kernel] {len(SMALL_KS) * 4} small shapes (C=40 W=300 m=40, "
        f"k in {SMALL_KS} x maxerr 0-3): kernel == plain exactly")

    k, e = 16, 2
    peq, wt, vt = check(500, 40000, 101, k, e, 333)
    ms = time_ms(lambda: approx_counts(peq, wt, vt, k, maxerr=e), 20)
    plain_ms = time_ms(lambda: approx_counts_ref(peq, wt, vt, k, maxerr=e), 3)
    log(f"[kernel] main shape C=500 W=40000 m=101 k=16 maxerr=2: "
        f"kernel == plain exactly; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms (CUDA events, mean of 20 / 3 calls after 2 warm-up)")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def mutate(rng, s: str) -> str:
    """Up to two random edits (substitution, insertion or deletion)."""
    s = list(s)
    for _ in range(int(rng.integers(0, 3))):
        op, p = int(rng.integers(0, 3)), int(rng.integers(0, len(s)))
        b = "ACGT"[int(rng.integers(0, 4))]
        if op == 0:
            s[p] = b
        elif op == 1:
            s.insert(p, b)
        else:
            del s[p]
    return "".join(s)


def write_fasta(path: str, n_reads: int, seed: int) -> None:
    """Seeded synthetic reads of 250-1,500 bases, ~0.1% N, with the start
    adapter (up to 2 edits) on 90% of read starts and the end adapter on
    90% of read ends."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(250, 1501, n_reads)
    bases = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, lens.sum())]
    bases[rng.random(len(bases)) < 0.001] = ord("N")
    offs = np.concatenate([[0], np.cumsum(lens)])
    with open(path, "w") as f:
        for i in range(n_reads):
            s = bases[offs[i]:offs[i + 1]].tobytes().decode()
            if rng.random() < 0.9:
                a = mutate(rng, START_ADAPTER)
                s = a + s[len(a):]
            if rng.random() < 0.9:
                a = mutate(rng, END_ADAPTER)
                s = s[:-len(a)] + a
            f.write(f">read{i}\n{s}\n")


def run_cli(argv: list[str]) -> tuple[int, str]:
    """``__main__.main(argv)`` on the card; returns (rc, its stdout)."""
    from approx_counter_tpu_torch.__main__ import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def end_seconds(stdout: str) -> dict:
    """Per-end wall seconds from the CLI log: 'Working on sequence X.' to
    that end's 'Done'."""
    times, cur = {}, None
    for line in stdout.splitlines():
        mt = re.match(r"\[([0-9.e+]+) ms\]\t+(.*)", line)
        if not mt:
            continue
        t, text = float(mt.group(1)), mt.group(2)
        me = re.match(r"Working on sequence (start|end)\.", text)
        if me:
            cur = (me.group(1), t)
        elif text == "Done" and cur:
            times[cur[0]] = (t - cur[1]) / 1e3
    return times


def phase_main_path(fasta: str, out_dir: str) -> int:
    from approx_counter_tpu_torch.kernels.bpm import approx_counts

    launches = 0
    for label in ("cold", "warm"):
        out, exact = f"{out_dir}/{label}_out", f"{out_dir}/{label}_exact"
        approx_counts.launches = 0
        t0 = time.perf_counter()
        rc, stdout = run_cli([fasta, "-o", out, "-e", exact, "--seed", "5"])
        wall = time.perf_counter() - t0
        launches = approx_counts.launches
        if rc != 0:
            raise AssertionError(f"CLI rc {rc}:\n{stdout}")
        if launches < 2:
            raise AssertionError(f"kernel launched {launches} times, want >= 2")
        per_end = end_seconds(stdout)
        log(f"[main path] {label} run: rc 0, kernel launches {launches}, "
            f"start end {per_end['start']:.4f} s, end end "
            f"{per_end['end']:.4f} s, whole CLI {wall:.4f} s")
        for which, adapter in (("start", START_ADAPTER), ("end", END_ADAPTER)):
            for path in (f"{out}_0.{which}", f"{exact}_0.{which}"):
                with open(path) as f:
                    lines = f.read().splitlines()
                if len(lines) != 500:
                    raise AssertionError(f"{path}: {len(lines)} lines")
                top = [ln.split("\t")[0] for ln in lines[:5]]
                if not all(km in adapter for km in top):
                    raise AssertionError(f"{path}: top k-mers {top} are not "
                                         f"all from the planted adapter")
    log("[main path] 4 exports x 500 lines, planted adapter k-mers on top")
    return launches


def phase_parity(fasta: str, out_dir: str) -> None:
    import torch

    from approx_counter_tpu_torch.config.cli import resolve_params
    from approx_counter_tpu_torch.pipeline import run_pipeline

    def argv(tag):
        return [fasta, "-sn", "3000", "-o", f"{out_dir}/{tag}_out",
                "-e", f"{out_dir}/{tag}_exact", "--seed", "5"]

    rc, stdout = run_cli(argv("gpu"))
    if rc != 0:
        raise AssertionError(f"GPU CLI rc {rc}:\n{stdout}")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = run_pipeline(resolve_params(argv("cpu")),
                          device=torch.device("cpu"))
    if rc != 0:
        raise AssertionError(f"CPU run_pipeline rc {rc}")
    for which in ("start", "end"):
        for kind in ("out", "exact"):
            paths = [f"{out_dir}/{d}_{kind}_0.{which}" for d in ("gpu", "cpu")]
            a, b = (open(p, "rb").read() for p in paths)
            if a != b:
                raise AssertionError(f"{paths[0]} != {paths[1]}")
    log("[parity] -sn 3000: GPU and CPU exports byte-equal (4 files)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import approx_counter_tpu_torch  # noqa: F401  (fails outside the repo)

    log(card_line())
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()
    kern = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "reads.fasta")
        t0 = time.perf_counter()
        write_fasta(fasta, 50000, seed=5)
        log(f"[data] 50,000 synthetic reads written in "
            f"{time.perf_counter() - t0:.2f} s")
        launches = phase_main_path(fasta, tmp)
        phase_parity(fasta, tmp)
    print(json.dumps({"kernels": [{
        "name": "nfa_sliced", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
