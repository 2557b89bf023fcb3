"""The port's bench: one JSON line on stdout, every diagnostic on stderr.

    python -m approx_counter_tpu_torch.bench [--device cuda|cpu]

Port of the JAX package's ``bench.py``, with its contract: stdout carries
exactly one JSON line with the keys ``metric``, ``value``, ``unit`` and
``vs_baseline`` (the same ``metric`` and ``unit`` strings), and every
diagnostic goes to stderr with the prefix ``[bench]``.

The metric: window x candidate pairs scored per second by the CLI's count
kernel, the candidate-bit-sliced level NFA (``kernels/bpm.py:
approx_counts`` -> ``csrc/nfa_sliced.cu``), at the default run's shape
padded as the JAX bench pads it (512 candidates x 40,960 windows of 101
bases, k=16, at most 2 edits).  The inputs are the JAX bench's draws, in
its order, from ``np.random.default_rng(12345)`` (``kernel_inputs``): one
window buffer per timed call plus a spare, since 21 buffers of 4.1 MB do
not fit in the card's 50 MB L2.  On a card each trial is timed by CUDA
events around ``iters`` calls, the best of 3 trials, after a first call
(which builds the kernel with nvcc, logged alone) and 20 warm-up calls;
with ``--device cpu`` the plain version runs, timed by the host clock.

Then the JAX bench's full-pass diagnostics, on the port's ``Engine``
(``pipeline.py``): whole passes with the sparse-N and the dense upload,
the raw against the packed upload, the host packers, a pipelined start+end
pair, the pass on windows already on the device (CUDA events) and the
``-mr`` device-pool steady state.  Passes are timed by the host clock
around ``finish()``, which fetches the result: a pass counts on the
engine's own stream, which CUDA events on the caller's stream do not
fence.

``vs_baseline``: the JAX bench's yardstick, ``native/cpu_baseline.cpp``
(Myers in C++ with OpenMP), read in place and built by ``g++`` into the
port's build directory (``kernels/_build.py:host_program``), run at C,
W 4,096, m, k on min(4, cores) threads, best of 2, and scaled linearly to
the reference's 4 threads.  Without ``g++`` it is null and stderr says
why.

Two deliberate differences from the JAX bench: it never falls back to the
CPU (``--device cuda`` without a card exits 1), and a diagnostic that
fails stops the bench with a non-zero exit instead of a log line, since a
run that exits 0 would hide a fault of the device path.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from approx_counter_tpu_torch.core.codec import (
    BASE_N,
    NCAP,
    pack_windows_host,
    sparse_ncols,
)
from approx_counter_tpu_torch.io.fastx import Reads
from approx_counter_tpu_torch.io.native import pack_windows_sparse_native
from approx_counter_tpu_torch.kernels._build import host_program
from approx_counter_tpu_torch.kernels.bpm import (
    approx_counts,
    build_peq,
    word_launches,
)
from approx_counter_tpu_torch.params import Params
from approx_counter_tpu_torch.pipeline import Engine

METRIC = "window-candidate pairs scored/sec/chip (k=16, ed<=2, m=101)"
UNIT = "pairs/s"
MAXERR = 2
REF_THREADS = 4  # the reference's default, approx_counter.cpp:706
# warm-up calls before the kernel's first trial: after 2 calls of 0.7 ms
# the card had not settled
WARMUP = 20
TRIALS = 3
BASELINE_SRC = (Path(__file__).resolve().parent.parent / "native"
                / "cpu_baseline.cpp")
BASELINE_FLAGS = ("-O3", "-march=native", "-fopenmp", "-std=c++14")
# Ns of a dense-path batch: past the sparse format's NCAP = 4,096
DENSE_NS = 5000


def log(msg: str) -> None:
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


def kernel_inputs(rng: np.random.Generator, C: int, W: int, M: int, K: int,
                  nbuf: int):
    """The JAX bench's draws, in its order: (C uint64 codes in [0, 4^K),
    ``nbuf`` distinct uint8 window buffers drawn [W, M] and made text-major
    [M, W], bool [W] all valid)."""
    codes = rng.integers(0, 1 << (2 * K), C, dtype=np.uint64)
    windows_t = [np.ascontiguousarray(
        rng.integers(0, 4, (W, M)).astype(np.uint8).T) for _ in range(nbuf)]
    return codes, windows_t, np.ones(W, bool)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_inputs(codes: np.ndarray, windows_t: list, valid: np.ndarray,
                  K: int, device: torch.device):
    """``kernel_inputs``' arrays as ``approx_counts`` takes them on
    ``device``: (peq, [windows_t tensors], valid tensor)."""
    peq = build_peq(torch.from_numpy(codes.view(np.int64)).to(device), K)
    wts = [torch.from_numpy(w).to(device) for w in windows_t]
    wv = torch.from_numpy(valid).to(device)
    _sync(device)
    return peq, wts, wv


def trial_times(run, iters: int, device: torch.device, warmup: int = 0,
                trials: int = TRIALS) -> list[tuple[float, float]]:
    """One (seconds per call, host seconds per call) pair for each of
    ``trials`` trials of ``iters`` calls ``run(i)``, i < ``iters``, after
    ``warmup`` calls and a synchronize.  The first is by CUDA events on a
    card and by the host clock on the CPU; the second is the host clock
    around the loop that issues the calls, so a trial whose two are close
    was held back by the host, not by the card."""
    for i in range(warmup):
        run(i % iters)
    _sync(device)
    out = []
    for _ in range(trials):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        t = time.perf_counter()
        for i in range(iters):
            run(i)
        issue = (time.perf_counter() - t) / iters
        if device.type == "cuda":
            stop.record()
            stop.synchronize()
            out.append((start.elapsed_time(stop) / 1e3 / iters, issue))
        else:
            out.append((issue, issue))
    return out


def time_calls(run, iters: int, device: torch.device, what: str,
               warmup: int = 0) -> float:
    """Seconds per call of ``run(i)``, i < ``iters``: the best of
    ``TRIALS`` means over ``iters`` calls (``trial_times``).  ``run(iters)``
    (the spare input) comes first and is logged alone, then ``warmup``
    calls."""
    t0 = time.perf_counter()
    run(iters)
    _sync(device)
    log(f"{what}: first call {time.perf_counter() - t0:.4f} s (any kernel "
        f"build included), then {warmup} warm-up calls")
    times = trial_times(run, iters, device, warmup)
    log(f"{what}: ms/call by trial "
        f"{' / '.join(f'{dt * 1e3:.4f}' for dt, _ in times)} (host issue "
        f"{' / '.join(f'{hi * 1e3:.4f}' for _, hi in times)})")
    return min(dt for dt, _ in times)


def host_ms(fn, items: list, device: torch.device,
            warm: bool = False) -> float:
    """Mean host-clock ms of ``fn(item)`` over ``items``, each call ended
    by a synchronize on a card; ``warm`` makes one untimed call first."""
    if warm:
        fn(items[0])
        _sync(device)
    t0 = time.perf_counter()
    for x in items:
        fn(x)
        _sync(device)
    return (time.perf_counter() - t0) / len(items) * 1e3


def bench_kernel(device: torch.device, C: int, W: int, M: int, K: int,
                 iters: int):
    """The headline: pairs per second of ``approx_counts`` on the JAX
    bench's inputs.  Returns (pairs/s, the generator, drawn past them)."""
    rng = np.random.default_rng(12345)
    peq, wts, wv = device_inputs(*kernel_inputs(rng, C, W, M, K, iters + 1),
                                 K, device)
    n0 = approx_counts.launches
    dt = time_calls(lambda i: approx_counts(peq, wts[i], wv, K, MAXERR),
                    iters, device, "kernel", WARMUP)
    per_call = (approx_counts.launches - n0) / (1 + WARMUP + TRIALS * iters)
    log(f"kernel: {dt * 1e3:.4f} ms/call, {C * W / dt / 1e9:.4f} G pairs/s, "
        f"{C * W * M / dt / 1e12:.4f} T cells/s; {per_call:g} launches per "
        f"call (word_launches plans {len(word_launches(-(-C // 32)))}; 0 for "
        f"the plain version)")
    return C * W / dt, rng


def full_pass_diagnostics(rng: np.random.Generator, device: torch.device,
                          W: int, M: int, K: int, n_reads: int) -> None:
    """The JAX bench's full-pass diagnostics on the port's ``Engine``; any
    failure raises."""
    engine = Engine(Params(input_file="bench", sn=W, sl=M - 1, k=K), device)
    try:
        _diagnose(engine, rng, device, W, M, K, n_reads)
    finally:
        engine.close()


def _diagnose(engine: Engine, rng: np.random.Generator, device: torch.device,
              W: int, M: int, K: int, n_reads: int) -> None:
    n_valid = W - 5
    wbufs = [rng.integers(0, 4, (W, M)).astype(np.uint8) for _ in range(16)]

    # whole passes: pack, sparse-N upload, exact stage, approximate counts,
    # re-rank, fetch
    (_, counts), _, stats = engine.start_pass(wbufs[0], n_valid).finish()
    log(f"exact stage on random windows: {stats['n_unique']} unique "
        f"{K}-mers, {stats['n_keep']} kept, exact counts "
        f"{int(counts[0]) if len(counts) else 0} (first) to "
        f"{int(counts[-1]) if len(counts) else 0} (last)")
    ms = host_ms(lambda b: engine.start_pass(b, n_valid).finish(), wbufs[1:4],
                 device)
    log(f"full pass (exact stage + approximate counts + re-rank + fetch, "
        f"sparse-N 2-bit upload): {ms:.4f} ms")

    # the same pass through the dense two-plane upload: DENSE_NS Ns at
    # seeded positions of the valid rows, past what the sparse list holds
    nrng = np.random.default_rng(13)
    dense = []
    for b in wbufs[13:16]:
        d = b.copy()
        at = nrng.choice(n_valid * M, DENSE_NS, replace=False)
        d.reshape(-1)[at] = BASE_N
        if pack_windows_sparse_native(d, n_valid, sparse_ncols(d, n_valid),
                                      NCAP) is not None:
            raise RuntimeError("the dense-path batch would ship sparse-N")
        dense.append(d)
    ms = host_ms(lambda b: engine.start_pass(b, n_valid).finish(), dense[1:],
                 device, warm=True)
    log(f"full pass (dense two-plane upload, {DENSE_NS} Ns a batch): "
        f"{ms:.4f} ms")
    del dense

    # the window transfer alone: raw uint8 against the packed planes
    ms = host_ms(lambda b: torch.from_numpy(b).to(device), wbufs[4:7], device,
                 warm=True)
    log(f"window upload raw uint8 ({wbufs[0].nbytes / 1e6:.4f} MB): "
        f"{ms:.4f} ms")
    planes = [pack_windows_host(b)[0] for b in wbufs[4:7]]
    ms = host_ms(lambda p: engine._upload(p), planes, device, warm=True)
    log(f"window upload packed planes ({planes[0].nbytes / 1e6:.4f} MB, one "
        f"buffer, pinned staging): {ms:.4f} ms")
    del planes
    ms = host_ms(pack_windows_host, wbufs[4:7], device)
    log(f"host pack (dense numpy): {ms:.4f} ms")
    ms = host_ms(lambda b: pack_windows_sparse_native(
        b, n_valid, sparse_ncols(b, n_valid), NCAP), wbufs[4:7], device)
    log(f"host pack (sparse-N, native): {ms:.4f} ms")

    # pipelined start+end pair: the worker thread counts the first pass
    # while this thread packs and ships the second
    t0 = time.perf_counter()
    for i in (7, 9, 11):
        first = engine.start_pass(wbufs[i], n_valid)
        second = engine.start_pass(wbufs[i + 1], n_valid)
        first.finish()
        second.finish()
    log(f"pipelined start+end pair: "
        f"{(time.perf_counter() - t0) / 3 * 1e3:.4f} ms/pair")

    # the pass on windows uploaded beforehand, on this thread: its compute
    # and fetch without the upload
    resident = [engine.device_windows(b, n_valid) for b in wbufs[:7]]
    dt = time_calls(lambda i: engine._count(*resident[i]), 6, device,
                    "device-resident pass")
    log(f"full pass on device-resident windows "
        f"({'CUDA events' if device.type == 'cuda' else 'host clock'}): "
        f"{dt * 1e3:.4f} ms")
    del resident

    # the -mr steady state from the device window pool: an index vector
    # per pass, alternating the ends
    read_len = 2 * M
    pbuf = rng.integers(0, 4, n_reads * read_len).astype(np.uint8)
    poffs = np.arange(n_reads + 1, dtype=np.int64) * read_len
    t0 = time.perf_counter()
    if not engine.build_pool(Reads(buf=pbuf, offsets=poffs), M - 1):
        raise RuntimeError("no read is long enough for the device pool")
    _sync(device)
    build_ms = (time.perf_counter() - t0) * 1e3
    chosen = [rng.permutation(n_reads)[:W] for _ in range(9)]
    engine.start_pass_pool(chosen[8], W, end=False).finish()
    best = None
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        pending = [engine.start_pass_pool(chosen[i], W, end=bool(i % 2))
                   for i in range(8)]
        for p in pending:
            p.finish()
        cur = (time.perf_counter() - t0) / 8
        best = cur if best is None else min(best, cur)
    log(f"device-pool -mr steady state: {best * 1e3:.4f} ms/pass (best of "
        f"{TRIALS} of 8 passes; pool of {n_reads} reads built in "
        f"{build_ms:.4f} ms)")


def cpu_baseline(C: int, sub_w: int, M: int, K: int,
                 threads: int = REF_THREADS) -> float | None:
    """Pairs per second of ``native/cpu_baseline.cpp`` on min(``threads``,
    cores) threads, best of 2, scaled linearly to ``REF_THREADS``; None
    without ``g++``."""
    if shutil.which("g++") is None:
        log("cpu baseline unavailable: g++ not found (vs_baseline null)")
        return None
    exe = host_program(BASELINE_SRC, BASELINE_FLAGS)
    nt = min(threads, os.cpu_count() or 1)
    per_s, info = 0.0, ""
    for _ in range(2):
        r = subprocess.run([str(exe), str(C), str(sub_w), str(M), str(K),
                            str(nt)], check=True, capture_output=True,
                           timeout=600, text=True)
        if float(r.stdout) > per_s:
            per_s, info = float(r.stdout), r.stderr.strip()
    log(f"cpu baseline ({nt} threads, best of 2, C={C} W={sub_w}): "
        f"{per_s / 1e6:.4f} M pairs/s [{info}]")
    if nt < REF_THREADS:
        per_s *= REF_THREADS / nt  # optimistic linear scaling
        log(f"scaled to {REF_THREADS} threads: {per_s / 1e6:.4f} M pairs/s")
    return per_s


def main(argv: list[str] | None = None, *, C: int = 512, W: int = 40960,
         M: int = 101, K: int = 16, iters: int = 20, n_reads: int = 50000,
         sub_w: int = 4096, threads: int = REF_THREADS) -> int:
    """Run the bench; returns the exit code.  The keyword arguments shrink
    it for a test on the CPU."""
    ap = argparse.ArgumentParser(
        prog="python -m approx_counter_tpu_torch.bench",
        description="Time the sliced level-NFA kernel and the full pass; "
                    "print one JSON line.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; exits 1 without a CUDA device) or "
                         "cpu (the plain versions, host clock)")
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("no CUDA device (--device cpu runs the plain versions)")
        return 1
    where = (f"{torch.cuda.get_device_name(device)}, CUDA events"
             if device.type == "cuda" else "cpu (plain versions), host clock")
    log(f"C={C} W={W} m={M} k={K} maxerr={MAXERR}, {iters} calls a trial, "
        f"on {where}")
    n0 = approx_counts.launches
    value, rng = bench_kernel(device, C, W, M, K, iters)
    full_pass_diagnostics(rng, device, W, M, K, n_reads)
    base = cpu_baseline(C, sub_w, M, K, threads)
    vs = value / base if base else None
    log(f"launches: {json.dumps({'nfa_sliced': approx_counts.launches - n0})}")
    print(json.dumps({
        "metric": METRIC,
        "value": round(value, 1),
        "unit": UNIT,
        "vs_baseline": round(vs, 1) if vs else None,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
