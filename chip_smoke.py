#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):
  1. Card: print ``nvidia-smi`` name and power limit, build every CUDA
     kernel the phases use from ``approx_counter_tpu_torch/csrc`` with nvcc
     (one process per library, all at once), print the build seconds and
     the ptxas register and spill report.
  2. The sliced level NFA vs its plain torch version on the card, exact
     integer equality: the default-run shape (C=500, W=40,000, m=101,
     k=16, maxerr=2, with N and pad symbols and invalid tail windows) and
     small shapes at k in {2, 3, 16, 31, 32} x maxerr 0-3.  Both times at
     the main shape, from CUDA events, warm-up excluded.
  3. The three alternate kernels (unpacked Myers, packed Myers, packed
     NFA) at the default-run shape, k=16 (and pack 4 at k=8): each equal to
     its plain version and to the plain Myers scan, with both times.
  4. The default CLI run (sn=40000, sl=100, k=16, top-500, --max-error 2,
     both ends) on a seeded synthetic FASTA of 50,000 reads with planted
     adapters, through ``approx_counter_tpu_torch.__main__.main``: rc 0, the
     kernel launched on the main path, 4 exports of 500 lines with adapter
     k-mers on top.  Per-end wall time from the CLI's own log timestamps.
     Then the same run at -k 32: rc 0, kernel launched, 4 x 500 lines.
  5. The CLI at -sn 3000 on the card and ``run_pipeline`` on the CPU, at
     k=16, 17 and 32: all exports byte-equal.
  6. The check path: ``gpu_check.run()`` on the card, every row OK and
     every kernel launched in it.
Each kernel's bound is the larger of its bytes over the memory rate and its
integer-pipe instructions (the SASS of its text loop, from cuobjdump) over
132 SMs x 64 INT32 lanes x the card's maximum SM clock.
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

CSRC = "approx_counter_tpu_torch/csrc"
TPU_BPM = "approx_counter_tpu/kernels/bpm.py"
# kernel -> (source, Pallas kernel it replaces, candidates per thread per
# pack field: kCands / kWords in the sources, 32 for the bit-sliced words)
KERNELS = {
    "nfa_sliced": (f"{CSRC}/nfa_sliced.cu", f"{TPU_BPM}:718", 32),
    "bpm_myers": (f"{CSRC}/bpm_myers.cu", f"{TPU_BPM}:264", 8),
    "bpm_packed": (f"{CSRC}/bpm_packed.cu", f"{TPU_BPM}:399", 8),
    "nfa_packed": (f"{CSRC}/nfa_packed.cu", f"{TPU_BPM}:505", 8),
}
SMALL_KS = (2, 3, 16, 31, 32)
MAIN = dict(C=500, W=40000, m=101, maxerr=2, n_invalid=333)
# H100 SXM: 132 SMs x 64 INT32 lanes; HBM3 3.35 TB/s (NVIDIA data sheet)
SMS, INT_LANES, HBM_BYTES_PER_S = 132, 64, 3.35e12
# SASS opcodes that issue to the integer ALU pipe (IMAD goes to the FMA
# pipe, uniform-datapath U* ops and loads elsewhere)
INT_PIPE = re.compile(r"(LOP3|LOP|IADD3|IADD|SHF|SEL|ISETP|VIADD|VIMNMX|"
                      r"IMNMX|PRMT|LEA|IABS|BMSK|SGXT|PLOP3)\b")
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


def max_sm_clock_hz() -> float:
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])


def phase_build() -> dict:
    """Builds every library in parallel; returns the builds by key."""
    from approx_counter_tpu_torch.kernels._build import (
        kernel_build,
        nfa_sliced_build,
    )

    jobs = {("nfa_sliced", k, e): (nfa_sliced_build, (k, e))
            for k in SMALL_KS + (17,) for e in range(4)}
    jobs.update({(name,): (kernel_build, (name,)) for name in KERNELS
                 if name != "nfa_sliced"})
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {key: ex.submit(fn, *args) for key, (fn, args) in jobs.items()}
        builds = {key: f.result() for key, f in futs.items()}
    wall = time.perf_counter() - t0
    shown = [("nfa_sliced", 16, 2), ("nfa_sliced", 32, 3), ("bpm_myers",),
             ("bpm_packed",), ("nfa_packed",)]
    log(f"[build] {len(builds)} libraries in {wall:.2f} s wall (one nvcc "
        f"each, all at once): " + ", ".join(
            f"{'/'.join(map(str, key))} {builds[key].seconds:.2f} s"
            for key in shown))
    for key in shown:
        fn = None
        for line in builds[key].log.splitlines():
            mf = re.search(r"Compiling entry function '(\S+)'", line)
            if mf:
                fn = re.search(r"kernel(ILi.*?EE)?", mf.group(1)).group(1) or ""
            elif "registers" in line or "spill" in line:
                log(f"[build] {'/'.join(map(str, key))} {fn}: {line.strip()}")
    return builds


def sass_int_ops_per_step(so, kernel: str, targs: tuple = ()) -> float:
    """Integer-pipe SASS instructions per text step of ``kernel`` (a thread's
    step over all its candidates): the instructions of the kernel's largest
    backward-branch loop that match INT_PIPE, over the loop's text-byte
    loads (steps per iteration)."""
    from approx_counter_tpu_torch.kernels._build import _nvcc

    sym = f"{kernel}_kernel" + (
        "I" + "".join(f"Li{a}E" for a in targs) + "E" if targs else "E")
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_nvcc()), "cuobjdump"), "-sass", str(so)],
        capture_output=True, text=True, check=True).stdout
    funcs = [f for f in re.split(r"\n\s*Function : ", sass)[1:]
             if sym in f.split(None, 1)[0]]
    if len(funcs) != 1:
        raise AssertionError(f"{len(funcs)} functions match {sym} in {so}")
    ins = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", i.strip())) for a, i in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", funcs[0])]
    loops = [(a - int(t, 16), int(t, 16), a) for a, i in ins
             for t in re.findall(r"^BRA\s+(?:`\()?0x([0-9a-f]+)", i)
             if int(t, 16) < a]
    _, lo, hi = max(loops)
    body = [i for a, i in ins if lo <= a <= hi]
    steps = sum("LDG.E.U8" in i for i in body)
    if steps < 1:
        raise AssertionError(f"{sym}: no text load in its largest loop")
    return sum(bool(INT_PIPE.match(i)) for i in body) / steps


def bound(kernel: str, ops_per_step: float, C: int, pack: int,
          clock_hz: float) -> tuple[float, str]:
    """(bound ms, what bounds it) at the main shape for C candidates."""
    m, W = MAIN["m"], MAIN["W"]
    per_thread = KERNELS[kernel][2] * pack
    ops = ops_per_step * m * W * -(-C // per_thread)
    t_ops = ops / (SMS * INT_LANES * clock_hz)
    # inputs once: int64 peq [C, 4], text [m, W], valid [W]; int32 out [C]
    t_bytes = (32 * C + m * W + W + 4 * C) / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


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


def launch_counts() -> dict:
    """Each kernel's launch count, read from its wrapper."""
    from approx_counter_tpu_torch.kernels import bpm

    return {"nfa_sliced": bpm.approx_counts.launches,
            "bpm_myers": bpm.approx_counts_myers.launches,
            "bpm_packed": bpm.approx_counts_packed.launches["myers"],
            "nfa_packed": bpm.approx_counts_packed.launches["nfa"]}


def reset_launch_counts() -> None:
    from approx_counter_tpu_torch.kernels import bpm

    bpm.approx_counts.launches = 0
    bpm.approx_counts_myers.launches = 0
    bpm.approx_counts_packed.launches = {"myers": 0, "nfa": 0}


def main_case(rng, k: int):
    """The default-run shape's inputs on the card: (peq, windows_t, valid)."""
    import torch

    from approx_counter_tpu_torch.kernels.bpm import build_peq

    codes, wins_t, valid = random_case(rng, MAIN["C"], MAIN["W"], MAIN["m"],
                                       k, MAIN["n_invalid"])
    dev = torch.device("cuda")
    return (build_peq(torch.from_numpy(codes).to(dev), k),
            torch.from_numpy(wins_t).to(dev), torch.from_numpy(valid).to(dev))


def exact_diff(got, want, what: str) -> int:
    """max |got - want| after a synchronize; raises unless it is 0."""
    import torch

    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err or not torch.equal(got, want):
        raise AssertionError(f"{what}: max |diff| {err}")
    return err


def phase_kernel(builds: dict, clock_hz: float) -> dict:
    import torch

    from approx_counter_tpu_torch.kernels.bpm import (
        approx_counts,
        approx_counts_ref,
        build_peq,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(20)
    max_err = 0
    for k in SMALL_KS:
        for e in range(4):
            codes, wins_t, valid = random_case(rng, 40, 300, 40, k, 7)
            args = (build_peq(torch.from_numpy(codes).to(dev), k),
                    torch.from_numpy(wins_t).to(dev),
                    torch.from_numpy(valid).to(dev), k, e)
            max_err = max(max_err, exact_diff(
                approx_counts(*args), approx_counts_ref(*args),
                f"nfa_sliced != plain at C=40 W=300 m=40 k={k} maxerr={e}"))
    log(f"[kernel] {len(SMALL_KS) * 4} small shapes (C=40 W=300 m=40, "
        f"k in {SMALL_KS} x maxerr 0-3): kernel == plain exactly")

    k, e = 16, MAIN["maxerr"]
    args = (*main_case(rng, k), k, e)
    max_err = max(max_err, exact_diff(approx_counts(*args),
                                      approx_counts_ref(*args),
                                      "nfa_sliced != plain at the main shape"))
    ms = time_ms(lambda: approx_counts(*args), 20)
    plain_ms = time_ms(lambda: approx_counts_ref(*args), 3)
    ops = sass_int_ops_per_step(builds[("nfa_sliced", k, e)].so,
                                "nfa_sliced", (k, e))
    bound_ms, bound_by = bound("nfa_sliced", ops, MAIN["C"], 1, clock_hz)
    log(f"[kernel] main shape C=500 W=40000 m=101 k=16 maxerr=2: "
        f"kernel == plain exactly; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms (CUDA events, mean of 20 / 3 calls after 2 warm-up); bound "
        f"{bound_ms:.4f} ms ({ops:g} integer-pipe SASS ops per step and "
        f"32-candidate word)")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# (kernel, k, pack) at the main shape; the first of each kernel is the one
# its "kernels" entry reports
ALTERNATES = [("bpm_myers", 16, 1), ("bpm_packed", 16, 2),
              ("bpm_packed", 8, 4), ("nfa_packed", 16, 2),
              ("nfa_packed", 16, 1), ("nfa_packed", 8, 4)]


def phase_alternates(builds: dict, clock_hz: float) -> dict:
    """The three alternate kernels at the default-run shape: each equal to
    its plain version and to the plain Myers scan; both times and the
    bound.  Returns each kernel's entry for its first configuration."""
    from approx_counter_tpu_torch.kernels.bpm import (
        approx_counts_myers,
        approx_counts_packed,
        approx_counts_packed_ref,
        approx_counts_ref,
    )

    rng = np.random.default_rng(21)
    e = MAIN["maxerr"]
    entries = {}
    for kernel, k, pack in ALTERNATES:
        args = (*main_case(rng, k), k, e)
        if kernel == "bpm_myers":
            def fn():
                return approx_counts_myers(*args)

            plain = approx_counts_ref
            targs = ()
        else:
            algo = "myers" if kernel == "bpm_packed" else "nfa"

            def fn():
                return approx_counts_packed(*args, pack, algo)

            def plain(*a):
                return approx_counts_packed_ref(*a, pack, algo)

            targs = (pack,) if kernel == "bpm_packed" else (pack, e)
        what = f"{kernel} k={k} pack={pack}"
        got = fn()
        err = max(exact_diff(got, plain(*args), f"{what} != its plain version"),
                  exact_diff(got, approx_counts_ref(*args),
                             f"{what} != approx_counts_ref"))
        ms = time_ms(fn, 20)
        plain_ms = time_ms(lambda: plain(*args), 3)
        ops = sass_int_ops_per_step(builds[(kernel,)].so, kernel, targs)
        bound_ms, bound_by = bound(kernel, ops, MAIN["C"], pack, clock_hz)
        log(f"[alternates] {what} maxerr={e} at C=500 W=40000 m=101: == plain "
            f"and == approx_counts_ref exactly; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({ops:g} "
            f"integer-pipe SASS ops per step and thread)")
        entries.setdefault(kernel, dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by=bound_by))
    return entries


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


def phase_main_path(fasta: str, out_dir: str, k: int) -> int:
    """The default CLI run at ``k``, cold then warm; returns the kernel
    launches of the warm run.  At k <= 27 the planted adapters' k-mers
    must top every export."""
    launches = 0
    for label in ("cold", "warm"):
        out, exact = f"{out_dir}/k{k}_{label}_out", f"{out_dir}/k{k}_{label}_exact"
        reset_launch_counts()
        t0 = time.perf_counter()
        rc, stdout = run_cli([fasta, "-k", str(k), "-o", out, "-e", exact,
                              "--seed", "5"])
        wall = time.perf_counter() - t0
        counts = launch_counts()
        launches = counts["nfa_sliced"]
        if rc != 0:
            raise AssertionError(f"CLI -k {k} rc {rc}:\n{stdout}")
        if launches < 2:
            raise AssertionError(f"kernel launched {launches} times, want >= 2")
        per_end = end_seconds(stdout)
        log(f"[main path] -k {k} {label} run: rc 0, launches {counts}, "
            f"start end {per_end['start']:.4f} s, end end "
            f"{per_end['end']:.4f} s, whole CLI {wall:.4f} s")
        for which, adapter in (("start", START_ADAPTER), ("end", END_ADAPTER)):
            for path in (f"{out}_0.{which}", f"{exact}_0.{which}"):
                with open(path) as f:
                    lines = f.read().splitlines()
                if len(lines) != 500:
                    raise AssertionError(f"{path}: {len(lines)} lines")
                top = [ln.split("\t")[0] for ln in lines[:5]]
                if k <= len(END_ADAPTER) and not all(km in adapter for km in top):
                    raise AssertionError(f"{path}: top k-mers {top} are not "
                                         f"all from the planted adapter")
    log(f"[main path] -k {k}: 4 exports x 500 lines"
        + (", planted adapter k-mers on top" if k <= len(END_ADAPTER) else ""))
    return launches


def phase_parity(fasta: str, out_dir: str, k: int) -> None:
    import torch

    from approx_counter_tpu_torch.config.cli import resolve_params
    from approx_counter_tpu_torch.pipeline import run_pipeline

    def argv(tag):
        return [fasta, "-k", str(k), "-sn", "3000",
                "-o", f"{out_dir}/p{k}{tag}_out",
                "-e", f"{out_dir}/p{k}{tag}_exact", "--seed", "5"]

    rc, stdout = run_cli(argv("gpu"))
    if rc != 0:
        raise AssertionError(f"GPU CLI -k {k} rc {rc}:\n{stdout}")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = run_pipeline(resolve_params(argv("cpu")),
                          device=torch.device("cpu"))
    if rc != 0:
        raise AssertionError(f"CPU run_pipeline -k {k} rc {rc}")
    for which in ("start", "end"):
        for kind in ("out", "exact"):
            paths = [f"{out_dir}/p{k}{d}_{kind}_0.{which}" for d in ("gpu", "cpu")]
            a, b = (open(p, "rb").read() for p in paths)
            if a != b:
                raise AssertionError(f"{paths[0]} != {paths[1]}")
    log(f"[parity] -k {k} -sn 3000: GPU and CPU exports byte-equal (4 files)")


def phase_gpu_check() -> dict:
    """The check path: ``gpu_check.run()`` on the card with every count set
    to 0 first; returns the launches it made."""
    import torch

    from approx_counter_tpu_torch import gpu_check

    reset_launch_counts()
    t0 = time.perf_counter()
    rows = gpu_check.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    failed = [name for name, ok in rows if not ok]
    if failed:
        raise AssertionError(f"gpu_check failed rows: {failed}")
    idle = [name for name, n in counts.items() if n < 1]
    if idle:
        raise AssertionError(f"gpu_check launched no {idle}")
    log(f"[gpu_check] {len(rows)} rows OK in {wall:.2f} s; launches {counts}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import approx_counter_tpu_torch  # noqa: F401  (fails outside the repo)

    log(card_line())
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    clock_hz = max_sm_clock_hz()
    log(f"[env] max SM clock {clock_hz / 1e6:g} MHz")
    builds = phase_build()
    entries = {"nfa_sliced": phase_kernel(builds, clock_hz)}
    entries.update(phase_alternates(builds, clock_hz))
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "reads.fasta")
        t0 = time.perf_counter()
        write_fasta(fasta, 50000, seed=5)
        log(f"[data] 50,000 synthetic reads written in "
            f"{time.perf_counter() - t0:.2f} s")
        launches = {"nfa_sliced": phase_main_path(fasta, tmp, 16)}
        phase_main_path(fasta, tmp, 32)
        for k in (16, 17, 32):
            phase_parity(fasta, tmp, k)
    checks = phase_gpu_check()
    for name in ("bpm_myers", "bpm_packed", "nfa_packed"):
        launches[name] = checks[name]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         **entries[name], "library_ms": None}
        for name in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
