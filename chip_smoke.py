#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):
  1. Card: print ``nvidia-smi`` name and power limit, build every CUDA
     kernel the phases use from ``approx_counter_tpu_torch/csrc`` with nvcc
     (one process per library, all at once), print the build seconds and
     each kernel instance's ptxas registers and spills.
  2. The sliced level NFA vs its plain torch version and the plain
     bit-sliced NFA core (``approx_counts_nfa_sliced_ref``) on the card,
     exact integer equality: the default-run shape (C=500, W=40,000,
     m=101, k=16, maxerr=2, with N and pad symbols and invalid tail
     windows) and small shapes at k in {2, 3, 16, 31, 32} x maxerr 0-3.
     Both times at the main shape, from CUDA events, warm-up excluded
     (20 calls for the kernel, 2 for the plain version); the kernel's is
     the mean of the first of 3 trials of 20 calls (``bench.trial_times``,
     as in phase 3), the least and each trial's host issue time logged.
  3. The three alternate kernels (unpacked Myers, packed Myers, packed
     NFA) at the default-run shape, k=16 (and pack 4 at k=8; the packed
     NFA also at pack 1): each equal to its plain version, to the plain
     Myers scan and to the plain bit-sliced core it runs
     (``approx_counts_myers_sliced_ref`` or ``approx_counts_nfa_sliced_ref``),
     with both times; the packed NFA's text-loop SASS beside the sliced
     NFA's at the same k and maxerr (equal up to its prologue); each time,
     the sliced NFA's too, over its own bound and over the function bound
     at its k (the least own bound of the four count kernels there).
 3b. The search-scheme oracle: every approximate-count kernel (the sliced
     NFA, unpacked Myers, packed Myers at pack 2 and 4 and the packed NFA
     at pack 1-16, wherever k <= 32 / pack) and every plain version equal
     to ``search_scheme_error_count``, integer equality, at k in {2, 3, 8,
     16, 32} x maxerr 0-3 on 8 candidates x 32 windows of 40 and at the
     default run's widths (k=16, m=101, maxerr 2, C=40, W=260), on
     windows with occurrences at the edges, one edit away, valid prefixes
     shorter than k, all N, symbols 0-5 and invalid windows; each kernel
     launched; both plain bit-sliced cores equal to it too.  Then
     ``approx_count_rank`` (a fifth of the slots padding) on the card equal
     to its CPU result.
  4. The default CLI run (sn=40000, sl=100, k=16, top-500, --max-error 2,
     both ends) on a seeded synthetic FASTA of 50,000 reads with planted
     adapters, through ``approx_counter_tpu_torch.__main__.main``: rc 0, the
     kernel launched on the main path, 4 exports of 500 lines with adapter
     k-mers on top.  Per-end wall time from the CLI's own log timestamps.
     Then the same run at -k 32: rc 0, kernel launched, 4 x 500 lines.
  5. The CLI at -sn 3000 on the card and ``run_pipeline`` on the CPU, at
     k=16, 17 and 32, and at k=16 with -sk 2, with --from-exact (phase 4's
     warm k=16 exact .start) and with --stream: all exports byte-equal.
  6. The check path: ``gpu_check.run()`` on the card, every row OK (the
     multihost step's among them) and every approximate-count kernel
     launched in it.
  7. The bitonic-stage probe's stage network (``csrc/sort_stage.cu``) vs
     its plain version, exact equality: at the probe's shape (int32
     [32768, 128], 210 stages, with and without a tile transpose every 20
     stages) and at small shapes (rows 16, 144, 128, 384 x stages 0, 1, 19,
     21, 210 x transpose every 0, 1, 20; negatives, ties and the int32
     extremes in the input).  Both times at the probe's shape; the kernel
     may not beat its bound.  The SASS of the stage loop: 16 integer
     min/max per trip, one stage a trip.  Then the probe's entry point,
     ``native.sort_stage_probe5.main()``: rc 0, the kernel launched, its
     lines printed.
  8. The candidate limit: the sliced NFA at C=2,100,000 (65,625 words, two
     launches), W=2,048, m=101, k=16, maxerr 2, equal to its plain version
     on ~4,000 rows (1,024 at random, the 1,000 on each side of candidate
     2,097,120 and the last 1,000), and its first 2,097,120 counts equal to
     one launch over those candidates alone; its time and bound.  The same
     at C=2,100,000, W=512 for unpacked Myers, packed Myers at pack 2 and
     the packed NFA at pack 1 (past 65,535 groups of 32 candidates: two
     launches each, also equal to the plain bit-sliced core each runs).
  9. Solid mode at full size: the default run at -sk 20 and at -sk 1.  The
     exact export holds n_keep lines, every count >= N, in CompareCount
     order; the approximate one min(n_keep, 500), adapters on top; the
     launches are those the launch plan gives for each end's n_keep.  The
     kernel's time and bound at the -sk 20 start end's C and at the -sk 1
     one's.
 10. Resume: --from-exact on phase 4's warm k=16 exact .start, same seed:
     no exact export, .start byte-equal to phase 4's, .end 500 lines.
 11. Stream: --stream -sn 60000 equals the in-memory run at -sn 60000 (every
     read eligible); then, in a child process, --stream at the default sn on
     a 500,000-read, ~440 MB FASTA (the 50,000 reads ten times over): rc 0,
     4 x 500 lines, adapters on top, the peak RSS growth of the run against
     an in-memory run's (VmRSS sampled each ms), and the stream's MB/s (from
     the CLI's log) in one more streamed run without the sampler.  Native
     vs Python ``read_fastx`` MB/s on the 44 MB FASTA, equal ``Reads``.
 12. Profile: the default run with --profile: exports byte-equal to phase
     4's warm run, the trace holds the sliced kernel; device-busy ms and
     each end's busy share of its wall, from the trace, and how many ms of
     the start pass's device time overlap the end pass's sampling and
     upload (the ``prefetch`` range).
 13. Multihost: the FASTA dealt round-robin into two shard files, then at
     the default parameters (a) --multihost through the CLI at one rank,
     cold and warm, exports byte-equal to ``run_pipeline_multihost`` on
     the CPU; (b) two ranks sharing the card under torchrun (gloo), cold,
     warm and under --profile in one process per rank, each rank's exact
     stage sharded by owner rank on the card, exports byte-equal across
     the three and to the same two ranks on the CPU; per-end walls from
     rank 0's log, each rank's per-end split from its trace (the four
     exact-stage ranges, the time before and after them, the collectives,
     the kernel, the device-busy time), the bytes each rank sends per end,
     the owner balance and the collectives' transport.  (c) At -sn 60000
     (every read eligible) one rank, two ranks (``torchrun -m
     approx_counter_tpu_torch --profile``: one trace per rank, two
     nfa_sliced kernels in each) and --stream on the unsplit file export
     the same bytes.
 14. Dispatch: -mr 3 -v 2 at the defaults with --device-pool on, off and
     auto (the pool used by on and auto), exports byte-equal across the
     three, ``(pipelined)`` on every pass but the first, per-pass walls;
     -sn 3000 -mr 2 with the pool on against ``run_pipeline`` on the CPU;
     one end batch's upload (native gather against a strided view; the
     sparse-N, a forced dense and the raw uint8 upload, each byte-equal,
     with their ms).
 15. Bench (run after phase 3): ``python -m approx_counter_tpu_torch.bench``
     in a child process, after the sliced kernel on the bench's first
     window buffer (C 512, W 40,960: a full last candidate word and a full
     last 256-window block) equals both plain versions exactly: rc 0, one
     JSON line on stdout with the keys metric, value, unit and
     vs_baseline, a non-null vs_baseline, and a value within 0.8-1.25x of
     phase 2's kernel rate (C x W over its least trial's ms, timed as the
     bench times, scaled from W 40,000 to the bench's 40,960); its JSON
     line and its ``[bench]`` lines are printed again here.
Each approximate-count kernel's bound is the larger of its bytes over the
memory rate and the time of the busiest limit of its text loop's SASS
(from cuobjdump), over 132 SMs at the card's maximum SM clock: the integer
ALU pipe's instructions over 64 lanes per SM, the FMA-heavy pipe's over
64, every instruction over the 128 that issue per SM and clock; a thread
carries 32 candidates in every one of them.  The four compute one function, so
the least of their bounds at a k is the function's bound there.  The
stage network's counts one min or max per element and stage on the ALU
pipe.  A kernel that beats its bound fails its phase (a count kernel at
its main shape in its fastest trial): the model is wrong or work was
elided.
The last two lines of stdout are one JSON object on the kernels and one
``{"ok": true, "device": ...}`` object; the line before them repeats the
card's name and power limit.  A kernel's ``launches`` there sum
its paths' counts (each path counted from 0); the ``[launches]`` line
before them gives them path by path.  A count kernel's ``ms`` is its first
trial's mean and ``best_ms`` the least of its three.

With ``--ranks N`` the script runs only phase 13's check of N ranks under
torchrun against the same N ranks on the CPU, rank r on card r (NCCL for
CUDA tensors when every rank has a card), on N shards of the FASTA.

With ``--split N`` it runs only phase 13 (b)'s measurement at N ranks on
min(N, cards) cards over N shards, without the CPU ranks, and one more
run at -sk 1 for its walls and peak device memory.  It reads the
package of the checkout it sits in, one from before the sharded exact
stage too: copy it into two checkouts and run them in turns (a b b a).

With ``--walls R`` it runs only the dispatch path's walls: R rounds of the
default run and of -mr 3 -v 2 with --device-pool off and auto, each run's
exports byte-equal to the first round's, and prints a ``[walls]`` JSON line
of each run's per-pass walls (ms) and whole-CLI wall (s).  Run it in two
checkouts in turns (a b b a) to compare two versions of the path.

Imports nothing of JAX.  Exits 1 when no CUDA device is present.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
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
# kernel -> (source, Pallas kernel it replaces)
KERNELS = {
    "nfa_sliced": (f"{CSRC}/nfa_sliced.cu", f"{TPU_BPM}:718"),
    "bpm_myers": (f"{CSRC}/bpm_myers.cu", f"{TPU_BPM}:264"),
    "bpm_packed": (f"{CSRC}/bpm_packed.cu", f"{TPU_BPM}:399"),
    "nfa_packed": (f"{CSRC}/nfa_packed.cu", f"{TPU_BPM}:505"),
    "sort_stage": (f"{CSRC}/sort_stage.cu", "native/sort_stage_probe5.py:48"),
}
SMALL_KS = (2, 3, 16, 31, 32)
MAIN = dict(C=500, W=40000, m=101, maxerr=2, n_invalid=333)
# H100 SXM: 132 SMs; HBM3 3.35 TB/s (NVIDIA data sheet)
SMS, HBM_BYTES_PER_S = 132, 3.35e12
# Thread-instructions per SM and clock of each limit: each of the four
# sub-partitions issues one warp instruction a clock and has 16 lanes of
# the integer ALU pipe and 16 of the FMA-heavy pipe
LANES = {"alu": 64, "fma": 64, "issue": 128}
# SASS opcodes by pipe.  ALU: logic, shifts, compares, selects, integer
# adds and min/max.  FMA-heavy: IMAD and IMUL (also as the compiler's
# IMAD.MOV, IMAD.SHL, IMAD.IADD) and VIADD, which the card's times rule
# out for the ALU: the packed NFA at pack 1 ran under a bound that counted
# its VIADDs there.  Every instruction, these and the rest (loads,
# branches, uniform-datapath ops), takes an issue slot.
ALU_PIPE = re.compile(r"(LOP3|LOP|IADD3|IADD|SHF|SEL|ISETP|VIMNMX|IMNMX|"
                      r"PRMT|LEA|IABS|BMSK|SGXT|PLOP3)\b")
FMA_PIPE = re.compile(r"(IMAD|IMUL|VIADD)\b")
MINMAX = re.compile(r"V?IMNMX\b")
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
    from approx_counter_tpu_torch.gpu_check import KS as CHECK_KS
    from approx_counter_tpu_torch.kernels._build import (
        host_build,
        kernel_build,
        myers_build,
        nfa_packed_build,
        nfa_sliced_build,
    )

    # every k at which a phase runs the alternate kernels (packed Myers only
    # up to 16): one library each, per maxerr for the packed NFA
    alt_ks = sorted({*SS_KS, *CHECK_KS, *(k for _, k, _ in ALTERNATES)})
    jobs = {("nfa_sliced", k, e): (nfa_sliced_build, (k, e))
            for k in SMALL_KS + SS_KS + (17,) for e in range(4)}
    jobs.update({("nfa_packed", k, e): (nfa_packed_build, (k, e))
                 for k in alt_ks for e in range(4)})
    jobs.update({("bpm_myers", k): (myers_build, ("bpm_myers", k))
                 for k in alt_ks})
    jobs.update({("bpm_packed", k): (myers_build, ("bpm_packed", k))
                 for k in alt_ks if k <= 16})
    jobs[("sort_stage",)] = (kernel_build, ("sort_stage",))
    jobs[("fastx_parser",)] = (host_build, ("fastx_parser",))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {key: ex.submit(fn, *args) for key, (fn, args) in jobs.items()}
        builds = {key: f.result() for key, f in futs.items()}
    wall = time.perf_counter() - t0
    shown = [("nfa_sliced", 16, 2), ("nfa_sliced", 32, 3),
             ("nfa_packed", 16, 2), ("nfa_packed", 32, 3), ("bpm_myers", 16),
             ("bpm_myers", 32), ("bpm_packed", 16), ("bpm_packed", 8),
             ("sort_stage",), ("fastx_parser",)]
    log(f"[build] {len(builds)} libraries in {wall:.2f} s wall (one nvcc "
        f"each, all at once): " + ", ".join(
            f"{'/'.join(map(str, key))} {builds[key].seconds:.2f} s"
            for key in shown))
    # ptxas: each kernel instance's registers and spill bytes
    for key, build in builds.items():
        if key[0] != "fastx_parser":
            log(f"[ptxas] {'/'.join(map(str, key))}: " + "; ".join(
                f"{fn} {regs} registers, spill {st}/{ld} B"
                for fn, regs, st, ld in ptxas_report(build.log)))
    return builds


def ptxas_report(log_text: str) -> list[tuple[str, int, int, int]]:
    """(template arguments, registers, spill store and load bytes) of each
    kernel in a ``-Xptxas -v`` log."""
    rows, fn, spill = [], "", (0, 0)
    for line in log_text.splitlines():
        mf = re.search(r"Compiling entry function '(\S+)'", line)
        ms = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       line)
        mr = re.search(r"Used (\d+) registers", line)
        if mf:
            fn = re.search(r"kernel(IL[bi].*?EE)?", mf.group(1)).group(1) or ""
        elif ms:
            spill = int(ms.group(1)), int(ms.group(2))
        elif mr:
            rows.append((fn, int(mr.group(1)), *spill))
    return rows


def sass_function(so, sym: str) -> list[tuple[int, str]]:
    """(address, instruction) of the one function of library ``so`` whose
    mangled name holds ``sym``, from cuobjdump, predicates stripped."""
    from approx_counter_tpu_torch.kernels._build import _nvcc

    sass = subprocess.run(
        [os.path.join(os.path.dirname(_nvcc()), "cuobjdump"), "-sass", str(so)],
        capture_output=True, text=True, check=True).stdout
    funcs = [f for f in re.split(r"\n\s*Function : ", sass)[1:]
             if sym in f.split(None, 1)[0]]
    if len(funcs) != 1:
        raise AssertionError(f"{len(funcs)} functions match {sym} in {so}")
    return [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", i.strip())) for a, i in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", funcs[0])]


def loop_spans(ins: list[tuple[int, str]]) -> list[tuple[int, int]]:
    """(first, last address) of each backward-branch loop, largest first."""
    loops = sorted(((a - int(t, 16), int(t, 16), a) for a, i in ins
                    for t in re.findall(r"^BRA\s+(?:`\()?0x([0-9a-f]+)", i)
                    if int(t, 16) < a), reverse=True)
    return [(lo, hi) for _, lo, hi in loops]


def sass_loops(so, sym: str) -> list[list[str]]:
    """The backward-branch loops of ``sym`` in ``so``: each loop's
    instructions, the largest loop first."""
    ins = sass_function(so, sym)
    return [[i for a, i in ins if lo <= a <= hi] for lo, hi in loop_spans(ins)]


def kernel_sym(kernel: str, targs: tuple) -> str:
    return f"{kernel}_kernel" + (
        "I" + "".join(f"Li{a}E" for a in targs) + "E" if targs else "E")


def sass_ops_per_step(so, kernel: str, targs: tuple = ()) -> dict:
    """SASS instructions per text step of ``kernel`` (a thread's step over
    all its candidates) for each limit of ``LANES``: those of the kernel's
    largest backward-branch loop that match ALU_PIPE, FMA_PIPE and all of
    them, over the loop's text-byte loads (steps per iteration)."""
    sym = kernel_sym(kernel, targs)
    body = sass_loops(so, sym)[0]
    steps = sum("LDG.E.U8" in i for i in body)
    if steps < 1:
        raise AssertionError(f"{sym}: no text load in its largest loop")
    return {"alu": sum(bool(ALU_PIPE.match(i)) for i in body) / steps,
            "fma": sum(bool(FMA_PIPE.match(i)) for i in body) / steps,
            "issue": len(body) / steps}


def sass_prologue_alu(so, kernel: str, targs: tuple) -> int:
    """ALU-pipe instructions of ``kernel`` before its text loop (its
    largest backward-branch loop): the plane prologue and the state's
    set-up."""
    ins = sass_function(so, kernel_sym(kernel, targs))
    first = loop_spans(ins)[0][0]
    return sum(bool(ALU_PIPE.match(i)) for a, i in ins if a < first)


def ops_text(ops: dict) -> str:
    return ", ".join(f"{n:g} {pipe}" for pipe, n in ops.items())


def sass_minmax_per_stage_trip(so) -> dict:
    """Integer min/max instructions in the innermost loop that holds any, for
    both instances of the stage-network kernel (transpose off, on).  Each
    must be 16: one stage a trip, so the loop runs its runtime trip count
    of stages and no stage was folded into another."""
    counts = {}
    for transpose in (0, 1):
        sym = f"sort_stage_kernelILb{transpose}EE"
        per_loop = [sum(bool(MINMAX.match(i)) for i in body)
                    for body in sass_loops(so, sym)]
        # loops come largest first: the last one with min/max is innermost
        inner = [n for n in per_loop if n] or [0]
        counts[f"transpose={transpose}"] = inner[-1]
        if inner[-1] != 16:
            raise AssertionError(f"{sym}: {inner[-1]} integer min/max in its "
                                 f"stage loop, want 16 (one stage a trip)")
    return counts


def roofline(ops: dict, nbytes: float, clock_hz: float) -> tuple[float, str]:
    """(bound ms, what bounds it): the busiest limit's instructions
    (``ops`` by limit of ``LANES``) over its lanes at ``clock_hz``, against
    ``nbytes`` over the memory rate."""
    t_ops = max(n / (SMS * LANES[pipe] * clock_hz) for pipe, n in ops.items())
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def bound(ops_per_step: dict, C: int, clock_hz: float, m: int = MAIN["m"],
          W: int = MAIN["W"]) -> tuple[float, str]:
    """(bound ms, what bounds it) of a count kernel, whose thread carries
    one 32-candidate word, for C candidates and W windows of m symbols
    (the main shape by default)."""
    steps = m * W * -(-C // 32)
    # inputs once: int64 peq [C, 4], text [m, W], valid [W]; int32 out [C]
    return roofline({pipe: n * steps for pipe, n in ops_per_step.items()},
                    32 * C + m * W + W + 4 * C, clock_hz)


def not_under(what: str, ms: float, bound_ms: float) -> None:
    """Raises when a kernel's time beats its bound."""
    if ms < bound_ms:
        raise AssertionError(f"{what}: {ms:.4f} ms is under its bound "
                             f"{bound_ms:.4f} ms: the bound model is wrong "
                             f"or work was elided")


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


# warm-up calls before a count kernel's main-shape timing (phases 2 and 3):
# two calls of 0.7 ms do not settle the card for the run's first timing
KERNEL_WARMUP = 20
# trials of 20 calls at a count kernel's main shape (phases 2 and 3): the
# first trial's mean is the kernel's ms, the least is held to the bench's
# (its least of 3), and each trial's host issue time says whether the host
# held the card back
KERNEL_TRIALS = 3


def trials_ms(fn, reps: int, warmup: int = 2,
              trials: int = 1) -> list[tuple[float, float]]:
    """(ms per call by CUDA events, host ms per call to issue them) of each
    of ``trials`` trials of ``reps`` calls after ``warmup`` calls: the
    bench's own timing, ``bench.trial_times``."""
    import torch

    from approx_counter_tpu_torch.bench import trial_times

    return [(dt * 1e3, issue * 1e3) for dt, issue in trial_times(
        lambda i: fn(), reps, torch.device("cuda"), warmup, trials)]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """ms per call: the mean over ``reps`` calls after ``warmup`` calls
    (one trial of ``trials_ms``)."""
    return trials_ms(fn, reps, warmup)[0][0]


def kernel_ms(fn) -> tuple[float, float, str]:
    """A count kernel at its main shape: (the first trial's mean, the least
    mean, the trials as text) over ``KERNEL_TRIALS`` trials of 20 calls
    after ``KERNEL_WARMUP`` calls."""
    times = trials_ms(fn, 20, KERNEL_WARMUP, KERNEL_TRIALS)
    text = (f"trials {' / '.join(f'{t:.4f}' for t, _ in times)} ms, host "
            f"issue {' / '.join(f'{i:.4f}' for _, i in times)} ms a call")
    return times[0][0], min(t for t, _ in times), text


def launch_counts() -> dict:
    """Each kernel's launch count, read from its wrapper."""
    from approx_counter_tpu_torch.kernels import bpm, sort_stage

    return {"nfa_sliced": bpm.approx_counts.launches,
            "bpm_myers": bpm.approx_counts_myers.launches,
            "bpm_packed": bpm.approx_counts_packed.launches["myers"],
            "nfa_packed": bpm.approx_counts_packed.launches["nfa"],
            "sort_stage": sort_stage.stage_network.launches}


def reset_launch_counts() -> None:
    from approx_counter_tpu_torch.kernels import bpm, sort_stage

    bpm.approx_counts.launches = 0
    bpm.approx_counts_myers.launches = 0
    bpm.approx_counts_packed.launches = {"myers": 0, "nfa": 0}
    sort_stage.stage_network.launches = 0


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
        approx_counts_nfa_sliced_ref,
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
            got = approx_counts(*args)
            for plain in (approx_counts_ref, approx_counts_nfa_sliced_ref):
                max_err = max(max_err, exact_diff(
                    got, plain(*args), f"nfa_sliced != {plain.__name__} at "
                    f"C=40 W=300 m=40 k={k} maxerr={e}"))
    log(f"[kernel] {len(SMALL_KS) * 4} small shapes (C=40 W=300 m=40, "
        f"k in {SMALL_KS} x maxerr 0-3): kernel == plain == "
        f"approx_counts_nfa_sliced_ref exactly")

    k, e = 16, MAIN["maxerr"]
    args = (*main_case(rng, k), k, e)
    got = approx_counts(*args)
    for plain in (approx_counts_ref, approx_counts_nfa_sliced_ref):
        max_err = max(max_err, exact_diff(
            got, plain(*args), f"nfa_sliced != {plain.__name__} at the main "
            f"shape"))
    ms, best_ms, trials = kernel_ms(lambda: approx_counts(*args))
    plain_ms = time_ms(lambda: approx_counts_ref(*args), 3)
    ops = sass_ops_per_step(builds[("nfa_sliced", k, e)].so, "nfa_sliced",
                            (k, e))
    bound_ms, bound_by = bound(ops, MAIN["C"], clock_hz)
    log(f"[kernel] main shape C=500 W=40000 m=101 k=16 maxerr=2: "
        f"kernel == plain == approx_counts_nfa_sliced_ref exactly; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, mean of 20 / 3 "
        f"calls after {KERNEL_WARMUP} / 2 warm-up; kernel {trials}, least "
        f"{best_ms:.4f} ms); bound "
        f"{bound_ms:.4f} ms ({bound_by}; SASS ops per step and 32-candidate "
        f"word: {ops_text(ops)})")
    not_under("nfa_sliced at the main shape", best_ms, bound_ms)
    return dict(max_abs_err=max_err, ms=ms, best_ms=best_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


# the bench's kernel shape (bench.py:29) and its JSON line's keys
BENCH_C, BENCH_W = 512, 40960
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


def phase_bench(sliced: dict) -> int:
    """Phase 15: first the sliced kernel on the bench's first window buffer
    (its seeded draws, a full last word of candidates and a full last
    256-window block) against both plain versions, exactly; then the port's
    bench in a child process.  ``sliced`` is phase 2's entry; its
    ``max_abs_err`` takes the comparison's.  Returns the bench's
    sliced-kernel launches (its own count, from 0 in the child)."""
    import torch

    from approx_counter_tpu_torch import bench
    from approx_counter_tpu_torch.kernels.bpm import (
        approx_counts,
        approx_counts_nfa_sliced_ref,
        approx_counts_ref,
    )

    k, e = 16, bench.MAXERR
    peq, (wts,), wv = bench.device_inputs(*bench.kernel_inputs(
        np.random.default_rng(12345), BENCH_C, BENCH_W, MAIN["m"], k, 1), k,
        torch.device("cuda"))
    args = (peq, wts, wv, k, e)
    got = approx_counts(*args)
    for plain in (approx_counts_ref, approx_counts_nfa_sliced_ref):
        sliced["max_abs_err"] = max(sliced["max_abs_err"], exact_diff(
            got, plain(*args), f"nfa_sliced != {plain.__name__} at the "
            f"bench's shape"))
    log(f"[bench] C={BENCH_C} W={BENCH_W} m={MAIN['m']} k={k} maxerr={e} "
        f"(the bench's first buffer): kernel == plain == "
        f"approx_counts_nfa_sliced_ref exactly")
    del peq, wts, wv, args, got

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "approx_counter_tpu_torch.bench"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        log(line)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench: rc {proc.returncode}, {len(lines)} "
                             f"stdout lines\n{proc.stdout[-2000:]}")
    log(f"[bench] stdout: {lines[0]}")
    res = json.loads(lines[0])
    if set(res) != BENCH_KEYS or res["vs_baseline"] is None:
        raise AssertionError(f"bench: keys {sorted(res)}, vs_baseline "
                             f"{res.get('vs_baseline')}")
    # phase 2's pairs/s: C x W over its ms, the ms scaled to the bench's W;
    # held with its least trial, timed as the bench times (least of 3)
    def rate(ms):
        return BENCH_C * BENCH_W / (ms / 1e3 * BENCH_W / MAIN["W"])

    ratio = res["value"] / rate(sliced["best_ms"])
    log(f"[bench] value {res['value']} pairs/s is {ratio:.4f}x phase 2's "
        f"{rate(sliced['best_ms']):.1f} (its least trial, "
        f"{sliced['best_ms']:.4f} ms at C={MAIN['C']} W={MAIN['W']}, scaled "
        f"to W={BENCH_W}) and {res['value'] / rate(sliced['ms']):.4f}x its "
        f"first trial's ({sliced['ms']:.4f} ms); child wall {wall:.2f} s")
    if not 0.8 <= ratio <= 1.25:
        raise AssertionError(f"bench value {res['value']}: {ratio:.4f}x "
                             f"phase 2's rate, outside 0.8-1.25")
    found = re.search(r"^\[bench\] launches: (.*)$", proc.stderr, re.M)
    return json.loads(found.group(1))["nfa_sliced"]


# (kernel, k, pack) at the main shape; the first of each kernel is the one
# its "kernels" entry reports
ALTERNATES = [("bpm_myers", 16, 1), ("bpm_packed", 16, 2),
              ("bpm_packed", 8, 4), ("nfa_packed", 16, 2),
              ("nfa_packed", 16, 1), ("nfa_packed", 8, 4)]


def sass_targs(kernel: str, k: int, pack: int, e: int) -> tuple:
    """(build key, template arguments of the kernel's symbol)."""
    if kernel == "nfa_sliced":
        return (kernel, k, e), (k, e)
    if kernel == "bpm_myers":
        return (kernel, k), (k,)
    if kernel == "bpm_packed":
        return (kernel, k), (k, pack)
    return (kernel, k, e), (k, e, pack)


def phase_alternates(builds: dict, clock_hz: float, sliced: dict) -> dict:
    """The three alternate kernels at the default-run shape: each equal to
    its plain version, to the plain Myers scan and to the plain bit-sliced
    core it runs (Myers' or the level NFA's); both times and the bound.
    The packed NFA's text loop runs the sliced NFA's core: its SASS per
    step may differ from ``nfa_sliced``'s at the same k and maxerr by no
    more than its prologue's ALU ops spread over the m steps.  Then each
    time, and the sliced NFA's (``sliced``: phase 2's entry at k=16),
    against the kernel's own bound and against the function's: the least
    own bound of the four count kernels at that k.  Returns each kernel's
    entry for its first configuration, and sets ``sliced``'s too, with the
    function bound as ``bound_ms`` and the kernel's own as
    ``own_bound_ms``."""
    from approx_counter_tpu_torch.kernels.bpm import (
        approx_counts_myers,
        approx_counts_myers_sliced_ref,
        approx_counts_nfa_sliced_ref,
        approx_counts_packed,
        approx_counts_packed_ref,
        approx_counts_ref,
    )

    rng = np.random.default_rng(21)
    e = MAIN["maxerr"]
    entries = {}
    rows = [("nfa_sliced k=16", 16, sliced["ms"], sliced["bound_ms"])]
    own = {}  # k -> {configuration: (own bound ms, bound by)}
    sliced_ops = {}  # k -> nfa_sliced's SASS ops per step
    for k in sorted({k for _, k, _ in ALTERNATES}):
        key, targs = sass_targs("nfa_sliced", k, 1, e)
        sliced_ops[k] = sass_ops_per_step(builds[key].so, "nfa_sliced", targs)
        own[k] = {"nfa_sliced": bound(sliced_ops[k], MAIN["C"], clock_hz)}
    for kernel, k, pack in ALTERNATES:
        args = (*main_case(rng, k), k, e)
        if kernel == "bpm_myers":
            def fn():
                return approx_counts_myers(*args)

            plains = [approx_counts_ref]
        else:
            algo = "myers" if kernel == "bpm_packed" else "nfa"

            def fn():
                return approx_counts_packed(*args, pack, algo)

            def plain(*a):
                return approx_counts_packed_ref(*a, pack, algo)

            plains = [plain, approx_counts_ref]
        plains.append(approx_counts_nfa_sliced_ref if kernel == "nfa_packed"
                      else approx_counts_myers_sliced_ref)
        what = f"{kernel} k={k} pack={pack}"
        got = fn()
        err = max(exact_diff(got, p(*args), f"{what} != {p.__name__}")
                  for p in plains)
        ms, best_ms, trials = kernel_ms(fn)
        plain_ms = time_ms(lambda: plains[0](*args), 3)
        key, targs = sass_targs(kernel, k, pack, e)
        ops = sass_ops_per_step(builds[key].so, kernel, targs)
        bound_ms, bound_by = bound(ops, MAIN["C"], clock_hz)
        own[k][f"{kernel} pack {pack}"] = bound_ms, bound_by
        log(f"[alternates] {what} maxerr={e} at C=500 W=40000 m=101: == "
            f"{', '.join(p.__name__ for p in plains)} exactly; kernel "
            f"{ms:.4f} ms ({trials}, least {best_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; SASS "
            f"ops per step and thread: {ops_text(ops)})")
        not_under(what, best_ms, bound_ms)
        if kernel == "nfa_packed":
            prologue = sass_prologue_alu(builds[key].so, kernel, targs)
            diff = ops["alu"] - sliced_ops[k]["alu"]
            log(f"[alternates] {what} maxerr={e}: text loop SASS per step "
                f"{ops_text(ops)}, nfa_sliced k={k} maxerr={e} "
                f"{ops_text(sliced_ops[k])}; ALU {diff:+g} per step, the "
                f"prologue's {prologue} ALU ops over m={MAIN['m']} steps "
                f"{prologue / MAIN['m']:.2f}")
            if abs(diff) > prologue / MAIN["m"]:
                raise AssertionError(f"{what}: its text loop is not the "
                                     f"sliced NFA's ({diff:+g} ALU per step)")
        rows.append((what, k, ms, bound_ms))
        entries.setdefault(kernel, dict(k=k, max_abs_err=err, ms=ms,
                                        best_ms=best_ms, plain_ms=plain_ms,
                                        bound_ms=bound_ms))
    least = {k: min(bounds.values()) for k, bounds in own.items()}
    for k, bounds in own.items():
        log(f"[alternates] function bound at k={k}: {least[k][0]:.4f} ms, "
            f"the least own bound of "
            f"{ {c: round(b, 4) for c, (b, _) in bounds.items()} }")
    for what, k, ms, bound_ms in rows:
        fb = least[k][0]
        log(f"[alternates] {what}: time / own bound {ms / bound_ms:.4f} "
            f"({bound_ms / ms:.1%} of it), time / function bound "
            f"{ms / fb:.4f} ({fb / ms:.1%} of it)")
    # the kernels line reports the function bound: the least time the card
    # could take for the same work
    for entry in (sliced, *entries.values()):
        k = entry.pop("k", 16)
        entry["own_bound_ms"] = entry["bound_ms"]
        entry["bound_ms"], entry["bound_by"] = least[k]
    return entries


# the search-scheme phase's cases: k x maxerr 0-3 at the small size, then
# one at the default run's widths, past a 32-candidate word and a
# 256-window block
SS_KS = (2, 3, 8, 16, 32)
SS_SMALL = dict(C=8, W=32, m=40)
SS_DEFAULT = dict(C=40, W=260, m=101, k=16, maxerr=2)
# gpu_check.kernel_runs names, pack stripped -> kernel
SS_KERNEL = {"sliced": "nfa_sliced", "myers": "bpm_myers",
             "myers-p": "bpm_packed", "nfa-p": "nfa_packed"}


def phase_searchscheme() -> None:
    """Phase 3b: every approximate-count kernel and every plain version
    against ``search_scheme_error_count``, integer equality, on the
    adversarial windows of ``gpu_check.searchscheme_case``; then
    ``approx_count_rank`` on the card against its CPU result."""
    import torch

    from approx_counter_tpu_torch.count.approx import approx_count_rank
    from approx_counter_tpu_torch.gpu_check import kernel_runs, searchscheme_case
    from approx_counter_tpu_torch.kernels.bpm import (
        approx_counts_myers_sliced_ref,
        approx_counts_nfa_sliced_ref,
        build_peq,
    )
    from approx_counter_tpu_torch.searchscheme import search_scheme_error_count

    dev = torch.device("cuda")
    rng = np.random.default_rng(22)
    cases = [(k, e, SS_SMALL) for k in SS_KS for e in range(4)]
    cases.append((SS_DEFAULT["k"], SS_DEFAULT["maxerr"], SS_DEFAULT))
    held: dict = {}
    oracle_s = 0.0
    t_phase = time.perf_counter()
    reset_launch_counts()
    for k, e, size in cases:
        C, W, m = size["C"], size["W"], size["m"]
        codes, wins_t, valid = searchscheme_case(rng, C, W, m, k)
        t0 = time.perf_counter()
        got = search_scheme_error_count(
            [wins_t[:, w] for w in np.flatnonzero(valid)], codes, k, e)
        oracle_s += time.perf_counter() - t0
        want = torch.tensor([got[int(c)] for c in codes], dtype=torch.int32,
                            device=dev)
        args = (build_peq(torch.from_numpy(codes).to(dev), k),
                torch.from_numpy(wins_t).to(dev),
                torch.from_numpy(valid).to(dev), k, e)
        for name, wrapper, plain in kernel_runs(k):
            what = f"{name} at k={k} maxerr={e} C={C} W={W} m={m}"
            exact_diff(wrapper(*args), want,
                       f"{what} != search_scheme_error_count")
            exact_diff(plain(*args), want,
                       f"{what}: plain version != search_scheme_error_count")
            held.setdefault(SS_KERNEL[name.rstrip("0123456789")], []).append(
                name)
        for core in (approx_counts_myers_sliced_ref,
                     approx_counts_nfa_sliced_ref):
            exact_diff(core(*args), want,
                       f"{core.__name__} at k={k} maxerr={e} C={C} W={W} "
                       f"m={m} != search_scheme_error_count")
    launches = launch_counts()
    idle = [name for name in held if launches[name] < 1]
    if idle or len(held) != 4:
        raise AssertionError(f"search-scheme phase: kernels {sorted(held)}, "
                             f"no launch of {idle}")
    wall = time.perf_counter() - t_phase
    log(f"[searchscheme] {len(cases)} cases: k in {SS_KS} x maxerr 0-3 at "
        f"C=8 W=32 m=40, k=16 maxerr 2 at C=40 W=260 m=101; "
        f"approx_counts_myers_sliced_ref and approx_counts_nfa_sliced_ref "
        f"== search_scheme_error_count in each")
    for kernel, names in held.items():
        configs = ", ".join(sorted(set(names), key=names.index))
        log(f"[searchscheme] {kernel} ({configs}): {len(names)} cases == "
            f"search_scheme_error_count exactly, its plain version too; "
            f"{launches[kernel]} launches; phase {wall:.2f} s host wall, "
            f"{oracle_s:.2f} s of it the oracle")

    # approx_count_rank at the default case (the loop's last), a fifth of
    # the slots padding
    k, e = SS_DEFAULT["k"], SS_DEFAULT["maxerr"]
    windows = np.ascontiguousarray(wins_t.T)
    sel_valid = rng.random(len(codes)) < 0.8
    n_valid = int(valid.sum())
    ranked = {}
    for where in ("cpu", "cuda"):
        ranked[where] = [x.cpu() for x in approx_count_rank(
            torch.from_numpy(windows).to(where), n_valid,
            torch.from_numpy(codes).to(where),
            torch.from_numpy(sel_valid).to(where), k, e)]
    for name, a, b in zip(("codes", "counts", "valid"), ranked["cpu"],
                          ranked["cuda"]):
        if not torch.equal(a, b):
            raise AssertionError(f"approx_count_rank on the card: {name} "
                                 f"differ from the CPU's")
    r_codes, r_counts, r_valid = ranked["cuda"]
    n = int(sel_valid.sum())
    if (not bool(r_valid[:n].all())
            or [got[int(c)] for c in r_codes[:n]] != r_counts[:n].tolist()):
        raise AssertionError("approx_count_rank: valid rows' counts differ "
                             "from search_scheme_error_count")
    log(f"[searchscheme] approx_count_rank k=16 maxerr 2 C=40 ({n} valid) "
        f"W=260 m=101: card == CPU (codes, counts, valid), valid counts == "
        f"search_scheme_error_count")


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
    return {end: ms / 1e3 for end, ms in
            per_end_ms(stdout, "Working on sequence", "Done").items()}


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


def phase_parity(fasta: str, out_dir: str, k: int, extra: tuple = (),
                 tag: str = "") -> None:
    import torch

    from approx_counter_tpu_torch.config.cli import resolve_params
    from approx_counter_tpu_torch.pipeline import run_pipeline

    stem = f"{out_dir}/p{k}{tag}"

    def argv(dev):
        return [fasta, "-k", str(k), "-sn", "3000", "-o", f"{stem}{dev}_out",
                "-e", f"{stem}{dev}_exact", "--seed", "5", *extra]

    what = " ".join([f"-k {k}", *extra])
    rc, stdout = run_cli(argv("gpu"))
    if rc != 0:
        raise AssertionError(f"GPU CLI {what} rc {rc}:\n{stdout}")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = run_pipeline(resolve_params(argv("cpu")),
                          device=torch.device("cpu"))
    if rc != 0:
        raise AssertionError(f"CPU run_pipeline {what} rc {rc}")
    n_files = 0
    for which in ("start", "end"):
        for kind in ("out", "exact"):
            paths = [f"{stem}{d}_{kind}_0.{which}" for d in ("gpu", "cpu")]
            if not any(map(os.path.exists, paths)):
                continue
            a, b = (open(p, "rb").read() for p in paths)
            if a != b:
                raise AssertionError(f"{paths[0]} != {paths[1]}")
            n_files += 1
    if n_files != (2 if "--from-exact" in extra else 4):
        raise AssertionError(f"{what}: {n_files} exports")
    log(f"[parity] {what} -sn 3000: GPU and CPU exports byte-equal "
        f"({n_files} files)")


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
    idle = [name for name, n in counts.items()
            if n < 1 and name != "sort_stage"]
    if idle:
        raise AssertionError(f"gpu_check launched no {idle}")
    log(f"[gpu_check] {len(rows)} rows OK in {wall:.2f} s; launches {counts}")
    return counts


def int32_case(rng, rows: int):
    """Seeded int32 [rows, 128] on the card over the whole int32 range, a
    fifth of it ties among -3..2, and the int32 extremes."""
    import torch

    x = rng.integers(-(1 << 31), 1 << 31, (rows, 128)).astype(np.int32)
    x[rng.random(x.shape) < 0.2] = rng.integers(-3, 3)
    x.flat[:2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    return torch.from_numpy(x).to("cuda")


PROBE_LINES = ("model: 210 stages x 4 x 8192x128 int32", "(s1) stages only",
               "(s2) + transpose/20", "torch.sort P=3522560 int32",
               "torch.sort P=3522560 int64", "done")


def phase_sort_stage(builds: dict, clock_hz: float) -> tuple[dict, int]:
    """The stage network against its plain version, its times, bound and
    SASS, then the probe's entry point.  Returns the kernel's entry (at
    the (s1) shape) and the launches of the entry point's run."""
    from approx_counter_tpu_torch.kernels.sort_stage import (
        stage_network,
        stage_network_ref,
        stages_run,
    )
    from approx_counter_tpu_torch.native import sort_stage_probe5 as probe

    rng = np.random.default_rng(22)
    shapes = [(rows, stages, te) for rows in (16, 144, 128, 384)
              for stages in (0, 1, 19, 21, 210) for te in (0, 1, 20)
              if not (te and rows % 128)]
    max_err = 0
    for rows, stages, te in shapes:
        x = int32_case(rng, rows)
        max_err = max(max_err, exact_diff(
            stage_network(x, stages, te), stage_network_ref(x, stages, te),
            f"sort_stage != plain at rows={rows} stages={stages} "
            f"transpose_every={te}"))
    log(f"[sort_stage] {len(shapes)} small shapes (rows 16/144/128/384 x "
        f"stages 0/1/19/21/210 x transpose every 0/1/20): kernel == plain "
        f"exactly")

    rows, entry = probe.BLOCKS * probe.ROWS, None
    for te in (0, probe.TRANSPOSE_EVERY):
        x = int32_case(rng, rows)
        err = exact_diff(stage_network(x, probe.STAGES, te),
                         stage_network_ref(x, probe.STAGES, te),
                         f"sort_stage != plain at the probe's shape, "
                         f"transpose_every={te}")
        ms = time_ms(lambda: stage_network(x, probe.STAGES, te), 20)
        plain_ms = time_ms(lambda: stage_network_ref(x, probe.STAGES, te), 3)
        run = stages_run(probe.STAGES, te)
        # one min or max per element and stage; int32 in and out once
        bound_ms, bound_by = roofline({"alu": run * rows * 128},
                                      8 * rows * 128, clock_hz)
        log(f"[sort_stage] [{rows}, 128] int32, {run} stages, transpose "
            f"every {te}: kernel == plain exactly; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (CUDA events, mean of 20 / 3 calls after 2 "
            f"warm-up); bound {bound_ms:.4f} ms ({bound_by}); "
            f"{run * rows * 128 / ms / 1e9:.4f} T elem-stages/s")
        not_under(f"sort_stage, transpose every {te}", ms, bound_ms)
        if entry is None:  # its own bound is its function's
            entry = dict(max_abs_err=max(max_err, err), ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         own_bound_ms=bound_ms, bound_by=bound_by)
    per_trip = sass_minmax_per_stage_trip(builds[("sort_stage",)].so)
    log(f"[sort_stage] SASS integer min/max per stage-loop trip: {per_trip} "
        f"(one stage a trip, runtime trip count)")

    reset_launch_counts()
    err_out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err_out):
        rc = probe.main([])
    wall = time.perf_counter() - t0
    launches = launch_counts()["sort_stage"]
    for line in err_out.getvalue().splitlines():
        log(f"[probe] {line}")
    missing = [s for s in PROBE_LINES if s not in err_out.getvalue()]
    if rc != 0 or launches < 1 or missing:
        raise AssertionError(f"probe: rc {rc}, {launches} launches, lines "
                             f"missing: {missing}")
    log(f"[probe] rc 0 in {wall:.2f} s; launches {launch_counts()}")
    return entry, launches



# the sliced kernel's old limit: 65,535 words of 32 candidates on grid.y
OLD_LIMIT = 65535 * 32
LIMIT = dict(C=2_100_000, W=2048, m=101)


def phase_limit(builds: dict, clock_hz: float) -> dict:
    """Phase 8: the sliced NFA past 2,097,120 candidates.  Returns its
    launches, time and bound."""
    import torch

    from approx_counter_tpu_torch.kernels import bpm

    rng = np.random.default_rng(23)
    k, e, C = 16, MAIN["maxerr"], LIMIT["C"]
    codes, wins_t, valid = random_case(rng, C, LIMIT["W"], LIMIT["m"], k, 17)
    dev = torch.device("cuda")
    peq = bpm.build_peq(torch.from_numpy(codes).to(dev), k)
    args = (torch.from_numpy(wins_t).to(dev), torch.from_numpy(valid).to(dev),
            k, e)

    def counted(fn):
        before = bpm.approx_counts.launches
        out = fn()
        return out, bpm.approx_counts.launches - before

    got, launches = counted(lambda: bpm.approx_counts(peq, *args))
    plan = bpm.word_launches(-(-C // 32))
    if launches != len(plan) or len(plan) < 2:
        raise AssertionError(f"C={C}: {launches} launches, plan {plan}")
    rows = np.unique(np.concatenate([
        rng.choice(C, 1024, replace=False),
        np.arange(OLD_LIMIT - 1000, OLD_LIMIT + 1000),
        np.arange(C - 1000, C)]))
    rows_t = torch.from_numpy(rows).to(dev)
    err = exact_diff(got[rows_t], bpm.approx_counts_ref(peq[rows_t], *args),
                     f"nfa_sliced != plain on {len(rows)} rows at C={C}")
    one, one_launch = counted(
        lambda: bpm.approx_counts(peq[:OLD_LIMIT], *args))
    if one_launch != 1:
        raise AssertionError(f"C={OLD_LIMIT}: {one_launch} launches, want 1")
    exact_diff(got[:OLD_LIMIT], one,
               f"{len(plan)} launches != one launch over the first "
               f"{OLD_LIMIT} candidates")
    ms = time_ms(lambda: bpm.approx_counts(peq, *args), 3)
    ops = sass_ops_per_step(builds[("nfa_sliced", k, e)].so, "nfa_sliced",
                            (k, e))
    bound_ms, bound_by = bound(ops, C, clock_hz, LIMIT["m"], LIMIT["W"])
    not_under(f"nfa_sliced at C={C}", ms, bound_ms)
    log(f"[limit] C={C} ({C // 32} words) W={LIMIT['W']} m={LIMIT['m']} "
        f"k=16 maxerr=2: {launches} launches {plan}; kernel == plain on "
        f"{len(rows)} rows (1,024 random, 2,000 around candidate "
        f"{OLD_LIMIT}, the last 1,000), first {OLD_LIMIT} == one launch; "
        f"{ms:.4f} ms (mean of 3 after 2 warm-up), bound {bound_ms:.4f} ms "
        f"({bound_by}), {C * LIMIT['W'] / ms / 1e9:.4f} T pairs/s")
    return dict(launches=launches, max_abs_err=err, ms=ms, bound_ms=bound_ms,
                bound_by=bound_by)


# past the alternate kernels' one-launch limits: 65,535 groups of 32
# candidates on grid.y (2,097,120 candidates)
ALT_LIMIT = dict(C=2_100_000, W=512, m=101)


def phase_alt_limit(builds: dict, clock_hz: float) -> None:
    """Phase 8, continued: unpacked Myers, packed Myers at pack 2 and the
    packed NFA at pack 1 at C=2,100,000, past each one's one-launch limit:
    each split over its launch plan, equal to its plain versions on ~4,000
    rows (each also to the plain bit-sliced core it runs) and, on the
    candidates of one launch, to one launch over those alone."""
    import torch

    from approx_counter_tpu_torch.kernels import bpm

    rng = np.random.default_rng(25)
    k, e, C = 16, MAIN["maxerr"], ALT_LIMIT["C"]
    codes, wins_t, valid = random_case(rng, C, ALT_LIMIT["W"], ALT_LIMIT["m"],
                                       k, 9)
    dev = torch.device("cuda")
    peq = bpm.build_peq(torch.from_numpy(codes).to(dev), k)
    args = (torch.from_numpy(wins_t).to(dev), torch.from_numpy(valid).to(dev),
            k, e)
    P = functools.partial
    # kernel -> (pack, rows of a grid.y group, wrapper, plain versions,
    # launch count)
    cases = {
        "bpm_myers": (1, bpm.SLICED_CANDS, bpm.approx_counts_myers,
                      [bpm.approx_counts_ref,
                       bpm.approx_counts_myers_sliced_ref],
                      lambda: bpm.approx_counts_myers.launches),
        "bpm_packed": (2, bpm.SLICED_CANDS // 2,
                       P(bpm.approx_counts_packed, pack=2, algo="myers"),
                       [P(bpm.approx_counts_packed_ref, pack=2, algo="myers"),
                        bpm.approx_counts_ref,
                        bpm.approx_counts_myers_sliced_ref],
                       lambda: bpm.approx_counts_packed.launches["myers"]),
        "nfa_packed": (1, bpm.SLICED_CANDS,
                       P(bpm.approx_counts_packed, pack=1, algo="nfa"),
                       [P(bpm.approx_counts_packed_ref, pack=1, algo="nfa"),
                        bpm.approx_counts_ref,
                        bpm.approx_counts_nfa_sliced_ref],
                       lambda: bpm.approx_counts_packed.launches["nfa"]),
    }
    for name, (pack, group, fn, plains, count) in cases.items():
        plan = bpm.word_launches(-(-C // pack), group)
        limit = bpm.MAX_GRID_Y * group * pack  # candidates of one launch
        rows = np.unique(np.concatenate([
            rng.choice(C, 1024, replace=False),
            np.arange(limit - 1000, limit + 1000), np.arange(C - 1000, C)]))
        rows_t = torch.from_numpy(rows).to(dev)
        before = count()
        got = fn(peq, *args)
        launches = count() - before
        if launches != len(plan) or len(plan) < 2:
            raise AssertionError(f"{name} C={C}: {launches} launches, plan "
                                 f"{plan}")
        for plain in plains:
            exact_diff(got[rows_t], plain(peq[rows_t], *args),
                       f"{name} != {getattr(plain, 'func', plain).__name__} "
                       f"on {len(rows)} rows at C={C}")
        before = count()
        one = fn(peq[:limit], *args)
        if count() - before != 1:
            raise AssertionError(f"{name} C={limit}: not one launch")
        exact_diff(got[:limit], one,
                   f"{name}: {len(plan)} launches != one launch over the "
                   f"first {limit} candidates")
        ms = time_ms(lambda: fn(peq, *args), 3)
        key, targs = sass_targs(name, k, pack, e)
        ops = sass_ops_per_step(builds[key].so, name, targs)
        bound_ms, bound_by = bound(ops, C, clock_hz, ALT_LIMIT["m"],
                                   ALT_LIMIT["W"])
        not_under(f"{name} at C={C}", ms, bound_ms)
        log(f"[limit] {name} pack {pack} C={C} W={ALT_LIMIT['W']} "
            f"m={ALT_LIMIT['m']} k=16 maxerr=2: {launches} launches "
            f"{[n for _, n in plan]} (rows of {group}-row groups); kernel == "
            f"{len(plains)} plain versions on {len(rows)} rows (1,024 "
            f"random, 2,000 around candidate {limit}, the last 1,000), first "
            f"{limit} == one launch; {ms:.4f} ms (mean of 3 after 2 "
            f"warm-up), bound {bound_ms:.4f} ms ({bound_by})")


def log_lines(stdout: str) -> list[tuple[str, str, float]]:
    """(end, text, ms) of every timestamped CLI log line; end is the
    ``Working on sequence`` end it falls under ("" before the first)."""
    rows, cur = [], ""
    for line in stdout.splitlines():
        mt = re.match(r"\[([0-9.e+]+) ms\]\t+(.*)", line)
        if not mt:
            continue
        text = mt.group(2)
        me = re.match(r"Working on sequence (start|end)\.", text)
        if me:
            cur = me.group(1)
        rows.append((cur, text, float(mt.group(1))))
    return rows


def per_end_ms(stdout: str, first: str, last: str) -> dict:
    """Per end, ms from its log line starting with ``first`` to the next
    one starting with ``last``."""
    out, t0 = {}, {}
    for end, text, ms in log_lines(stdout):
        if text.startswith(first):
            t0[end] = ms
        elif text.startswith(last) and end in t0 and end not in out:
            out[end] = ms - t0[end]
    return out


def per_end_kept(stdout: str) -> dict:
    return {end: int(text.split()[-1]) for end, text, _ in log_lines(stdout)
            if text.startswith("Number of kmer kept:")}


def read_export(path: str, k: int):
    """(uint64 codes, int64 counts) of a ``kmer\\tcount`` export."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")[:-1]
    if not lines:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    lut = np.zeros(256, np.uint64)
    lut[np.frombuffer(b"CGT", np.uint8)] = [1, 2, 3]
    bases = lut[np.frombuffer(b"".join(ln[:k] for ln in lines), np.uint8)]
    codes = np.zeros(len(lines), np.uint64)
    for i in range(k):
        codes = (codes << np.uint64(2)) | bases[i::k]
    counts = np.array(b" ".join(ln[k + 1:] for ln in lines).split(),
                      dtype=np.int64)
    return codes, counts


def check_compare_count(codes, counts, k: int, what: str) -> None:
    """Raises unless the rows are in CompareCount order: count descending,
    then dimer sum ascending, then code descending (unsigned, distinct)."""
    import torch

    from approx_counter_tpu_torch.core.complexity import dimer_sum

    d = dimer_sum(torch.from_numpy(codes.view(np.int64)).cuda(), k)
    d = d.cpu().numpy()
    c, u = counts, codes
    ok = (c[:-1] > c[1:]) | ((c[:-1] == c[1:]) & (
        (d[:-1] < d[1:]) | ((d[:-1] == d[1:]) & (u[:-1] > u[1:]))))
    if not ok.all():
        i = int(np.argmin(ok))
        raise AssertionError(f"{what}: rows {i}, {i + 1} out of CompareCount "
                             f"order ({c[i]}, {d[i]}, {u[i]}) / "
                             f"({c[i + 1]}, {d[i + 1]}, {u[i + 1]})")


def check_top(path: str, adapter: str, n_lines: int) -> None:
    with open(path) as f:
        lines = f.read().splitlines()
    if len(lines) != n_lines:
        raise AssertionError(f"{path}: {len(lines)} lines, want {n_lines}")
    top = [ln.split("\t")[0] for ln in lines[:5]]
    if not all(km in adapter for km in top):
        raise AssertionError(f"{path}: top k-mers {top} are not all from "
                             f"the planted adapter")


ADAPTERS = (("start", START_ADAPTER), ("end", END_ADAPTER))


def kernel_at(builds: dict, clock_hz: float, C: int, reps: int,
              warmup: int) -> tuple[float, float, str]:
    """(ms, bound ms, what bounds it) of the sliced NFA at C random
    candidates and the default run's W=40,000, m=101, k=16, maxerr 2."""
    import torch

    from approx_counter_tpu_torch.kernels.bpm import approx_counts, build_peq

    rng = np.random.default_rng(24)
    k, e = 16, MAIN["maxerr"]
    codes, wins_t, valid = random_case(rng, C, MAIN["W"], MAIN["m"], k,
                                       MAIN["n_invalid"])
    dev = torch.device("cuda")
    args = (build_peq(torch.from_numpy(codes).to(dev), k),
            torch.from_numpy(wins_t).to(dev), torch.from_numpy(valid).to(dev),
            k, e)
    ms = time_ms(lambda: approx_counts(*args), reps, warmup)
    ops = sass_ops_per_step(builds[("nfa_sliced", k, e)].so, "nfa_sliced",
                            (k, e))
    bound_ms, bound_by = bound(ops, C, clock_hz)
    not_under(f"nfa_sliced at C={C}", ms, bound_ms)
    return ms, bound_ms, bound_by


def phase_solid(fasta: str, out_dir: str, builds: dict,
                clock_hz: float) -> dict:
    """Phase 9: the default run at -sk 20 and -sk 1.  Returns, per N, the
    kept counts and launches, and the kernel's time and bound at each's
    start C."""
    from approx_counter_tpu_torch.kernels.bpm import word_launches

    result = {}
    for sk in (20, 1):
        out, exact = f"{out_dir}/sk{sk}_out", f"{out_dir}/sk{sk}_exact"
        reset_launch_counts()
        t0 = time.perf_counter()
        rc, stdout = run_cli([fasta, "-sk", str(sk), "-o", out, "-e", exact,
                              "--seed", "5"])
        wall = time.perf_counter() - t0
        launches = launch_counts()["nfa_sliced"]
        if rc != 0:
            raise AssertionError(f"CLI -sk {sk} rc {rc}:\n{stdout}")
        kept = per_end_kept(stdout)
        plan = {end: len(word_launches(-(-n // 32)))
                for end, n in kept.items()}
        if launches != sum(plan.values()):
            raise AssertionError(f"-sk {sk}: {launches} launches, the plan "
                                 f"for n_keep {kept} gives {plan}")
        for which, adapter in ADAPTERS:
            codes, counts = read_export(f"{exact}_0.{which}", 16)
            if len(codes) != kept[which] or counts.min() < sk:
                raise AssertionError(f"-sk {sk} {which}: {len(codes)} exact "
                                     f"lines (kept {kept[which]}), least "
                                     f"count {counts.min()}")
            check_compare_count(codes, counts, 16, f"-sk {sk} exact {which}")
            check_top(f"{out}_0.{which}", adapter, min(kept[which], 500))
        walls = end_seconds(stdout)
        count_ms = per_end_ms(stdout, "Exact k-mer count",
                              "Number of kmer found")
        exp_ms = per_end_ms(stdout, "Exporting exact kmer count",
                            "Approximate k-mer count")
        app_ms = per_end_ms(stdout, "Exporting approximate count", "Done")
        log(f"[solid] -sk {sk}: rc 0, n_keep {kept}, launches {launches} "
            f"(plan {plan}; > {OLD_LIMIT} candidates: "
            f"{ {e: n > OLD_LIMIT for e, n in kept.items()} }), exact exports "
            f"n_keep lines >= {sk} in CompareCount order, approx "
            f"min(n_keep, 500) lines with adapters on top; per-end wall "
            f"{ {e: round(t, 4) for e, t in walls.items()} } s, whole CLI "
            f"{wall:.4f} s; split per end (ms): count+score {count_ms}, exact "
            f"export {exp_ms}, approx export {app_ms}")
        reps, warmup = (20, 2) if sk == 20 else (1, 1)
        ms, bound_ms, bound_by = kernel_at(builds, clock_hz, kept["start"],
                                           reps, warmup)
        log(f"[solid] kernel at the -sk {sk} start C={kept['start']}, "
            f"W=40000, m=101: {ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), {kept['start'] * MAIN['W'] / ms / 1e9:.4f} T "
            f"pairs/s")
        result[sk] = dict(kept=kept, launches=launches, ms=ms,
                          bound_ms=bound_ms)
    return result


def same_bytes(a: str, b: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError(f"{a} != {b}")


def phase_resume(fasta: str, out_dir: str) -> int:
    """Phase 10: --from-exact on phase 4's warm k=16 exact .start.
    Returns the launches."""
    import glob

    out, exact = f"{out_dir}/resume_out", f"{out_dir}/resume_exact"
    reset_launch_counts()
    rc, stdout = run_cli([fasta, "--from-exact",
                          f"{out_dir}/k16_warm_exact_0.start", "-o", out,
                          "-e", exact, "--seed", "5"])
    launches = launch_counts()["nfa_sliced"]
    if rc != 0 or launches != 2:
        raise AssertionError(f"resume rc {rc}, {launches} launches:\n{stdout}")
    if glob.glob(f"{exact}*"):
        raise AssertionError("resume wrote an exact export")
    same_bytes(f"{out}_0.start", f"{out_dir}/k16_warm_out_0.start")
    with open(f"{out}_0.end") as f:  # start candidates scored on the ends
        if len(f.read().splitlines()) != 500:
            raise AssertionError(f"{out}_0.end: not 500 lines")
    log(f"[resume] --from-exact (500 codes): rc 0, launches {launches}, no "
        f"exact export, .start byte-equal to the full run's, .end 500 lines; "
        f"per-end wall {end_seconds(stdout)} s")
    return launches


# The child samples its resident set (VmRSS) every millisecond while a run
# lasts: getrusage's ru_maxrss would start from the parent's peak, which
# execve carries over into the child, and that host's /proc has no VmHWM.
# The stream's MB/s comes from one more streamed run without the sampler.
STREAM_CHILD = r"""
import contextlib, io, json, sys, threading, time
import torch
from approx_counter_tpu_torch.__main__ import main
big, warm, out = sys.argv[1:4]

def rss():
    with open("/proc/self/status") as f:
        return 1024 * int([ln.split()[1] for ln in f
                           if ln.startswith("VmRSS:")][0])

def cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()

def sampled(argv):
    peak, done = [rss()], threading.Event()

    def watch():
        while not done.wait(0.001):
            peak[0] = max(peak[0], rss())

    t = threading.Thread(target=watch)
    t.start()
    t0 = time.perf_counter()
    try:
        rc, log = cli(argv)
    finally:
        wall = time.perf_counter() - t0
        done.set()
        t.join()
    return dict(rc=rc, wall=wall, peak=max(peak[0], rss()), log=log)

torch.zeros(1, device="cuda")
warm_rc, _ = cli([warm, "--stream", "-o", out + "/warm", "--seed", "5"])
res = dict(warm_rc=warm_rc)
for mode in ("stream", "mem"):
    base = rss()
    res[mode] = sampled([big, "-o", f"{out}/big_{mode}_out", "-e",
                         f"{out}/big_{mode}_exact", "--seed", "5"]
                        + (["--stream"] if mode == "stream" else []))
    res[mode]["base"] = base
t0 = time.perf_counter()
rc, log = cli([big, "--stream", "-o", f"{out}/big_plain_out", "-e",
               f"{out}/big_plain_exact", "--seed", "5"])
res["plain"] = dict(rc=rc, wall=time.perf_counter() - t0, log=log)
print(json.dumps(res))
"""


def phase_stream(fasta: str, out_dir: str) -> dict:
    """Phase 11: stream == in-memory at identity sampling, the 440 MB
    stream in a child process, native vs Python parse rates."""
    from approx_counter_tpu_torch.io.fastx import read_fastx, read_fastx_py

    launches = {}
    for mode in ("mem", "stream"):
        reset_launch_counts()
        rc, stdout = run_cli([fasta, "-sn", "60000", "-o",
                              f"{out_dir}/id_{mode}_out", "-e",
                              f"{out_dir}/id_{mode}_exact", "--seed", "5"]
                             + (["--stream"] if mode == "stream" else []))
        launches[mode] = launch_counts()["nfa_sliced"]
        if rc != 0 or launches[mode] != 2:
            raise AssertionError(f"-sn 60000 {mode} rc {rc}:\n{stdout}")
    for which in ("start", "end"):
        for kind in ("out", "exact"):
            same_bytes(f"{out_dir}/id_mem_{kind}_0.{which}",
                       f"{out_dir}/id_stream_{kind}_0.{which}")
    log("[stream] --stream -sn 60000 == in-memory -sn 60000 (every read "
        "eligible): 4 exports byte-equal")

    size = os.path.getsize(fasta)
    times = {}
    for name, fn in (("native", read_fastx), ("python", read_fastx_py)):
        t0 = time.perf_counter()
        reads = fn(fasta)
        times[name] = (time.perf_counter() - t0, reads)
    (t_n, r_n), (t_p, r_p) = times["native"], times["python"]
    if not (np.array_equal(r_n.buf, r_p.buf)
            and np.array_equal(r_n.offsets, r_p.offsets)):
        raise AssertionError("native read_fastx != Python read_fastx")
    log(f"[parse] {size / 1e6:.1f} MB, {len(r_n)} reads: native "
        f"{t_n * 1e3:.2f} ms ({size / 1e6 / t_n:.1f} MB/s), Python "
        f"{t_p * 1e3:.2f} ms ({size / 1e6 / t_p:.1f} MB/s), Reads equal")

    big, warm = f"{out_dir}/big.fasta", f"{out_dir}/warm.fasta"
    with open(fasta, "rb") as f:
        data = f.read()
    with open(big, "wb") as f:
        for i in range(10):
            f.write(data.replace(b">read", b">c%d_read" % i))
    with open(warm, "wb") as f:
        f.write(data[:data.index(b">read2000\n")])
    big_size = os.path.getsize(big)
    proc = subprocess.run([sys.executable, "-c", STREAM_CHILD, big, warm,
                           out_dir], capture_output=True, text=True,
                          cwd=REPO, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"stream child rc {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for mode in ("stream", "mem", "plain"):
        if res["warm_rc"] != 0 or res[mode]["rc"] != 0:
            raise AssertionError(f"{mode} on {big_size} B: {res}")
        for which, adapter in ADAPTERS:
            for kind in ("out", "exact"):
                check_top(f"{out_dir}/big_{mode}_{kind}_0.{which}",
                          adapter, 500)
    for mode in ("stream", "plain"):
        if "Number of sequences found: 500000." not in res[mode]["log"]:
            raise AssertionError("the stream did not count 500,000 reads")
    pass_ms = per_end_ms(res["plain"]["log"], "Streaming pass",
                         "Number of sequences found")[""]
    sampled_ms = per_end_ms(res["stream"]["log"], "Streaming pass",
                            "Number of sequences found")[""]
    growth = {m: res[m]["peak"] - res[m]["base"] for m in ("stream", "mem")}
    if growth["stream"] > big_size / 4:
        raise AssertionError(f"stream peak RSS grew {growth['stream']} B on "
                             f"a {big_size} B file")
    log(f"[stream] {big_size / 1e6:.1f} MB, 500,000 reads, --stream at the "
        f"default sn: rc 0, 4 x 500 lines, adapters on top; streaming pass "
        f"{pass_ms:.1f} ms ({big_size / 1e6 / (pass_ms / 1e3):.1f} MB/s), "
        f"whole CLI {res['plain']['wall']:.3f} s (no sampler); with VmRSS "
        f"sampled each ms: streaming pass {sampled_ms:.1f} ms, whole CLI "
        f"{res['stream']['wall']:.3f} s, peak RSS growth "
        f"{growth['stream'] / 2**20:.1f} MiB over "
        f"{res['stream']['base'] / 2**20:.1f} MiB; the in-memory run on the "
        f"same file, sampled: {growth['mem'] / 2**20:.1f} MiB, "
        f"{res['mem']['wall']:.3f} s")
    return dict(launches=launches["stream"], pass_ms=pass_ms,
                big_bytes=big_size, growth=growth)


def busy_ms(intervals: list, lo: float = -np.inf, hi: float = np.inf) -> float:
    """ms covered by the union of (start, end) µs intervals clipped to
    [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s_, e_ in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if e_ <= s_:
            continue
        if cur_e is None or s_ > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def phase_profile(fasta: str, out_dir: str) -> int:
    """Phase 12: the default run under --profile.  Returns the launches."""
    prof = f"{out_dir}/profile"
    out, exact = f"{out_dir}/prof_out", f"{out_dir}/prof_exact"
    reset_launch_counts()
    rc, stdout = run_cli([fasta, "-o", out, "-e", exact, "--seed", "5",
                          "--profile", prof])
    launches = launch_counts()["nfa_sliced"]
    if rc != 0 or launches != 2:
        raise AssertionError(f"--profile rc {rc}, {launches} launches")
    for which in ("start", "end"):
        for kind in ("out", "exact"):
            same_bytes(f"{out_dir}/prof_{kind}_0.{which}",
                       f"{out_dir}/k16_warm_{kind}_0.{which}")
    events, sliced, gpu, shares, overlap = read_trace(f"{prof}/trace.json")
    if len(sliced) != 2:
        raise AssertionError(f"trace: {len(sliced)} nfa_sliced kernels")
    if len(overlap) != 1:
        raise AssertionError(f"trace: {len(overlap)} prefetch ranges, want 1")
    log(f"[profile] --profile: rc 0, exports byte-equal to the unprofiled "
        f"run, {len(events)} trace events, "
        f"{sum(e.get('cat') == 'kernel' for e in events)} kernels; "
        f"nfa_sliced {[round(e['dur'] / 1e3, 4) for e in sliced]} ms; device "
        f"busy {busy_ms(gpu):.4f} ms in all; busy per end pass: {shares}")
    log(f"[profile] overlap: the end pass's sampling and upload (prefetch "
        f"range, ms) against the start pass's device time inside it (ms): "
        f"{overlap}")
    return launches


def read_trace(path: str):
    """(events, nfa_sliced kernel events, device intervals, each end pass's
    device-busy ms of its wall, the overlap) of a ``--profile`` Chrome
    trace.  The overlap lists, for each ``prefetch`` range (the next pass's
    sampling and upload on the driver's thread), its ms and the device-busy
    ms in it of work launched from other threads: the in-flight pass,
    counting on the engine's worker thread."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    sliced = [e for e in events if e.get("cat") == "kernel"
              and "nfa_sliced" in e.get("name", "")]
    on_card = [e for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    gpu = [(e["ts"], e["ts"] + e["dur"]) for e in on_card]
    ends = {e["name"].split()[0]: (e["ts"], e["ts"] + e["dur"])
            for e in events if e.get("cat") == "user_annotation"
            and e.get("name") in ("start pass", "end pass")}
    shares = {end: f"{busy_ms(gpu, lo, hi):.4f} of {(hi - lo) / 1e3:.4f} ms "
                   f"({busy_ms(gpu, lo, hi) / ((hi - lo) / 1e3):.1%})"
              for end, (lo, hi) in sorted(ends.items())}
    launcher = {e["args"]["correlation"]: e["tid"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    overlap = []
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") == "prefetch":
            lo, hi = e["ts"], e["ts"] + e["dur"]
            other = [(d["ts"], d["ts"] + d["dur"]) for d in on_card
                     if launcher.get(d.get("args", {}).get("correlation"),
                                     e["tid"]) != e["tid"]]
            overlap.append((round(e["dur"] / 1e3, 4),
                            round(busy_ms(other, lo, hi), 4)))
    return events, sliced, gpu, shares, overlap


# A rank of a multi-rank run on the card, started by torchrun: the CLI's
# --multihost branch (``__main__.main``: join the group, ``run`` on the
# rank's card, leave) with the runs of the JSON list in argv[1], one after
# the other in one process: [label, extra CLI arguments]; ``@RUN@`` in the
# arguments becomes the run's label.  Rank 0 marks each run in its stdout;
# every rank reports, per run, its launches, its peak device memory and its
# traffic: the bytes of
# each window batch it handed to ``gather_windows``'s all-gather (none
# since the exact stage is sharded), the sharded exact stage's traffic
# list (where the package has it, so the script also measures a checkout
# from before the sharded exact stage) and the process group's backend.
MH_RANK = r"""
import json, sys
import torch
from approx_counter_tpu_torch.__main__ import run
from approx_counter_tpu_torch.config.cli import resolve_params
from approx_counter_tpu_torch.dist import mesh
from approx_counter_tpu_torch.kernels import bpm
gathered = []
allgather_rows = mesh._allgather_rows


def counted(local):
    if local.ndim == 2:
        gathered.append(local.nbytes)
    return allgather_rows(local)


mesh._allgather_rows = counted
sharded = getattr(mesh, "exact_count_select_sharded", None)
mesh.initialize()
rank, rc = mesh.process_index(), 0
try:
    for label, extra in json.loads(sys.argv[1]):
        prm = resolve_params([a.replace("@RUN@", label)
                              for a in sys.argv[2:] + extra])
        if rank == 0:
            print(f"@@ {label}", flush=True)
        bpm.approx_counts.launches = 0
        gathered.clear()
        if sharded is not None:
            sharded.traffic.clear()
        torch.cuda.reset_peak_memory_stats(mesh.rank_device())
        rc = rc or run(prm, mesh.rank_device())
        traffic = json.dumps(dict(
            window_gather=list(gathered),
            exact=None if sharded is None else list(sharded.traffic),
            backend=torch.distributed.get_backend()))
        peak = torch.cuda.max_memory_allocated(mesh.rank_device())
        # one write per report: the ranks share torchrun's stderr
        sys.stderr.write(
            f"[rank {rank}] {label} nfa_sliced launches "
            f"{bpm.approx_counts.launches}\n[rank {rank}] {label} peak "
            f"device memory {peak} B\n[rank {rank}] {label} traffic "
            f"{traffic}\n")
        sys.stderr.flush()
finally:
    torch.distributed.destroy_process_group()
sys.exit(rc)
"""

# A rank of the two-rank run on the CPU: gloo over localhost.
MH_CPU_RANK = r"""
import json, sys
import torch
repo, pid, nproc, port, argv = sys.argv[1:6]
sys.path.insert(0, repo)
torch.set_num_threads(4)
from approx_counter_tpu_torch.config.cli import resolve_params
from approx_counter_tpu_torch.dist import mesh
from approx_counter_tpu_torch.dist.multihost import run_pipeline_multihost
mesh.initialize(f"tcp://127.0.0.1:{port}", int(nproc), int(pid),
                device_type="cpu", timeout=600)
try:
    rc = run_pipeline_multihost(resolve_params(json.loads(argv)),
                                device="cpu")
finally:
    torch.distributed.destroy_process_group()
sys.exit(rc)
"""


def run_group(cmds: list, timeout: float) -> list[tuple[int, str, str]]:
    """Runs the commands at once from the repo root, each in a process
    group of its own, with the repo on ``PYTHONPATH``; returns each one's (rc,
    stdout, stderr).  Every process group is killed on the way out, so no
    rank outlives the phase."""
    import signal

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=REPO,
                              env=env, start_new_session=True) for c in cmds]
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            out.append((p.returncode, so, se))
    finally:
        for p in procs:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shard_fasta(fasta: str, out_dir: str, n: int = 2) -> list[str]:
    """Deals the records of ``fasta`` (two lines each) round-robin into
    ``n`` shard files; returns their paths."""
    with open(fasta, "rb") as f:
        lines = f.read().split(b"\n")
    records = [lines[i] + b"\n" + lines[i + 1] + b"\n"
               for i in range(0, len(lines) - 1, 2)]
    paths = []
    for r in range(n):
        paths.append(f"{out_dir}/shard{r}.fasta")
        with open(paths[-1], "wb") as f:
            f.write(b"".join(records[r::n]))
    return paths


def same_exports(a: str, b: str, n_files: int = 4) -> None:
    """The exports of stems ``a`` and ``b`` (``<stem>_{out,exact}_0.<end>``)
    are byte-equal, and there are ``n_files`` of each."""
    n = 0
    for which in ("start", "end"):
        for kind in ("out", "exact"):
            pa, pb = f"{a}_{kind}_0.{which}", f"{b}_{kind}_0.{which}"
            if os.path.exists(pa) or os.path.exists(pb):
                same_bytes(pa, pb)
                n += 1
    if n != n_files:
        raise AssertionError(f"{a} / {b}: {n} exports, want {n_files}")


def torchrun(nproc: int, *args: str) -> list[str]:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc), *args]


def multihost_argv(shards: str, out_dir: str, stem: str,
                   *extra: str) -> list[str]:
    return [shards, "--multihost", "-o", f"{out_dir}/{stem}_out", "-e",
            f"{out_dir}/{stem}_exact", "--seed", "5", *extra]


def multihost_walls(stdout: str) -> str:
    """The streaming pass and each end's wall from a multihost run's log."""
    sample = per_end_ms(stdout, "Streaming pass",
                        "Number of sequences found")[""]
    per_end = end_seconds(stdout)
    return (f"streaming pass {sample:.1f} ms, start end "
            f"{per_end['start']:.4f} s, end end {per_end['end']:.4f} s")


# the sharded exact stage's profiler ranges, in the order they run
EXACT_RANGES = ("exact local", "exact exchange", "exact owner",
                "exact gather")


def pass_split(path: str) -> dict:
    """Per end pass of a rank's ``--profile`` trace, in ms: the pass's
    wall; the host time of each exact-stage range and, where they ran,
    the time before the first (the upload) and after the last (the
    approximate counts with their all-reduce, the re-rank and the export);
    the host time in each collective op (``c10d::``) by name, the
    ``nfa_sliced`` kernel's device time and the device-busy time."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    on_card = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    out = {}
    for p in ranges:
        if p["name"] not in ("start pass", "end pass"):
            continue
        lo, hi = p["ts"], p["ts"] + p["dur"]

        def inside(e):
            return lo <= e["ts"] and e["ts"] + e.get("dur", 0) <= hi

        row = {"wall": p["dur"] / 1e3}
        exact = [e for e in ranges if e["name"] in EXACT_RANGES
                 and inside(e)]
        for name in EXACT_RANGES:
            row[name] = sum(e["dur"] for e in exact
                            if e["name"] == name) / 1e3
        if exact:
            row["before exact"] = (min(e["ts"] for e in exact) - lo) / 1e3
            row["after exact"] = (hi - max(e["ts"] + e["dur"]
                                           for e in exact)) / 1e3
        comms: dict = {}
        for e in events:
            if (e.get("cat") == "cpu_op" and inside(e)
                    and e.get("name", "").startswith("c10d::")):
                comms[e["name"]] = comms.get(e["name"], 0) + e["dur"] / 1e3
        row["collectives"] = {k: round(v, 4) for k, v in sorted(comms.items())}
        row["nfa_sliced"] = sum(
            e["dur"] for e in events if e.get("cat") == "kernel"
            and "nfa_sliced" in e.get("name", "") and inside(e)) / 1e3
        row["device busy"] = busy_ms(on_card, lo, hi)
        out[p["name"].split()[0]] = {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in row.items()}
    return out


def traffic_lines(n: int, traffic: dict) -> list[str]:
    """Per end, the bytes each rank sends and the owner balance, from the
    ranks' traffic reports of one run (``{rank: report}``).  The window
    all-gather sends the rank's padded uint8 batch to every other rank;
    the exchange sends 16 B (code and count) per code owned by another
    rank and the R split sizes; the gather sends the padded selection, 16
    B an entry, and its length to every other rank.  The balance is the
    most unique codes a rank owns over the mean."""
    lines = []
    for end in range(2):
        sent = {}
        for r in range(n):
            rep = traffic[r]
            b = {}
            if rep["window_gather"]:
                b["window all-gather"] = (rep["window_gather"][end]
                                          + 8) * (n - 1)
            if rep["exact"]:
                ex = rep["exact"][end]
                b["exchange"] = 16 * ex["sent"] + 8 * n
                b["gather"] = (16 * ex["gathered"] // n + 8) * (n - 1)
            sent[r] = b
        line = (f"{('start', 'end')[end]} end: bytes sent per rank "
                f"{json.dumps(sent)}")
        exact = [traffic[r]["exact"] for r in range(n)]
        if all(exact):
            owned = [e[end]["owned"] for e in exact]
            local = [e[end]["local"] for e in exact]
            line += (f"; unique codes counted per rank {local}, owned "
                     f"{owned}, owner balance (max / mean) "
                     f"{max(owned) / (sum(owned) / n):.4f}")
        lines.append(line)
    return lines


def multihost_measure(n: int, shards: str, out_dir: str, stem: str,
                      extra: tuple = ()) -> int:
    """``n`` ranks under torchrun, rank r on cuda:{r % cards}: the run
    cold, warm and once more under ``--profile``, then the ``extra`` runs
    (``[label, CLI arguments]``).  Logs each run's walls from rank 0's log
    and each rank's peak device memory, each rank's per-end split from its
    trace, the bytes each rank sends, the owner balance and the transport.
    Returns the warm run's nfa_sliced launches over all ranks."""
    import torch

    cards = torch.cuda.device_count()
    backend = "nccl" if n <= cards else "gloo"
    script = f"{out_dir}/mh_rank.py"
    with open(script, "w") as f:
        f.write(MH_RANK)
    prof = f"{out_dir}/{stem}_trace"
    runs = [["cold", []], ["warm", []], ["profile", ["--profile", prof]],
            *extra]
    (rc, stdout, stderr), = run_group(
        [torchrun(n, script, json.dumps(runs),
                  *multihost_argv(shards, out_dir, f"{stem}_@RUN@"))], 600)
    got = {(int(r), run): int(c) for r, run, c in re.findall(
        r"\[rank (\d+)\] (\w+) nfa_sliced launches (\d+)", stderr)}
    timed = sorted(c for (_, run), c in got.items()
                   if run in ("cold", "warm", "profile"))
    if rc != 0 or timed != [2] * (3 * n):
        raise AssertionError(f"torchrun, {n} ranks: rc {rc}, launches {got}:"
                             f"\n{stdout[-3000:]}\n{stderr[-3000:]}")
    decode = json.JSONDecoder().raw_decode
    traffic = {(int(r), run): decode(t)[0] for r, run, t in re.findall(
        r"\[rank (\d+)\] (\w+) traffic (\{.*)", stderr)}
    peak = {(int(r), run): int(b) for r, run, b in re.findall(
        r"\[rank (\d+)\] (\w+) peak device memory (\d+) B", stderr)}
    logs = dict(re.findall(r"@@ (\w+)\n(.*?)(?=@@ |\Z)", stdout, re.S))
    for label, _ in runs:
        log(f"[multihost] {n} ranks on {min(n, cards)} card(s) {label} "
            f"(torchrun, {backend} for CUDA tensors): rc 0, launches per rank "
            f"{[got[(r, label)] for r in range(n)]}, peak device memory per "
            f"rank {[peak[(r, label)] for r in range(n)]} B, "
            f"{multihost_walls(logs[label])}")
    groups = {traffic[(r, "warm")]["backend"] for r in range(n)}
    log(f"[multihost] {n} ranks: process group backend {sorted(groups)}, "
        f"CUDA tensors over {backend}"
        + (" (staged through the host by gloo)" if backend == "gloo" else
           " (on the cards)"))
    for line in traffic_lines(n, {r: traffic[(r, "warm")] for r in range(n)}):
        log(f"[multihost] {n} ranks, warm, {line}")
    for r in range(n):
        for end, row in pass_split(f"{prof}/trace.rank{r}.json").items():
            log(f"[multihost] {n} ranks, profiled run, rank {r}, {end} pass "
                f"(ms): {json.dumps(row)}")
    same_exports(f"{out_dir}/{stem}_cold", f"{out_dir}/{stem}_warm")
    same_exports(f"{out_dir}/{stem}_profile", f"{out_dir}/{stem}_warm")
    return sum(got[(r, "warm")] for r in range(n))


def ranks_vs_cpu(n: int, shards: str, out_dir: str) -> int:
    """``multihost_measure`` at ``n`` ranks, against the same ``n`` ranks
    on the CPU (gloo): exports byte-equal.  Returns the warm run's
    nfa_sliced launches over all ranks."""
    stem = f"mh{n}"
    launches = multihost_measure(n, shards, out_dir, stem)
    port = free_port()
    t0 = time.perf_counter()
    results = run_group([[sys.executable, "-c", MH_CPU_RANK, REPO, str(pid),
                          str(n), str(port),
                          json.dumps(multihost_argv(shards, out_dir,
                                                    f"{stem}_cpu"))]
                         for pid in range(n)], 900)
    for rc, so, se in results:
        if rc != 0:
            raise AssertionError(f"{n} CPU ranks: rc {rc}:\n{se[-3000:]}")
    same_exports(f"{out_dir}/{stem}_warm", f"{out_dir}/{stem}_cpu")
    log(f"[multihost] {n} ranks: exports == the same {n} ranks on the CPU "
        f"(gloo; {time.perf_counter() - t0:.1f} s), 4 files")
    return launches


def phase_multihost(fasta: str, out_dir: str) -> dict:
    """Phase 13: --multihost on the card over two round-robin shards of the
    FASTA.  Returns the nfa_sliced launches of its warm runs by path."""
    import torch

    from approx_counter_tpu_torch.config.cli import resolve_params
    from approx_counter_tpu_torch.dist.multihost import run_pipeline_multihost

    shards = ",".join(shard_fasta(fasta, out_dir))

    def argv(stem: str, *extra: str) -> list[str]:
        return multihost_argv(shards, out_dir, stem, *extra)

    # (a) one rank through the CLI, cold then warm; the CPU at one rank
    for label in ("cold", "warm"):
        reset_launch_counts()
        rc, stdout = run_cli(argv(f"mh1_{label}"))
        launches = launch_counts()["nfa_sliced"]
        if rc != 0 or launches != 2:
            raise AssertionError(f"--multihost, one rank, {label}: rc {rc}, "
                                 f"{launches} launches:\n{stdout}")
        log(f"[multihost] one rank {label} (CLI, cuda:0): rc 0, launches "
            f"{launches}, {multihost_walls(stdout)}")
    for which, adapter in ADAPTERS:
        for kind in ("out", "exact"):
            check_top(f"{out_dir}/mh1_warm_{kind}_0.{which}", adapter, 500)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = run_pipeline_multihost(resolve_params(argv("mh1_cpu")),
                                    device=torch.device("cpu"))
    if rc != 0:
        raise AssertionError(f"run_pipeline_multihost on the CPU: rc {rc}")
    same_exports(f"{out_dir}/mh1_warm", f"{out_dir}/mh1_cpu")
    log(f"[multihost] one rank: exports == run_pipeline_multihost(device="
        f"'cpu') on the same shards (4 files, adapters on top; CPU run "
        f"{time.perf_counter() - t0:.1f} s)")

    # (b) two ranks sharing the card under torchrun (gloo)
    two_ranks = ranks_vs_cpu(2, shards, out_dir)

    # (c) identity sampling: one rank, two ranks (the CLI itself under
    # torchrun, profiled) and --stream on the unsplit file
    reset_launch_counts()
    rc, stdout = run_cli(argv("id1", "-sn", "60000"))
    id_launches = launch_counts()["nfa_sliced"]
    if rc != 0 or id_launches != 2:
        raise AssertionError(f"identity, one rank: rc {rc}, {id_launches}")
    prof = f"{out_dir}/mh_profile"
    (rc, so, se), = run_group([torchrun(
        2, "-m", "approx_counter_tpu_torch", *argv("id2", "-sn", "60000"),
        "--profile", prof)], 600)
    if rc != 0:
        raise AssertionError(f"torchrun -m approx_counter_tpu_torch: rc {rc}"
                             f"\n{so[-3000:]}\n{se[-3000:]}")
    traced, busy = {}, {}
    for r in (0, 1):
        _, sliced, _, busy[r], _ = read_trace(f"{prof}/trace.rank{r}.json")
        traced[r] = len(sliced)
    if traced != {0: 2, 1: 2}:
        raise AssertionError(f"per-rank traces: nfa_sliced kernels {traced}")
    log(f"[multihost] -sn 60000, two ranks on cuda:0 under --profile: device "
        f"busy per end pass, rank 0 {busy[0]}, rank 1 {busy[1]}")
    reset_launch_counts()
    rc, stdout = run_cli([fasta, "--stream", "-sn", "60000", "-o",
                          f"{out_dir}/idst_out", "-e", f"{out_dir}/idst_exact",
                          "--seed", "5"])
    if rc != 0 or launch_counts()["nfa_sliced"] != 2:
        raise AssertionError(f"identity --stream: rc {rc}")
    same_exports(f"{out_dir}/id1", f"{out_dir}/id2")
    same_exports(f"{out_dir}/id1", f"{out_dir}/idst")
    log(f"[multihost] -sn 60000 (every read eligible): one rank, two ranks "
        f"(torchrun -m approx_counter_tpu_torch --profile: nfa_sliced kernels "
        f"per rank trace {traced}) and --stream on the unsplit file: 4 "
        f"exports byte-equal")
    return {"multihost, one rank": launches,
            "multihost, two ranks": two_ranks,
            "multihost -sn 60000, one rank": id_launches}


def pass_walls(stdout: str) -> list[float]:
    """ms of each pass of a CLI log, in order: from its 'Working on
    sequence' line to its 'Done'."""
    out, t0 = [], None
    for _, text, ms in log_lines(stdout):
        if text.startswith("Working on sequence"):
            t0 = ms
        elif text == "Done" and t0 is not None:
            out.append(round(ms - t0, 4))
            t0 = None
    return out


def stats_tags(stdout: str) -> list[bool]:
    """Per ``[stats]`` line of a -v 2 log: does it carry ``(pipelined)``?"""
    return [" (pipelined)" in line for line in stdout.splitlines()
            if "[stats]" in line]


def same_run_exports(a: str, b: str, n_runs: int) -> None:
    """Every ``<stem>_{out,exact}_<run>.<end>`` of stems ``a`` and ``b``
    byte-equal, 4 per run."""
    for run in range(n_runs):
        for which in ("start", "end"):
            for kind in ("out", "exact"):
                same_bytes(f"{a}_{kind}_{run}.{which}",
                           f"{b}_{kind}_{run}.{which}")


def exports_digest(stem: str) -> str:
    """sha256 over every ``<stem>_*`` export and its name past the stem, in
    name order: equal digests from two checkouts mean byte-equal exports."""
    import glob
    import hashlib

    h = hashlib.sha256()
    for path in sorted(glob.glob(f"{stem}_*")):
        h.update(path[len(stem):].encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def upload_ms(fn, reps: int = 20) -> float:
    """Median host ms of ``fn()`` up to a synchronized card."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_dispatch(fasta: str, out_dir: str) -> dict:
    """Phase 14: the dispatch path.  (a) -mr 3 -v 2 at the defaults with
    --device-pool on, off and auto: exports byte-equal across the three,
    the pool used by on and auto and not by off, ``(pipelined)`` on every
    pass but the first, per-pass walls.  (b) -sn 3000 -mr 2 with the pool
    on against ``run_pipeline`` on the CPU: byte-equal.  (c) The upload
    alone on a default end batch: the sampler's native gather against a
    strided view (equal rows, ms), ``device_windows`` sparse, dense (the
    batch given 5,000 Ns, so past the 4,096 of the sparse list) and the raw
    uint8 copy and transpose: each byte-equal to the batch, ms, and the
    sparse upload's parts.  Returns the kernel launches of (a) by run."""
    import torch

    from approx_counter_tpu_torch import pipeline
    from approx_counter_tpu_torch.config.cli import resolve_params
    from approx_counter_tpu_torch.core.codec import BASE_N, NCAP
    from approx_counter_tpu_torch.io.fastx import read_fastx
    from approx_counter_tpu_torch.params import Params
    from approx_counter_tpu_torch.sample.sampler import (
        gather_rows,
        sample_windows,
    )

    seen = {"pool": 0, "dense": 0}
    start_pool, pack_dense = (pipeline.Engine.start_pass_pool,
                              pipeline.pack_windows_host)

    def pool_pass(self, *a, **kw):
        seen["pool"] += 1
        return start_pool(self, *a, **kw)

    def dense(*a, **kw):
        seen["dense"] += 1
        return pack_dense(*a, **kw)

    def cli(stem, *extra):
        return run_cli([fasta, "-o", f"{out_dir}/{stem}_out", "-e",
                        f"{out_dir}/{stem}_exact", "--seed", "5", *extra])

    pipeline.Engine.start_pass_pool = pool_pass
    pipeline.pack_windows_host = dense
    launches = {}
    try:
        for mode in ("on", "off", "auto"):
            reset_launch_counts()
            seen.update(pool=0, dense=0)
            t0 = time.perf_counter()
            rc, stdout = cli(f"mr3{mode}", "-mr", "3", "-v", "2",
                             "--device-pool", mode)
            wall = time.perf_counter() - t0
            n = launch_counts()["nfa_sliced"]
            launches[f"-mr 3 --device-pool {mode}"] = n
            tags = stats_tags(stdout)
            if rc != 0 or n != 6:
                raise AssertionError(f"-mr 3 --device-pool {mode}: rc {rc}, "
                                     f"{n} launches\n{stdout[-2000:]}")
            if seen["pool"] != (0 if mode == "off" else 6):
                raise AssertionError(f"--device-pool {mode}: {seen['pool']} "
                                     f"pool passes")
            if tags != [False] + [True] * 5:
                raise AssertionError(f"--device-pool {mode}: tags {tags}")
            if mode != "on":
                same_run_exports(f"{out_dir}/mr3on", f"{out_dir}/mr3{mode}", 3)
            log(f"[dispatch] -mr 3 -v 2 --device-pool {mode}: rc 0, 6 "
                f"launches, {seen['pool']} pool passes, "
                f"{seen['dense']} dense uploads (the pool's own build "
                f"included), (pipelined) on passes 2-6; per-pass walls "
                f"{pass_walls(stdout)} ms, whole CLI {wall:.4f} s")
        log("[dispatch] -mr 3: exports byte-equal with the pool on, off and "
            "auto (12 files each)")

        seen.update(pool=0, dense=0)
        rc, _ = cli("mr2gpu", "-sn", "3000", "-mr", "2", "--device-pool",
                    "on")
        if rc != 0 or seen["pool"] != 4:
            raise AssertionError(f"-sn 3000 -mr 2 on the card: rc {rc}, "
                                 f"{seen['pool']} pool passes")
        prm = resolve_params([fasta, "-o", f"{out_dir}/mr2cpu_out", "-e",
                              f"{out_dir}/mr2cpu_exact", "--seed", "5",
                              "-sn", "3000", "-mr", "2"])
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = pipeline.run_pipeline(prm, device=torch.device("cpu"))
        if rc != 0:
            raise AssertionError(f"CPU run_pipeline -sn 3000 -mr 2: rc {rc}")
        same_run_exports(f"{out_dir}/mr2gpu", f"{out_dir}/mr2cpu", 2)
        log(f"[dispatch] -sn 3000 -mr 2: the card's pool run byte-equal to "
            f"run_pipeline on the CPU (8 files; CPU "
            f"{time.perf_counter() - t0:.1f} s)")
    finally:
        pipeline.Engine.start_pass_pool = start_pool
        pipeline.pack_windows_host = pack_dense

    # (c) the upload alone, on a default end batch
    reads = read_fastx(fasta)
    batch = sample_windows(reads, 40000, 100, end=True,
                           rng=np.random.default_rng(5), pad_to=1)
    wins, n_valid = batch.windows, batch.n_valid
    starts = reads.offsets[batch.chosen + 1] - 1 - 100
    rows = np.lib.stride_tricks.sliding_window_view(reads.buf, 101)
    out = np.full_like(wins, 5)
    gather_rows(reads.buf, starts, 101, out)
    if not (np.array_equal(out, wins) and np.array_equal(rows[starts], wins)):
        raise AssertionError("gather_rows != the strided view's rows")
    gathers = {}
    for name in ("native", "strided", "strided", "native"):
        if name == "native":
            t = upload_ms(lambda: gather_rows(reads.buf, starts, 101, out))
        else:
            t = upload_ms(lambda: rows[starts])
        gathers.setdefault(name, []).append(round(t, 4))
    engine = pipeline.Engine(Params(), torch.device("cuda"))
    many_n = wins.copy()
    rng = np.random.default_rng(14)
    many_n[rng.integers(0, n_valid, 5000), rng.integers(0, 101, 5000)] = BASE_N
    if (many_n[:n_valid] == BASE_N).sum() <= NCAP:
        raise AssertionError("the forced dense batch has too few Ns")
    uploads = {}
    for what, b in (("sparse" if (wins == BASE_N).sum() <= NCAP
                     else "dense (its own Ns)", wins), ("dense", many_n)):
        got, mask = engine.device_windows(b, n_valid)
        if not (np.array_equal(got.cpu().numpy(), b.T)
                and int(mask.sum()) == n_valid):
            raise AssertionError(f"device_windows {what}: not the batch")
        uploads[what] = round(upload_ms(
            lambda b=b: engine.device_windows(b, n_valid)), 4)
    raw = upload_ms(lambda: torch.from_numpy(wins).to("cuda").t().contiguous())
    packed = pipeline.pack_windows_sparse_native(wins, n_valid, 101, NCAP)
    parts = {
        "native pack": upload_ms(lambda: pipeline.pack_windows_sparse_native(
            wins, n_valid, 101, NCAP)),
        "pinned copy + H2D": upload_ms(lambda: engine._upload(*packed)),
        "unpack": upload_ms(lambda: pipeline.unpack_windows_sparse_t(
            *engine._upload(*packed), n_valid, 101, 101)),
    }
    parts["unpack"] -= parts["pinned copy + H2D"]
    build = upload_ms(lambda: engine.build_pool(reads, 100), reps=5)
    pool = engine._pool
    shipped = {"raw": wins.nbytes, "sparse": sum(a.nbytes for a in packed),
               "pool index": pipeline.pool_index(
                   pool["inv"], batch.chosen, n_valid, pool["E"]).nbytes}
    log(f"[dispatch] upload of one end batch [{wins.shape[0]}, 101], "
        f"{int((wins == BASE_N).sum())} Ns: gather ms native / strided view "
        f"{gathers} (rows equal); device_windows ms {uploads} (each "
        f"byte-equal to the batch; the forced one has "
        f"{int((many_n[:n_valid] == BASE_N).sum())} Ns), the sparse one's "
        f"parts {json.dumps({k: round(v, 4) for k, v in parts.items()})}; "
        f"raw uint8 copy + transpose {raw:.4f} ms; bytes shipped per pass "
        f"{shipped}; pool build ({pool['E']} rows, both ends) {build:.4f} ms")

    return launches


def main_walls(rounds: int) -> None:
    """``--walls R``: the dispatch path's walls, R rounds."""
    walls: dict = {}
    digest: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "reads.fasta")
        write_fasta(fasta, 50000, seed=5)
        for r in range(rounds):
            for name, tag, extra in (
                    ("default", "d", ()),
                    ("-mr 3 pool off", "off", ("-mr", "3", "--device-pool",
                                                "off")),
                    ("-mr 3 pool auto", "auto", ("-mr", "3", "--device-pool",
                                                 "auto"))):
                stem = f"{tmp}/{tag}{r}"
                t0 = time.perf_counter()
                rc, stdout = run_cli([fasta, "-o", f"{stem}_out", "-e",
                                      f"{stem}_exact", "--seed", "5", "-v",
                                      "2", *extra])
                wall = time.perf_counter() - t0
                if rc != 0:
                    raise AssertionError(f"{name}: rc {rc}\n{stdout[-2000:]}")
                if r:
                    same_run_exports(f"{tmp}/{tag}0", stem, 3 if extra else 1)
                else:
                    digest[name] = exports_digest(stem)
                walls.setdefault(name, []).append(
                    {"passes_ms": pass_walls(stdout), "cli_s": round(wall, 4)})
    if digest["-mr 3 pool off"] != digest["-mr 3 pool auto"]:
        raise AssertionError("-mr 3: the pool changed the exports")
    log(f"[walls] exports sha256 {json.dumps(digest)}")
    log(f"[walls] {json.dumps(walls)}")


def main_ranks(n: int) -> int:
    """``--ranks N``: phase 13 (b) alone at N ranks, one card each."""
    import torch

    if torch.cuda.device_count() < n:
        raise AssertionError(f"--ranks {n}: {torch.cuda.device_count()} "
                             f"cards")
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "reads.fasta")
        write_fasta(fasta, 50000, seed=5)
        launches = ranks_vs_cpu(n, ",".join(shard_fasta(fasta, tmp, n)), tmp)
    log(f"[multihost] --ranks {n}: nfa_sliced launches {launches}")
    return 0


def main_split(n: int) -> int:
    """``--split N``: the default multihost run at N ranks on
    min(N, cards) cards over N shards, measured as phase 13 (b) measures
    it, with no CPU comparison; a sha256 of the warm and the -sk 1 run's
    exports, to compare two checkouts."""
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "reads.fasta")
        write_fasta(fasta, 50000, seed=5)
        launches = multihost_measure(
            n, ",".join(shard_fasta(fasta, tmp, n)), tmp, f"split{n}",
            (["sk1", ["-sk", "1"]],))
        digest = {label: exports_digest(f"{tmp}/split{n}_{label}")
                  for label in ("warm", "sk1")}
    log(f"[multihost] --split {n}: nfa_sliced launches {launches}, exports "
        f"sha256 {json.dumps(digest)}")
    return 0


def ok_line() -> str:
    import torch

    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=0,
                    help="run only phase 13's ranks-vs-CPU check at N ranks, "
                         "one card each")
    ap.add_argument("--walls", type=int, default=0,
                    help="run only R rounds of the dispatch path's walls")
    ap.add_argument("--split", type=int, default=0,
                    help="run only the multihost measurement at N ranks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import approx_counter_tpu_torch  # noqa: F401  (fails outside the repo)

    log(card_line())
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} card(s)")
    mode = ((main_ranks, args.ranks) if args.ranks else
            (main_walls, args.walls) if args.walls else
            (main_split, args.split) if args.split else None)
    if mode:
        from approx_counter_tpu_torch.kernels._build import (
            host_build,
            nfa_sliced_build,
        )

        nfa_sliced_build(16, MAIN["maxerr"])
        host_build("fastx_parser")
        mode[0](mode[1])
        print(ok_line())
        return 0
    clock_hz = max_sm_clock_hz()
    log(f"[env] max SM clock {clock_hz / 1e6:g} MHz")
    builds = phase_build()
    entries = {"nfa_sliced": phase_kernel(builds, clock_hz)}
    entries.update(phase_alternates(builds, clock_hz, entries["nfa_sliced"]))
    bench_launches = phase_bench(entries["nfa_sliced"])
    phase_searchscheme()
    phase_limit(builds, clock_hz)
    phase_alt_limit(builds, clock_hz)
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "reads.fasta")
        t0 = time.perf_counter()
        write_fasta(fasta, 50000, seed=5)
        log(f"[data] 50,000 synthetic reads written in "
            f"{time.perf_counter() - t0:.2f} s")
        # each kernel's launches by path, each path's counted from 0
        paths = {"nfa_sliced": {"default run":
                                phase_main_path(fasta, tmp, 16),
                                "bench": bench_launches}}
        phase_main_path(fasta, tmp, 32)
        for k in (16, 17, 32):
            phase_parity(fasta, tmp, k)
        phase_parity(fasta, tmp, 16, ("-sk", "2"), "sk2")
        phase_parity(fasta, tmp, 16, ("--from-exact",
                                      f"{tmp}/k16_warm_exact_0.start"),
                     "resume")
        phase_parity(fasta, tmp, 16, ("--stream",), "stream")
        phase_solid(fasta, tmp, builds, clock_hz)
        phase_resume(fasta, tmp)
        phase_stream(fasta, tmp)
        phase_profile(fasta, tmp)
        paths["nfa_sliced"].update(phase_multihost(fasta, tmp))
        paths["nfa_sliced"].update(phase_dispatch(fasta, tmp))
    checks = phase_gpu_check()
    for name in ("bpm_myers", "bpm_packed", "nfa_packed"):
        paths[name] = {"gpu_check": checks[name]}
    entries["sort_stage"], probe_launches = phase_sort_stage(builds, clock_hz)
    paths["sort_stage"] = {"probe": probe_launches}
    log(f"[launches] by path: {json.dumps(paths)}")
    log(card_line())  # again beside the numbers, where a kept tail holds it
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1],
         "launches": sum(paths[name].values()), **entries[name],
         "library_ms": None}
        for name in KERNELS
    ]}))
    print(ok_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
