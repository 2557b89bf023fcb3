"""End-to-end pipeline orchestrator.

Port of ``approx_counter_tpu/pipeline.py`` for one device.  Mirrors the
reference's ``main()`` loop (approx_counter.cpp:679-957): parameter echo,
FASTA/FASTQ parse, then for each run x each end {start, end}: sample ->
exact count -> selection -> optional exact export -> approximate count ->
re-rank -> export.  File naming reproduces the reference: outputs always get
a ``_<run>`` suffix plus ``.start`` / ``.end``, and ``sn`` is clamped to the
read count by *mutation* that persists across runs/ends (:844-848).

Each pass ships the raw uint8 window batch to the device and runs there
eagerly: the exact stage as torch ops, the approximate counts through the
CUDA kernel (``kernels/bpm.py``).  Passes run one after another; the JAX
package's pass pipelining changes no bytes of output, and neither does its
absence.  Each end runs inside a ``torch.profiler.record_function`` range
named ``"<end> pass"``, so a ``--profile`` trace shows where each end
begins and ends.

Selection is the reference's top-``limit`` or, with ``-sk N``, solid mode:
every passing k-mer counted N times or more, all of them exported exactly
and the approximate ranking cut to ``limit``.  The JAX package's extensions
run too: ``--stream`` (no parse up front; a reservoir pass over the file at
the top of every run, ``io/stream.py``) and ``--from-exact`` (every pass
scores the codes of a prior exact export against its own windows, and no
exact export is written).

skip_end: the reference's break sits inside ``if(mr_v>0)``
(approx_counter.cpp:943-948), so muted runs process the end anyway -- and
``bottom = true`` sits in the *else* of ``if(skip_end)`` (:950-952), so that
second pass re-samples the START and exports those counts under ``.end``.
We implement the intended skip unless ``compat_quirks`` asks for the bug.

Every k of the reference, 2 to 32, runs: codes are int64 tensors holding
the uint64 bits.  ``--multihost`` runs the orchestrator of
``dist/multihost.py`` instead, which shares this module's echo, ``Engine``
and per-end tail.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from approx_counter_tpu_torch.core.complexity import lc_sum_threshold
from approx_counter_tpu_torch.count.approx import rank_with_zero_counts
from approx_counter_tpu_torch.count.exact import exact_count_select
from approx_counter_tpu_torch.io.export import (
    export_counter,
    parse_exact_export,
)
from approx_counter_tpu_torch.io.fastx import read_fastx
from approx_counter_tpu_torch.io.kmer_list import parse_kmer_list
from approx_counter_tpu_torch.io.logging import Log, error, warn
from approx_counter_tpu_torch.kernels.bpm import approx_counts, build_peq
from approx_counter_tpu_torch.params import Params
from approx_counter_tpu_torch.io.stream import stream_sample_windows
from approx_counter_tpu_torch.sample.sampler import sample_windows


def _fmt_num(x: float) -> str:
    """C++ default stream float formatting (6 significant digits)."""
    return f"{x:.6g}"


def echo_params(prm: Params, v: int) -> None:
    """The parameter echo block (approx_counter.cpp:793-808)."""
    if v <= 0:
        return
    print(f"Kmer size:             {prm.k}")
    print(f"Sampled sequences:     {prm.sn}")
    print(f"Sampling length        {prm.sl}")
    print(f"LC filter threshold:   {_fmt_num(prm.param_lc)}")
    print(f"Adjusted LC threshold: {_fmt_num(prm.adjusted_lc)}")
    print(f"Nb thread:             {prm.nb_thread}")
    if prm.solid_km != 0:
        print(f"Solid kmers:           {prm.solid_km}")
    else:
        print(f"Number of kept kmer:   {prm.limit}")
    print(f"Number of runs:        {prm.nb_of_runs}")
    print(f"Verbosity level:       {v}")


def had_n_warning(had_n: int) -> None:
    """The reference's end-of-count N warning (approx_counter.cpp:513-517),
    emitted to stderr when any k-mer contained an N."""
    if had_n > 0:
        sys.stderr.write(
            "/!\\ WARNING: This dataset contained sequences with 'N' "
            "symbols. /!\\ WARNING: Current implementation ignores "
            "k-mers containing 'N'."
            f"/!\\ WARNING: A total of {had_n} k-mers were "
            "ignored.\n"
        )


def report_and_export_end(prm, log, mr_v: int, tab_level: int,
                          run_suffix: str, which_end: str, stats: dict,
                          exact_sel, approx_sel, resume: bool,
                          is_host0: bool = True) -> bool:
    """Per-end tail of the reference main loop (approx_counter.cpp:874-934):
    had_n warning, selection log lines, exact + approx export (no exact
    export when ``resume``).  Returns False after an export failure (the
    caller exits 1).  ``is_host0`` is False on the multihost orchestrator's
    ranks other than 0, which neither warn nor export (their ``mr_v`` is
    muted too)."""
    if is_host0:
        had_n_warning(stats["had_n"])
    if mr_v > 0:
        log(f"Number of kmer found: {stats['n_unique']}", tab_level)
        log("Keeping solid k-mer" if prm.solid_km
            else "Keeping most frequent k-mer", tab_level)
        log(f"Number of kmer kept:  {stats['n_keep']}", tab_level)

    exact_codes, exact_counts = exact_sel
    approx_codes, approx_counts_ = approx_sel
    if prm.exact_out and not resume:
        if mr_v > 0:
            log("Exporting exact kmer count", tab_level)
        path = prm.exact_out + run_suffix + "." + which_end
        if is_host0 and not export_counter(exact_codes, exact_counts,
                                            prm.k, path):
            error("Failed to export exact k-mer count")
            sys.stderr.write(f"Path: {path}\n")
            return False

    if mr_v > 0:
        log("Approximate k-mer count", tab_level)
        # errorCount's three stage lines (approx_counter.cpp:536-549)
        log("Preparing index", tab_level)
        log("Creating index", tab_level)
        log("Starting approximate counting", tab_level)
        log("Exporting approximate count", tab_level)
    path = prm.output + run_suffix + "." + which_end
    if is_host0 and not export_counter(approx_codes, approx_counts_, prm.k,
                                        path):
        error("Failed to export approximate k-mer count")
        sys.stderr.write(f"Path: {path}\n")
        return False

    if mr_v > 0:
        log("Done", tab_level)
    return True


class Engine:
    """Device-side counting for one parameter set on one device.

    ``counts`` computes the approximate counts (``approx_counts``'s
    arguments and result); the multihost orchestrator passes
    ``dist/mesh.py:approx_counts_sharded``, which sums every rank's."""

    def __init__(self, prm: Params, device, counts=approx_counts):
        self.prm = prm
        self.device = torch.device(device)
        self.counts = counts
        self.lc_sum_thr = lc_sum_threshold(prm.adjusted_lc, prm.k)
        codes = (parse_kmer_list(prm.forbid_kmer) if prm.forbid_kmer
                 else np.empty(0, np.uint64))
        self.forbidden = torch.from_numpy(codes.view(np.int64)).to(self.device)

    def _device_windows(self, windows: np.ndarray, n_valid: int):
        """Host uint8 ``[n, m]`` batch -> (text-major ``[m, n]`` windows on
        the device, bool row mask of the first ``n_valid`` rows)."""
        windows_t = torch.from_numpy(windows).to(self.device).t().contiguous()
        row_mask = torch.arange(windows.shape[0], device=self.device) < n_valid
        return windows_t, row_mask

    def _score(self, codes: torch.Tensor, windows_t, row_mask):
        """Approximate counts of ``codes`` against the windows, re-ranked
        in CompareCount order and cut to ``limit`` (the final resize,
        approx_counter.cpp:923), as host uint64 (codes, counts)."""
        prm = self.prm
        counts = self.counts(build_peq(codes, prm.k), windows_t, row_mask,
                             prm.k, maxerr=prm.max_error)
        a_codes, a_counts = rank_with_zero_counts(codes, counts, prm.k)
        return _host(a_codes[:prm.limit], a_counts[:prm.limit])

    def count_one_end(self, windows: np.ndarray, n_valid: int,
                      exact_batch=None):
        """One pass over a sampled batch (uint8 ``[n, m]``, rows past
        ``n_valid`` are padding).  Returns ``(exact_sel, approx_sel,
        stats)``: (codes, counts) uint64 numpy pairs in CompareCount order
        and the counters the log lines print.  In solid mode the exact
        selection holds every solid k-mer and the approximate one its first
        ``limit``.  ``exact_batch``: a ``(windows, n_valid)`` batch that the
        exact stage counts instead of this one (the multihost step counts
        every rank's windows and scores its own)."""
        prm = self.prm
        windows_t, row_mask = self._device_windows(windows, n_valid)
        if exact_batch is not None:
            ex_t, ex_mask = self._device_windows(*exact_batch)
        else:
            ex_t, ex_mask = windows_t, row_mask
        ex = exact_count_select(ex_t, ex_mask, prm.k, self.lc_sum_thr,
                                self.forbidden, prm.limit, prm.solid_km)
        stats = dict(n_unique=ex["n_unique"], n_keep=ex["n_keep"],
                     had_n=ex["had_n"])
        return (_host(ex["sel_codes"], ex["sel_counts"]),
                self._score(ex["sel_codes"], windows_t, row_mask), stats)

    def approx_stage(self, windows: np.ndarray, n_valid: int,
                     codes: np.ndarray):
        """Resume-mode pass: the uint64 ``codes`` of a prior exact export
        (repeats included) scored against the batch, re-ranked and cut to
        ``limit`` -> host uint64 (codes, counts)."""
        windows_t, row_mask = self._device_windows(windows, n_valid)
        cand = torch.from_numpy(codes.view(np.int64)).to(self.device)
        return self._score(cand, windows_t, row_mask)


def _host(codes: torch.Tensor, counts: torch.Tensor):
    return (codes.cpu().numpy().view(np.uint64),
            counts.cpu().numpy().astype(np.uint64))


def run_pipeline(prm: Params, log: Log | None = None, *, device) -> int:
    """The full CLI run on ``device``.  Returns the process exit code."""
    log = log or Log()
    v = prm.v
    mr_v = prm.mr_v

    if prm.forbid_kmer:
        # (typo "fobidden" preserved from approx_counter.cpp:767)
        log("Parsing the fobidden kmer list")

    try:
        prm.validate()
    except ValueError as e:
        sys.stderr.write(str(e) + "\n")
        return 1

    engine = Engine(prm, device)

    # Parameter echo (approx_counter.cpp:793-808).
    echo_params(prm, v)

    tab_level = 0
    if v > 0 and prm.nb_of_runs > 1:
        print(f"\nA total of {prm.nb_of_runs} runs will be performed.")

    reads = None
    if not prm.stream:
        if v > 0:
            log("Parsing FASTA file", tab_level)
        reads = read_fastx(prm.input_file)
        if v > 0:
            log(f"Number of sequences found: {len(reads)}.", tab_level)
    elif not os.path.exists(prm.input_file):
        raise FileNotFoundError(prm.input_file)

    resume_codes = None
    if prm.from_exact:
        resume_codes = parse_exact_export(prm.from_exact, prm.k)
        if v > 0:
            log(f"Resuming from {len(resume_codes)} exact-count candidates")

    rng = np.random.default_rng(prm.seed)
    sn = prm.sn

    runs_end_pass = (not prm.skip_end) or (
        prm.compat_quirks and mr_v == 0  # reference skip_end bug
    )
    # The faithful bug (approx_counter.cpp:943-953): when the muted break
    # fails to fire, `bottom = true` in the else of if(skip_end) also never
    # executes -- the second pass samples the START again and its counts
    # are exported under `.end`.
    quirk_end_is_start = prm.skip_end and runs_end_pass

    def one_end(which_end: str, stream_batch, run_suffix: str) -> bool:
        """Sample, count, score and export one end; False on an export
        failure."""
        bottom = which_end == "end" and not quirk_end_is_start
        if v > 0:
            log(f"Working on sequence {which_end}.", tab_level - 1)
        if mr_v > 0:
            log("Sampling", tab_level)
            log(
                "Sampling the ends of reads"
                if bottom
                else "Sampling the start of reads",
                tab_level,
            )
        t_sample = time.perf_counter()
        if stream_batch is not None:
            batch = stream_batch
        else:
            batch = sample_windows(reads, sn, prm.sl, end=bottom, rng=rng,
                                   pad_to=1, v=mr_v)
        t_sample = time.perf_counter() - t_sample
        if mr_v > 0:
            log(f"Sampled {batch.n_valid} sequences", tab_level)
            log("Exact k-mer count", tab_level)
        t_count = time.perf_counter()
        if resume_codes is not None:
            approx_sel = engine.approx_stage(batch.windows, batch.n_valid,
                                             resume_codes)
            exact_sel = (resume_codes, np.zeros(len(resume_codes), np.uint64))
            stats = dict(n_unique=len(resume_codes),
                         n_keep=len(resume_codes), had_n=0)
        else:
            exact_sel, approx_sel, stats = engine.count_one_end(
                batch.windows, batch.n_valid
            )
        t_count = time.perf_counter() - t_count
        if mr_v >= 2:
            pairs = stats["n_keep"] * batch.n_valid
            log(
                f"[stats] sample {t_sample * 1e3:.1f} ms | "
                f"count+score {t_count * 1e3:.1f} ms | "
                f"{batch.n_valid / max(t_count, 1e-9):.0f} windows/s | "
                f"{pairs / max(t_count, 1e-9):.3g} pairs/s",
                tab_level,
            )
        return report_and_export_end(
            prm, log, mr_v, tab_level, run_suffix, which_end, stats,
            exact_sel, approx_sel, resume=resume_codes is not None,
        )

    for current_run in range(prm.nb_of_runs):
        run_suffix = f"_{current_run}"
        if prm.nb_of_runs > 1 and v > 0:
            print(f"Starting run number {current_run + 1}")

        stream_batches = {"start": None, "end": None}
        if prm.stream:
            # one reservoir pass over the file per run, the rng carried on
            if mr_v > 0:
                log("Streaming pass (reservoir sampling both ends)", tab_level)
            b_start, b_end, n_reads = stream_sample_windows(
                prm.input_file, sn, prm.sl, rng=rng, pad_to=1,
                end_is_start=quirk_end_is_start, v=mr_v,
            )
            stream_batches = {"start": b_start, "end": b_end}
            if v > 0 and current_run == 0:
                log(f"Number of sequences found: {n_reads}.", tab_level)
        else:
            n_reads = len(reads)

        if sn > n_reads:  # clamp-by-mutation quirk (:844-848)
            warn("Sequence set too small for the requested sample size")
            warn("The whole set will be used.")
            sn = n_reads

        tab_level += 1
        for which_end in ("start", "end"):
            with torch.profiler.record_function(f"{which_end} pass"):
                if not one_end(which_end, stream_batches[which_end],
                               run_suffix):
                    return 1

            if prm.skip_end:
                # Reference bug (compat_quirks): the break sits inside
                # if(mr_v>0), so muted runs process the end anyway.
                if mr_v > 0:
                    log("Skipping end adapter ressearch")
                if not runs_end_pass:
                    break
        tab_level -= 1
    return 0
