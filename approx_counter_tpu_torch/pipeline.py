"""End-to-end pipeline orchestrator.

Port of ``approx_counter_tpu/pipeline.py`` for the in-memory top-N run.
Mirrors the reference's ``main()`` loop (approx_counter.cpp:679-957):
parameter echo, FASTA/FASTQ parse, then for each run x each end {start,
end}: sample -> exact count -> selection -> optional exact export ->
approximate count -> re-rank -> export.  File naming reproduces the
reference: outputs always get a ``_<run>`` suffix plus ``.start`` / ``.end``,
and ``sn`` is clamped to the read count by *mutation* that persists across
runs/ends (:844-848).

Each pass ships the raw uint8 window batch to the device and runs there
eagerly: the exact stage as torch ops, the approximate counts through the
CUDA kernel (``kernels/bpm.py``).  Passes run one after another; the JAX
package's pass pipelining changes no bytes of output, and neither does its
absence.

skip_end: the reference's break sits inside ``if(mr_v>0)``
(approx_counter.cpp:943-948), so muted runs process the end anyway -- and
``bottom = true`` sits in the *else* of ``if(skip_end)`` (:950-952), so that
second pass re-samples the START and exports those counts under ``.end``.
We implement the intended skip unless ``compat_quirks`` asks for the bug.

Every k of the reference, 2 to 32, runs: codes are int64 tensors holding
the uint64 bits.  The JAX package's ``--stream``, ``--from-exact``,
``--multihost``, solid mode (``-sk``) and ``--profile`` are not yet ported:
they exit 1 with an error.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from approx_counter_tpu_torch.core.complexity import lc_sum_threshold
from approx_counter_tpu_torch.count.approx import rank_with_zero_counts
from approx_counter_tpu_torch.count.exact import exact_count_select
from approx_counter_tpu_torch.io.export import export_counter
from approx_counter_tpu_torch.io.fastx import read_fastx
from approx_counter_tpu_torch.io.kmer_list import parse_kmer_list
from approx_counter_tpu_torch.io.logging import Log, error, warn
from approx_counter_tpu_torch.kernels.bpm import approx_counts, build_peq
from approx_counter_tpu_torch.params import Params
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
                          exact_sel, approx_sel) -> bool:
    """Per-end tail of the reference main loop (approx_counter.cpp:874-934):
    had_n warning, selection log lines, exact + approx export.  Returns
    False after an export failure (the caller exits 1)."""
    had_n_warning(stats["had_n"])
    if mr_v > 0:
        log(f"Number of kmer found: {stats['n_unique']}", tab_level)
        log("Keeping most frequent k-mer", tab_level)
        log(f"Number of kmer kept:  {stats['n_keep']}", tab_level)

    exact_codes, exact_counts = exact_sel
    approx_codes, approx_counts_ = approx_sel
    if prm.exact_out:
        if mr_v > 0:
            log("Exporting exact kmer count", tab_level)
        path = prm.exact_out + run_suffix + "." + which_end
        if not export_counter(exact_codes, exact_counts, prm.k, path):
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
    if not export_counter(approx_codes, approx_counts_, prm.k, path):
        error("Failed to export approximate k-mer count")
        sys.stderr.write(f"Path: {path}\n")
        return False

    if mr_v > 0:
        log("Done", tab_level)
    return True


def unsupported_flag(prm: Params) -> str | None:
    """The first flag set in ``prm`` that this port does not run yet."""
    if prm.stream:
        return "--stream"
    if prm.from_exact:
        return "--from-exact"
    if prm.multihost:
        return "--multihost"
    if prm.solid_km != 0:
        return "-sk"
    if prm.profile_dir:
        return "--profile"
    return None


class Engine:
    """Device-side counting for one parameter set on one device."""

    def __init__(self, prm: Params, device):
        self.prm = prm
        self.device = torch.device(device)
        self.lc_sum_thr = lc_sum_threshold(prm.adjusted_lc, prm.k)
        codes = (parse_kmer_list(prm.forbid_kmer) if prm.forbid_kmer
                 else np.empty(0, np.uint64))
        self.forbidden = torch.from_numpy(codes.view(np.int64)).to(self.device)

    def count_one_end(self, windows: np.ndarray, n_valid: int):
        """One pass over a sampled batch (uint8 ``[n, m]``, rows past
        ``n_valid`` are padding).  Returns ``(exact_sel, approx_sel,
        stats)``: (codes, counts) uint64 numpy pairs in CompareCount order
        and the counters the log lines print."""
        prm = self.prm
        windows_t = torch.from_numpy(windows).to(self.device).t().contiguous()
        row_mask = torch.arange(windows.shape[0], device=self.device) < n_valid
        ex = exact_count_select(windows_t, row_mask, prm.k, self.lc_sum_thr,
                                self.forbidden, prm.limit)
        peq = build_peq(ex["sel_codes"], prm.k)
        counts = approx_counts(peq, windows_t, row_mask, prm.k,
                               maxerr=prm.max_error)
        a_codes, a_counts = rank_with_zero_counts(ex["sel_codes"], counts, prm.k)

        def host(codes, counts):
            return (codes.cpu().numpy().view(np.uint64),
                    counts.cpu().numpy().astype(np.uint64))

        stats = dict(n_unique=ex["n_unique"], n_keep=ex["n_keep"],
                     had_n=ex["had_n"])
        return (host(ex["sel_codes"], ex["sel_counts"]),
                host(a_codes, a_counts), stats)


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
    flag = unsupported_flag(prm)
    if flag is not None:
        error(f"{flag} is not yet supported by the PyTorch port")
        return 1

    engine = Engine(prm, device)

    # Parameter echo (approx_counter.cpp:793-808).
    echo_params(prm, v)

    tab_level = 0
    if v > 0 and prm.nb_of_runs > 1:
        print(f"\nA total of {prm.nb_of_runs} runs will be performed.")

    if v > 0:
        log("Parsing FASTA file", tab_level)
    reads = read_fastx(prm.input_file)
    if v > 0:
        log(f"Number of sequences found: {len(reads)}.", tab_level)

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

    for current_run in range(prm.nb_of_runs):
        run_suffix = f"_{current_run}"
        if prm.nb_of_runs > 1 and v > 0:
            print(f"Starting run number {current_run + 1}")

        n_reads = len(reads)
        if sn > n_reads:  # clamp-by-mutation quirk (:844-848)
            warn("Sequence set too small for the requested sample size")
            warn("The whole set will be used.")
            sn = n_reads

        tab_level += 1
        for which_end in ("start", "end"):
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
            batch = sample_windows(reads, sn, prm.sl, end=bottom, rng=rng,
                                   pad_to=1, v=mr_v)
            t_sample = time.perf_counter() - t_sample
            if mr_v > 0:
                log(f"Sampled {batch.n_valid} sequences", tab_level)
                log("Exact k-mer count", tab_level)
            t_count = time.perf_counter()
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
            if not report_and_export_end(
                prm, log, mr_v, tab_level, run_suffix, which_end, stats,
                exact_sel, approx_sel,
            ):
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
