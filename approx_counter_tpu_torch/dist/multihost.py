"""The ``--multihost`` orchestrator: one rank per process, each on its own
card or sharing one, joined by ``torch.distributed``.

Port of ``approx_counter_tpu/dist/multihost.py``.  Every rank runs the same
program:

  1. ``dist/mesh.py:initialize`` joins the process group (the CLI does it
     from ``torchrun``'s environment);
  2. ``shard_paths`` deals the comma-separated input files round-robin to
     the ranks (COMPAT M1);
  3. each rank streams its shard through the distributed bottom-k sampler
     (``dist/sampling.py``): a uniform min(sn, N_eligible)-subset of the
     union of eligible reads, whatever the shard sizes;
  4. both ends of the run are dispatched before either is fetched, as the
     JAX orchestrator dispatches them: each is one pass of a sharded engine
     (``Engine(sharded=True)``, the fixed-cap step of ``dist/mesh.py``:
     each rank counts its own windows exactly, each code is summed and
     selected on its owner rank and the selections gathered; the
     approximate counts over this rank's windows with an all-reduce) on
     the engine's worker thread and the passes' own process group; the
     selections and rankings are the same on every rank;
  5. each end is fetched in turn, and rank 0 logs, warns and exports, with
     the single-device pipeline's log lines, warnings, ``--compat-quirks``
     and ``--from-exact``, while the next end counts.

The output equals the JAX package's multihost run on the same shards, seed
and rank count, byte for byte; at one rank it is a one-rank run.  The
divergences of the JAX orchestrator from the single-device pipeline
(COMPAT.md, "Multihost divergences" M1-M5) are kept: the per-rank seeds,
rank 0's output alone, always streaming, and the ``(pipelined)`` tag of the
v >= 2 ``[stats]`` line.  A rank that stops early (an export failure on
rank 0, which every rank learns from a flag all-gather) still waits for
its pass in flight in ``Engine.close``, so no rank leaves a collective
half done.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from approx_counter_tpu_torch.dist.mesh import process_count, process_index
from approx_counter_tpu_torch.dist.sampling import (
    _allgather_rows,
    distributed_sample_windows,
)
from approx_counter_tpu_torch.io.export import parse_exact_export
from approx_counter_tpu_torch.io.logging import Log, warn
from approx_counter_tpu_torch.pipeline import (
    Engine,
    count_and_export_end,
    echo_params,
    end_plan,
    log_end_start,
)
from approx_counter_tpu_torch.tracing import span


def shard_paths(paths: list[str], process_index: int,
                process_count: int) -> list[str]:
    """Deterministic round-robin assignment of input files to this rank."""
    return [p for i, p in enumerate(paths) if i % process_count == process_index]


def run_pipeline_multihost(prm, log: Log | None = None, *, device) -> int:
    """The multihost run on this rank's ``device``; every rank calls it.
    Returns the exit code, the same on every rank.

    ``prm.input_file`` may be a comma-separated list of files; each rank
    streams its round-robin share.  Mirrors the reference main loop
    (approx_counter.cpp:679-957) with the single-device pipeline's log lines.
    """
    log = log or Log()
    pc, pi = process_count(), process_index()
    is_host0 = pi == 0
    # rank 0 carries all user-visible output; control flow uses the unmuted
    # values so every rank runs the same collectives
    v = prm.v if is_host0 else 0
    mr_v = prm.mr_v if is_host0 else 0

    if prm.forbid_kmer and is_host0:
        # (typo "fobidden" preserved from approx_counter.cpp:767)
        log("Parsing the fobidden kmer list")

    try:
        prm.validate()
    except ValueError as e:
        if is_host0:
            sys.stderr.write(str(e) + "\n")
        return 1

    echo_params(prm, v)

    tab_level = 0
    if v > 0 and prm.nb_of_runs > 1:
        print(f"\nA total of {prm.nb_of_runs} runs will be performed.")

    my_paths = shard_paths(prm.input_file.split(","), pi, pc)

    # priority streams must differ per rank (independent uniform keys)
    rng = np.random.default_rng(
        None if prm.seed is None else prm.seed + 1000003 * pi
    )

    resume_codes = None
    if prm.from_exact:
        resume_codes = parse_exact_export(prm.from_exact, prm.k)
        if v > 0:
            log(f"Resuming from {len(resume_codes)} exact-count candidates")

    sn = prm.sn
    # the same plan on every rank: ranks must run the same collectives
    runs_end_pass, quirk_end_is_start = end_plan(prm)
    ends = ("start", "end") if runs_end_pass else ("start",)

    engine = Engine(prm, device, sharded=True)
    try:
        for current_run in range(prm.nb_of_runs):
            run_suffix = f"_{current_run}"
            if prm.nb_of_runs > 1 and v > 0:
                print(f"Starting run number {current_run + 1}")

            if mr_v > 0:
                log("Streaming pass (reservoir sampling both ends)",
                    tab_level)
            t_stream = time.perf_counter()
            with span("sample"):
                b_start, b_end, n_reads, g_counts = (
                    distributed_sample_windows(
                        my_paths, sn, prm.sl, rng=rng, process_count=pc,
                        process_index=pi, end_is_start=quirk_end_is_start,
                        v=mr_v))
            t_stream = time.perf_counter() - t_stream
            batches = {"start": (b_start, g_counts[0]),
                       "end": (b_end, g_counts[1])}
            if v > 0 and current_run == 0:
                log(f"Number of sequences found: {n_reads}.", tab_level)

            if sn > n_reads:  # clamp-by-mutation quirk (:844-848)
                if is_host0:
                    warn("Sequence set too small for the requested sample "
                         "size")
                    warn("The whole set will be used.")
                sn = n_reads

            # both ends in flight before either fetch (the JAX orchestrator's
            # dispatch phase): the end pass counts while the start pass is
            # fetched, reported and exported
            pending = {end: engine.start_pass(batches[end][0].windows,
                                              batches[end][0].n_valid,
                                              codes=resume_codes)
                       for end in ends}

            tab_level += 1
            for which_end in ends:
                with span(f"{which_end} pass"):
                    log_end_start(log, v, mr_v, tab_level, which_end,
                                  which_end == "end"
                                  and not quirk_end_is_start)
                    # the run's sample over every rank's windows; always
                    # tagged (pipelined), COMPAT M5: both ends are in flight
                    ok = count_and_export_end(
                        prm, log, mr_v, tab_level, run_suffix, which_end,
                        batches[which_end][1], t_stream, True,
                        pending[which_end].finish, resume_codes,
                        is_host0=is_host0)
                if pc > 1:
                    # only rank 0 can fail an export; every rank must take
                    # the SAME return path or the others deadlock on the
                    # next collective -- one tiny flag all-gather per end
                    ok = not bool(_allgather_rows(
                        np.array([0 if ok else 1], np.int64)).max())
                if not ok:
                    return 1

                if prm.skip_end and mr_v > 0:
                    log("Skipping end adapter ressearch")
            tab_level -= 1
        return 0
    finally:
        # a pass still in flight (the end pass after a failed start
        # export) runs to its end on every rank before the engine goes
        engine.close()
