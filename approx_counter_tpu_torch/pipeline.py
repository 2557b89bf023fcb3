"""End-to-end pipeline orchestrator.

Port of ``approx_counter_tpu/pipeline.py`` for one device.  Mirrors the
reference's ``main()`` loop (approx_counter.cpp:679-957): parameter echo,
FASTA/FASTQ parse, then for each run x each end {start, end}: sample ->
exact count -> selection -> optional exact export -> approximate count ->
re-rank -> export.  File naming reproduces the reference: outputs always get
a ``_<run>`` suffix plus ``.start`` / ``.end``, and ``sn`` is clamped to the
read count by *mutation* that persists across runs/ends (:844-848).

Each pass ships its window batch to the device 2-bit packed (the sparse-N
format, or the dense two-plane one for a batch with many Ns; through pinned
memory and a non-blocking copy on a CUDA device) and counts there as the
JAX package's fused pass does: one fixed-shape program (the exact stage's
``cap`` slots, the approximate counts through the CUDA kernel of
``kernels/bpm.py``, the re-rank) whose whole result is one packed vector,
fetched once.  On a CUDA device that program runs eagerly at a shape's
first pass, is captured as a CUDA graph at its second and replayed at
every later one; on the CPU it runs eagerly.  A pass whose ``n_keep``
outgrows ``cap`` runs again, eagerly, at a larger one (the JAX package's
cap regrowth; solid mode rides it).  Passes are pipelined as in
the JAX package:
while one pass counts on the engine's worker thread, the driver samples,
packs and ships the next.  Multi-pass runs can instead ship every eligible
read's windows once into a device window pool (``--device-pool``) and then
only an index vector per pass.  Neither changes a byte of output.  Each end
runs inside a span (``tracing.span``, a ``torch.profiler`` range while a
profiler records) named ``"<end> pass"``, the next pass's sampling and
upload inside one named ``"prefetch"``, and each layer's work inside its
own (``parse``, ``engine``, ``pool``, ``sample``, ``pack``, ``upload``,
``wait``, ``eager``, ``capture``, ``rerun``, ``fetch``, ``export``,
``close``), with the counters ``upload.bytes``, ``regrow.reruns``,
``approx.launches`` and ``exact.launches`` as marks among them, so a
``--profile`` trace shows where each begins and ends.

Selection is the reference's top-``limit`` or, with ``-sk N``, solid mode:
every passing k-mer counted N times or more, all of them exported exactly
and the approximate ranking cut to ``limit``.  The JAX package's extensions
run too: ``--stream`` (no parse up front; a reservoir pass over the file at
the top of every run, ``io/stream.py``) and ``--from-exact`` (every pass
scores the codes of a prior exact export against its own windows, padded
to a fixed cap by ``candidates_from_codes`` and counted by one graph, and
no exact export is written).

skip_end: the reference's break sits inside ``if(mr_v>0)``
(approx_counter.cpp:943-948), so muted runs process the end anyway -- and
``bottom = true`` sits in the *else* of ``if(skip_end)`` (:950-952), so that
second pass re-samples the START and exports those counts under ``.end``.
We implement the intended skip unless ``compat_quirks`` asks for the bug.

Every k of the reference, 2 to 32, runs: codes are int64 tensors holding
the uint64 bits.  ``--multihost`` runs the orchestrator of
``dist/multihost.py`` instead, which shares this module's echo, end plan,
``Engine`` and per-end routines.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from approx_counter_tpu_torch.core.codec import (
    BASE_PAD,
    NCAP,
    join_code,
    pack_windows_host,
    sparse_ncols,
    unpack_windows,
    unpack_windows_sparse_t,
)
from approx_counter_tpu_torch.core.complexity import lc_sum_threshold
from approx_counter_tpu_torch.count.approx import rank_with_zero_counts
from approx_counter_tpu_torch.count.exact import (
    CT,
    _round_up,
    exact_count_select_rows,
    pass_cap,
)
from approx_counter_tpu_torch.dist import mesh
from approx_counter_tpu_torch.io.export import (
    export_counter,
    parse_exact_export,
)
from approx_counter_tpu_torch.io.fastx import read_fastx
from approx_counter_tpu_torch.io.kmer_list import parse_kmer_list
from approx_counter_tpu_torch.io.logging import Log, error, warn
from approx_counter_tpu_torch.io.native import pack_windows_sparse_native
from approx_counter_tpu_torch.kernels.bpm import (
    _as_int32_bits,
    approx_counts,
    build_peq,
)
from approx_counter_tpu_torch.kernels.exact_stage import (
    position_keys,
    slot_dimers,
    slot_keys,
)
from approx_counter_tpu_torch.params import Params
from approx_counter_tpu_torch.io.stream import stream_sample_windows
from approx_counter_tpu_torch.sample.sampler import gather_rows, sample_windows
from approx_counter_tpu_torch.tracing import count, span

#: Row granularity of the JAX package's device batches; the pool decision
#: prices a pass's upload in rows padded to it, as the JAX package does.
WT = 256
_M32 = 0xFFFFFFFF


def pack_pass_output(ex: dict, approx: tuple, k: int) -> torch.Tensor:
    """A fixed-shape pass's whole result as one int32 vector holding the
    JAX package's uint32 layout (``_pack_pass_output``): ``n_unique``,
    ``n_keep``, ``had_n``, ``n_pass``, then blocks of ``cap``: the exact
    selection's code low words, counts and validity, the approximate
    ranking's code low words, counts and validity, and for k > 16 the two
    code high-word blocks.  ``ex`` is ``exact_count_select_rows``'s dict,
    ``approx`` ``rank_with_zero_counts``'s (codes, counts, valid)."""
    codes, counts, valid = approx
    sel = ex["sel_codes"]
    parts = [torch.stack([ex["n_unique"], ex["n_keep"], ex["had_n"],
                          ex["n_pass"]]),
             sel & _M32, ex["sel_counts"], ex["sel_valid"].long(),
             codes & _M32, counts.long(), valid.long()]
    if k > 16:
        parts += [(sel >> 32) & _M32, (codes >> 32) & _M32]
    return _as_int32_bits(torch.cat(parts))


def unpack_pass_output(arr: np.ndarray, cap: int, k: int) -> dict:
    """Host inverse of ``pack_pass_output``, the JAX package's
    ``unpack_pass_output``: the same dict of uint32 blocks and scalars."""
    arr = np.asarray(arr).view(np.uint32)
    blocks = [arr[4 + i * cap: 4 + (i + 1) * cap] for i in range(8)]
    zeros = np.zeros(cap, np.uint32)
    ex = dict(
        n_unique=np.int32(arr[0]), n_keep=np.int32(arr[1]),
        had_n=np.int32(arr[2]), n_pass=np.int32(arr[3]),
        sel_lo=blocks[0], sel_count=blocks[1],
        sel_valid=blocks[2].astype(bool),
        sel_hi=blocks[6] if k > 16 else zeros,
    )
    return dict(
        exact=ex,
        approx_hi=blocks[7] if k > 16 else zeros,
        approx_lo=blocks[3], approx_count=blocks[4],
        approx_valid=blocks[5].astype(bool),
    )


def pass_words(cap: int, k: int) -> int:
    """Words of ``pack_pass_output``'s vector at ``cap``: four counters and
    six blocks of ``cap``, eight for k > 16."""
    return 4 + (8 if k > 16 else 6) * cap


def candidates_from_codes(codes: np.ndarray):
    """The ``--from-exact`` candidates as a fixed-cap selection (the JAX
    package's ``candidates_from_codes``): ``(sel_codes, sel_valid, cap)``,
    the uint64 ``codes`` (repeats kept) then code 0 up to ``cap`` =
    ``max(512, len(codes) rounded up to CT)`` slots, and the bool mask of
    the real ones."""
    cap = max(512, _round_up(max(len(codes), 1), CT))
    sel_codes = np.zeros(cap, np.uint64)
    sel_codes[:len(codes)] = codes
    sel_valid = np.zeros(cap, bool)
    sel_valid[:len(codes)] = True
    return sel_codes, sel_valid, cap


def _fetch(t: torch.Tensor) -> np.ndarray:
    """A pass's one fetch: its packed output to the host."""
    with span("fetch"):
        return t.cpu().numpy()


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
        with span("export"):
            ok = not is_host0 or export_counter(exact_codes, exact_counts,
                                                prm.k, path)
        if not ok:
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
    with span("export"):
        ok = not is_host0 or export_counter(approx_codes, approx_counts_,
                                            prm.k, path)
    if not ok:
        error("Failed to export approximate k-mer count")
        sys.stderr.write(f"Path: {path}\n")
        return False

    if mr_v > 0:
        log("Done", tab_level)
    return True


def end_plan(prm) -> tuple[bool, bool]:
    """(whether a run's end pass runs, whether it samples the start again).
    The reference's skip_end break sits inside ``if(mr_v>0)``
    (approx_counter.cpp:943-953): under ``--compat-quirks`` a muted run
    processes the end anyway, and as ``bottom = true`` sits in the else of
    ``if(skip_end)`` that pass samples the START again and its counts are
    exported under ``.end``.  Read from ``prm.mr_v``, never a muted one, so
    every multihost rank plans the same passes."""
    runs_end_pass = (not prm.skip_end) or (prm.compat_quirks
                                           and prm.mr_v == 0)
    return runs_end_pass, prm.skip_end and runs_end_pass


def log_end_start(log, v: int, mr_v: int, tab_level: int, which_end: str,
                  bottom: bool) -> None:
    """An end's log lines before its sample; ``bottom`` when it samples
    the ends of reads."""
    if v > 0:
        log(f"Working on sequence {which_end}.", tab_level - 1)
    if mr_v > 0:
        log("Sampling", tab_level)
        log("Sampling the ends of reads" if bottom
            else "Sampling the start of reads", tab_level)


def count_and_export_end(prm, log, mr_v: int, tab_level: int,
                         run_suffix: str, which_end: str, n_sampled: int,
                         t_sample: float, pipelined: bool, finish,
                         resume_codes, is_host0: bool = True) -> bool:
    """An end after its sample, in both drivers: the ``Sampled`` and
    ``Exact k-mer count`` lines, ``finish()`` (the pass's result as
    ``count_one_end`` gives it or, with the ``--from-exact``
    ``resume_codes``, as ``approx_stage`` does, beside the list as the
    exact selection), at ``mr_v >= 2`` the ``[stats]`` line over the
    ``n_sampled`` windows, tagged `` (pipelined)`` when ``pipelined``, then
    ``report_and_export_end``.  False after an export failure."""
    if mr_v > 0:
        log(f"Sampled {n_sampled} sequences", tab_level)
        log("Exact k-mer count", tab_level)
    t_count = time.perf_counter()
    got = finish()
    t_count = time.perf_counter() - t_count
    resume = resume_codes is not None
    if resume:
        n = len(resume_codes)
        got = ((resume_codes, np.zeros(n, np.uint64)), got,
               dict(n_unique=n, n_keep=n, had_n=0))
    exact_sel, approx_sel, stats = got
    if mr_v >= 2:
        pairs = stats["n_keep"] * n_sampled
        log(f"[stats] sample {t_sample * 1e3:.1f} ms | "
            f"count+score {t_count * 1e3:.1f} ms"
            f"{' (pipelined)' if pipelined else ''} | "
            f"{n_sampled / max(t_count, 1e-9):.0f} windows/s | "
            f"{pairs / max(t_count, 1e-9):.3g} pairs/s", tab_level)
    return report_and_export_end(prm, log, mr_v, tab_level, run_suffix,
                                 which_end, stats, exact_sel, approx_sel,
                                 resume=resume, is_host0=is_host0)


class _Staging:
    """The upload path's pinned host memory on a CUDA device: two buffers,
    allocated at first use (and again only if a batch outgrows them), that
    uploads alternate between.  A buffer is refilled only once the copy out
    of it has completed (a CUDA event), so the next pass can be packed and
    shipped while this one's copy is in flight.  Copies go on the caller's
    current stream; a pass on the engine's own stream waits for them
    (``Engine._on_stream``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.bufs = [None, None]
        self.copied = [None, None]
        self.turn = 0

    def upload(self, arrays: list) -> list:
        """The numpy ``arrays`` as tensors on the device, shipped in one
        non-blocking copy."""
        offs, total = [], 0
        for a in arrays:
            offs.append(total)
            total += -(-a.nbytes // 8) * 8  # keep every part 8-byte aligned
        i, self.turn = self.turn, self.turn ^ 1
        if self.copied[i] is not None:
            with span("upload wait"):
                self.copied[i].synchronize()
        if self.bufs[i] is None or self.bufs[i].numel() < total:
            self.bufs[i] = torch.empty(max(total, 1), dtype=torch.uint8,
                                       pin_memory=True)
        host = self.bufs[i][:total]
        view = host.numpy()
        for a, off in zip(arrays, offs):
            view[off:off + a.nbytes] = np.ascontiguousarray(a).reshape(
                -1).view(np.uint8)
        dev = host.to(self.device, non_blocking=True)
        self.copied[i] = torch.cuda.Event()
        self.copied[i].record(torch.cuda.current_stream(self.device))
        return [dev[off:off + a.nbytes].view(_TORCH_DTYPE[a.dtype])
                .view(a.shape) for a, off in zip(arrays, offs)]


_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8,
                np.dtype(np.uint16): torch.uint16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.bool_): torch.bool}


def pool_index(inv: np.ndarray, chosen: np.ndarray, n_valid: int,
               n_pool: int) -> np.ndarray:
    """A pool pass's index vector: the pool rows of the ``chosen`` reads,
    padded with row 0 to ``max(n_valid, 1)`` entries, with ``n_valid`` in
    its tail -- uint16 with ``n_valid`` in two slots (lo, hi) when the pool
    has fewer than 2^16 rows, else int32 with one.  ``inv`` maps a read id
    to its pool row, -1 for a read the pool does not hold."""
    rows = inv[chosen[:n_valid]]
    if len(rows) and rows.min() < 0:
        # a -1 would wrap to 65535 in uint16 and gather a wrong row as valid
        raise ValueError("a sampled read is not in the device pool")
    w_pad = max(n_valid, 1)
    if n_pool < (1 << 16):
        idx_ext = np.zeros(w_pad + 2, np.uint16)
        idx_ext[-2] = n_valid & 0xFFFF
        idx_ext[-1] = n_valid >> 16
    else:
        idx_ext = np.zeros(w_pad + 1, np.int32)
        idx_ext[-1] = n_valid
    idx_ext[:n_valid] = rows
    return idx_ext


def pool_rows(idx_ext: torch.Tensor):
    """Inverse of :func:`pool_index` on the device: (int64 row indices,
    row mask of the first ``n_valid``), with no host sync."""
    if idx_ext.dtype == torch.uint16:
        idx = idx_ext[:-2].long()
        n_valid = idx_ext[-2].long() | (idx_ext[-1].long() << 16)
    else:
        idx = idx_ext[:-1].long()
        n_valid = idx_ext[-1].long()
    return idx, torch.arange(len(idx), device=idx.device) < n_valid


class _PendingPass:
    """A dispatched pass: its batch is on the device and its counting runs
    on the engine's worker thread, on the engine's own stream, so the
    caller can sample and ship the next pass meanwhile.  The worker also
    fetches the pass's packed output, before the next pass's replay can
    overwrite it, and runs any cap regrowth while the batch is at hand."""

    def __init__(self, engine: "Engine", body, tensors: tuple):
        ready = None
        if engine.device.type == "cuda":
            # the batch's copy and unpack were queued on the caller's stream
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(engine.device))
        self._future = engine._worker.submit(engine._on_stream, body, ready,
                                             tensors)

    def finish(self):
        """Wait for the pass and return its result: the unpacked fetch,
        after any cap regrowth, as ``Engine.count_one_end`` gives it, or
        a resume pass's as ``approx_stage`` does.  An exception raised by
        the pass is raised here."""
        with span("wait"):
            return self._future.result()


def _counted() -> tuple:
    """The kernel wrappers whose ``launches`` a pass counts, looked up when
    called: the count kernel's, the exact stage's two and the re-rank's
    ``slot_dimers``."""
    return approx_counts, position_keys, slot_keys, slot_dimers


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lives on a CUDA device, where a segment may be a
    graph."""
    return t.device.type == "cuda"


class _FusedGraph:
    """One fixed-shape segment of a pass, run eagerly on its first use and
    captured as a CUDA graph on its second, on a CUDA device.
    ``run(*values)`` gives the segment's outputs (the body's tensor or
    tuple of tensors) on ``values``, on the current stream.  The first run
    calls ``body`` on them (a span ``eager``): its outputs are fresh
    tensors, and it builds the kernels and loads the modules the capture
    needs.  The second allocates the static inputs like the values, copies
    the values in, captures ``body`` on the inputs
    (``capture_error_mode="thread_local"``: the caller's thread may upload
    the next batch meanwhile) and replays; every later run copies in and
    replays, and its outputs are the static ones, which the next replay
    overwrites.  A segment run once only (a rerun at a regrown cap or
    bucket) is never captured.  ``launches`` maps each wrapper of
    ``_counted()`` to how many times the capture called it; each counter is
    set back by that many after the capture, which launched nothing, and
    goes up by that many at every replay.  On the CPU ``run`` calls
    ``body`` on the values, eagerly."""

    def __init__(self, body):
        self.body = body
        self.runs = 0
        self.inputs = None
        self.graph = None
        self.out = None
        self.launches = dict.fromkeys(_counted(), 0)
        self.replays = 0

    def _capture(self) -> None:
        # capture_begin/_end, not ``torch.cuda.graph``: that one also
        # synchronizes the card, collects garbage and empties the cache,
        # under the feet of the caller's thread
        graph = torch.cuda.CUDAGraph()
        before = {f: f.launches for f in _counted()}
        with span("capture"):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.out = self.body(*self.inputs)
            finally:
                graph.capture_end()
        for f, n in before.items():
            self.launches[f] = f.launches - n
            f.launches = n
        self.graph = graph

    def run(self, *values):
        """The segment's outputs on ``values``, on the current stream."""
        if not _on_card(values[0]):
            return self.body(*values)
        self.runs += 1
        if self.runs == 1:
            with span("eager"):
                return self.body(*values)
        if self.inputs is None:
            self.inputs = [torch.empty_like(v) for v in values]
        for dst, src in zip(self.inputs, values):
            dst.copy_(src)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for f, n in self.launches.items():
            f.launches += n
        self.replays += 1
        return self.out


class Engine:
    """Device-side counting for one parameter set on one device.

    Every pass is a fixed-shape program at a selection ``cap``, with one
    fetch of its packed output, run again at a larger cap when ``n_keep``
    outgrows it (the JAX package's cap regrowth); on a CUDA device each of
    its segments runs eagerly at a shape's first pass, is captured as a
    CUDA graph at its second and replayed after, and a rerun at a larger
    cap runs eagerly; on the CPU the same bodies run eagerly.  A pass of
    the default engine is the fused one (``_fused_pass``: one segment).
    ``sharded=True`` builds the multihost orchestrator's engine: with more
    than one rank its passes are the sharded step of ``dist/mesh.py``
    (``_sharded_pass``: three segments with a collective between each pair
    and one more before the re-rank, on the passes' own process group,
    ``mesh.pass_group``), so each rank counts its own windows; at one rank
    they are the fused pass.  A resume pass (``approx_stage``,
    ``start_pass(codes=)``) scores the ``--from-exact`` list at the fixed
    cap of ``candidates_from_codes``.

    A pass is dispatched (``start_pass``, ``start_pass_pool``) and then
    finished: dispatch packs the batch on the host and ships it (sparse-N
    2-bit format, pinned and non-blocking on a CUDA device) or, from the
    device window pool, ships only an index vector; the pass then counts on
    the worker thread, on a stream of its own, while the caller prepares
    the next one.  Every pass counts there: ``count_one_end`` and
    ``approx_stage`` are ``start_pass(...).finish()``."""

    def __init__(self, prm: Params, device, sharded: bool = False):
        with span("engine"):
            self.prm = prm
            self.device = torch.device(device)
            self.lc_sum_thr = lc_sum_threshold(prm.adjusted_lc, prm.k)
            codes = (parse_kmer_list(prm.forbid_kmer) if prm.forbid_kmer
                     else np.empty(0, np.uint64))
            self.forbidden = torch.from_numpy(codes.view(np.int64)).to(
                self.device)
            self._staging = (_Staging(self.device)
                             if self.device.type == "cuda" else None)
            self._worker = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="pass")
            self._stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
            self._pool = None
            self._group = (mesh.pass_group() if sharded
                           and mesh.process_count() > 1 else None)
            #: this rank's traffic in each sharded pass
            #: (``mesh.traffic_report``)
            self.traffic: list[dict] = []
            # (kind, cap, ...) -> the kind's graphs, run on the worker only
            self._graphs: dict[tuple, object] = {}

    def close(self) -> None:
        """Wait for every dispatched pass, dropping its result and its
        exception, stop the worker thread and free the CUDA graphs.  A pass
        dispatched after this raises."""
        with span("close"):
            self._worker.shutdown(wait=True)
            self._graphs.clear()

    def _on_stream(self, body, ready, tensors: tuple):
        """Run ``body`` on the worker thread: on the CPU as it is, on a
        CUDA device on the engine's stream once the batch is ``ready``.
        The batch's tensors were made on the caller's stream, so each is
        marked used on this one (``record_stream``): the caching allocator
        then keeps its memory until this stream's work on it is done."""
        if self._stream is None:
            return body()
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            for t in tensors:
                t.record_stream(self._stream)
            return body()

    def _upload(self, *arrays: np.ndarray) -> list:
        """The host ``arrays`` as tensors on the device; counts their bytes
        as ``upload.bytes``."""
        with span("upload"):
            count("upload.bytes", sum(a.nbytes for a in arrays))
            if self._staging is None:
                return [torch.from_numpy(np.ascontiguousarray(a))
                        for a in arrays]
            return self._staging.upload(list(arrays))

    def device_windows(self, windows: np.ndarray, n_valid: int):
        """Host uint8 ``[n, m]`` batch -> (text-major ``[m, n]`` windows on
        the device, bool row mask of the first ``n_valid`` rows).  A batch
        that keeps the sampler contract with at most ``NCAP`` Ns ships in
        the sparse-N format (0.25 B/base), any other in the dense
        two-plane one (0.375 B/base)."""
        n, m = windows.shape
        with span("pack"):
            ncols = sparse_ncols(windows, n_valid)
            sparse = pack_windows_sparse_native(windows, n_valid, ncols,
                                                NCAP)
            dense = (pack_windows_host(windows)[0] if sparse is None
                     else None)
        if sparse is not None:
            lo, n_idx = self._upload(*sparse)
            windows_t = unpack_windows_sparse_t(lo, n_idx, n_valid, ncols, m)
        else:
            (planes,) = self._upload(dense)
            windows_t = unpack_windows(planes, m).t().contiguous()
        return windows_t, torch.arange(n, device=self.device) < n_valid

    def build_pool(self, reads, sl: int,
                   ends: tuple = ("start", "end")) -> bool:
        """The device window pool: the cut windows (start: the sl-base
        prefix; end: the sl+1-base suffix, the reference's off-by-one) of
        every eligible read (len >= 2*sl), shipped once through
        ``device_windows`` and kept as ``[m, E]`` uint8 per end in
        ``ends`` (the ends the pass plan can reach).  Every pool pass then
        ships only its index vector and gathers its batch on the device.
        Returns False (no pool) when no read is eligible."""
        with span("pool"):
            elig = np.nonzero(reads.lengths >= 2 * sl)[0]
            E = len(elig)
            if E == 0:
                self._pool = None
                return False
            width = sl + 1
            inv = np.full(len(reads), -1, np.int64)
            inv[elig] = np.arange(E)
            pools = {}
            for which in ends:
                end = which == "end"
                wins = np.full((E, width), BASE_PAD, np.uint8)
                offs = reads.offsets
                starts = offs[elig + 1] - 1 - sl if end else offs[elig]
                gather_rows(reads.buf, starts, width if end else sl, wins)
                pools[which] = self.device_windows(wins, E)[0]
            self._pool = dict(pools=pools, inv=inv, E=E)
            return True

    def start_pass_pool(self, chosen: np.ndarray, n_valid: int,
                        end: bool) -> _PendingPass:
        """Dispatch one pass whose windows are gathered on the device from
        the pool (``index_select`` by the rows of the ``chosen`` reads);
        the only upload is the index vector (``pool_index``)."""
        pool = self._pool
        with span("pack"):
            idx = pool_index(pool["inv"], chosen, n_valid, pool["E"])
        (idx_ext,) = self._upload(idx)
        idx, row_mask = pool_rows(idx_ext)
        windows_t = pool["pools"]["end" if end else "start"].index_select(
            1, idx)
        return _PendingPass(self, lambda: self._count(windows_t, row_mask),
                            (windows_t, row_mask))

    def start_pass(self, windows: np.ndarray, n_valid: int,
                   codes: np.ndarray | None = None) -> _PendingPass:
        """Ship one sampled batch (uint8 ``[n, m]``, rows past ``n_valid``
        are padding) and dispatch its pass; ``finish()`` gives what
        ``count_one_end`` returns or, given the ``--from-exact`` uint64
        ``codes``, what ``approx_stage`` returns.  A sharded engine agrees
        on the ranks' batch sizes here, on the caller's thread."""
        batch = self.device_windows(windows, n_valid)
        if codes is not None:
            cand = self._candidates(codes)
            return _PendingPass(self, lambda: self._resume(*batch, *cand),
                                (*batch, *cand))
        positions = self._positions(windows.shape)
        return _PendingPass(self, lambda: self._count(*batch, positions),
                            batch)

    def count_one_end(self, windows: np.ndarray, n_valid: int):
        """One pass over a sampled batch (uint8 ``[n, m]``, rows past
        ``n_valid`` are padding), dispatched and waited for.  Returns
        ``(exact_sel, approx_sel, stats)``: (codes, counts) uint64 numpy
        pairs in CompareCount order and the counters the log lines print.
        In solid mode the exact selection holds every solid k-mer and the
        approximate one its first ``limit``."""
        return self.start_pass(windows, n_valid).finish()

    def _positions(self, shape):
        """A sharded pass's agreed batch size (``mesh.agreed_positions``);
        None for the other passes."""
        if self._group is None:
            return None
        return mesh.agreed_positions(shape, self.prm.k)

    def _count(self, windows_t, row_mask, positions=None):
        """The pass on device-resident windows (``[m, n]`` uint8, bool row
        mask): the sharded step with the passes' own process group,
        else the fused pass.  The mark ``approx.launches`` gives the count
        kernel's launches the pass made, ``exact.launches`` the exact
        stage's two kernels' (``kernels/exact_stage.py``: 2 a run of the
        body on the card, 0 on the CPU), a discarded first-cap run's and a
        graph's replays included."""
        before = {f: f.launches for f in _counted()}
        if self._group is not None:
            got = self._sharded_pass(windows_t, row_mask, positions)
        else:
            got = self._fused_pass(windows_t, row_mask)
        made = {f: f.launches - n for f, n in before.items()}
        count("approx.launches", made[approx_counts])
        count("exact.launches", made[position_keys] + made[slot_keys])
        return got

    def _unpacked(self, arr: np.ndarray, cap: int):
        """``count_one_end``'s result from a pass's packed output at
        ``cap``."""
        with span("fetch"):
            out = unpack_pass_output(arr, cap, self.prm.k)
            ex = out["exact"]
            n_keep = int(ex["n_keep"])
            n_approx = min(int(out["approx_valid"].sum()), self.prm.limit)
            return ((join_code(ex["sel_hi"][:n_keep], ex["sel_lo"][:n_keep]),
                     ex["sel_count"][:n_keep].astype(np.uint64)),
                    (join_code(out["approx_hi"][:n_approx],
                               out["approx_lo"][:n_approx]),
                     out["approx_count"][:n_approx].astype(np.uint64)),
                    dict(n_unique=int(ex["n_unique"]), n_keep=n_keep,
                         had_n=int(ex["had_n"])))

    @staticmethod
    def _regrow(size, run, next_size):
        """A pass's runs: ``run(size, rerun)`` (its fetched output) at the
        first ``size``, then at each size ``next_size(output, size)``
        gives until it gives None.  Each run after the first is a rerun,
        never captured, in a span ``rerun`` through its fetch, and a mark
        ``regrow.reruns=1``.  Returns the last output and every size run."""
        sizes = [size]
        while True:
            rerun = len(sizes) > 1
            with span("rerun") if rerun else contextlib.nullcontext():
                arr = run(sizes[-1], rerun)
            nxt = next_size(arr, sizes[-1])
            if nxt is None:
                return arr, sizes
            sizes.append(nxt)
            count("regrow.reruns", 1)

    def _fused_pass(self, windows_t, row_mask):
        """The JAX package's pass: the fixed-shape program at the first
        cap, one fetch of its packed output, and again at ``n_keep``
        rounded up to ``CT`` while ``n_keep`` outgrows the cap."""
        arr, caps = self._regrow(
            pass_cap(self.prm.limit),
            lambda cap, rerun: self._pass_output(cap, windows_t, row_mask,
                                                 rerun),
            lambda arr, cap: (_round_up(int(arr[1]), CT)
                              if int(arr[1]) > cap else None))
        return self._unpacked(arr, caps[-1])

    def _fused_body(self, windows_t, row_mask, cap: int) -> torch.Tensor:
        """The fixed-shape pass: exact stage at ``cap`` slots, approximate
        counts of all of them, re-rank with the invalid slots last, packed
        (``pack_pass_output``).  No host sync."""
        prm = self.prm
        ex = exact_count_select_rows(windows_t, row_mask, prm.k,
                                     self.lc_sum_thr, self.forbidden,
                                     prm.limit, prm.solid_km, cap)
        counts = approx_counts(build_peq(ex["sel_codes"], prm.k), windows_t,
                               row_mask, prm.k, maxerr=prm.max_error)
        approx = rank_with_zero_counts(ex["sel_codes"], counts, prm.k,
                                       ex["sel_valid"])
        return pack_pass_output(ex, approx, prm.k)

    def _cached(self, key: tuple, make, rerun: bool = False):
        """The segments under ``key`` (kind, cap, ...), made by ``make`` at
        first use and cached like the JAX package's ``_fused_cache``; for a
        ``rerun`` (a pass run again at a regrown cap or bucket) made anew
        and not cached, so they run once, eagerly."""
        if rerun:
            return make()
        got = self._graphs.get(key)
        if got is None:
            got = self._graphs[key] = make()
        return got

    def _fused_fn(self, cap: int, m: int, n: int,
                  rerun: bool = False) -> _FusedGraph:
        """The fused pass at ``cap`` over ``[m, n]`` batches, per (cap, m,
        n, solid mode)."""
        return self._cached(
            ("fused", cap, m, n, self.prm.solid_km > 0),
            lambda: _FusedGraph(lambda w, r: self._fused_body(w, r, cap)),
            rerun)

    def _pass_output(self, cap: int, windows_t, row_mask,
                     rerun: bool = False) -> np.ndarray:
        """One run of the fused pass on the current stream: its packed
        output as numpy int32 (``_FusedGraph.run``)."""
        return _fetch(self._fused_fn(cap, *windows_t.shape, rerun).run(
            windows_t, row_mask))

    def _sharded_pass(self, windows_t, row_mask, positions: int):
        """The multihost step (``dist/mesh.py``) at the first cap and
        bucket, one fetch of its packed output with every owner's
        ``STATS`` after it, and again at the sizes ``mesh.next_sizes``
        gives while a bucket overflows or ``n_keep`` outgrows the cap.
        Every rank reads the same replicated numbers, so every rank takes
        the same reruns."""
        n_ranks = mesh.process_count()

        def stats(arr, cap):
            return arr[pass_words(cap, self.prm.k):].reshape(n_ranks, -1)

        arr, sizes = self._regrow(
            (pass_cap(self.prm.limit), mesh.bucket_slots(positions, n_ranks)),
            lambda size, rerun: self._sharded_output(*size, windows_t,
                                                     row_mask, rerun),
            lambda arr, size: mesh.next_sizes(
                bool(stats(arr, size[0])[0, mesh.STATS.index("overflow")]),
                int(arr[1]), *size, positions))
        cap = sizes[-1][0]
        self.traffic.append(mesh.traffic_report(
            mesh.process_index(), stats(arr, cap), sizes))
        return self._unpacked(arr, cap)

    def _sharded_segments(self, cap: int, bucket: int, m: int, n: int,
                          rerun: bool):
        """The sharded step's four segments at ``cap`` and ``bucket`` over
        ``[m, n]`` batches: A (``mesh.local_segment``), B
        (``mesh.owner_segment``), C (``mesh.merge_owned``, ``build_peq`` and
        the kernel on this rank's windows) and the re-rank with the pack;
        uncached for a ``rerun``."""
        prm = self.prm
        k, n_ranks, me = prm.k, mesh.process_count(), mesh.process_index()

        def count(gathered, windows_t, row_mask):
            ex, stats = mesh.merge_owned(gathered, k, prm.limit, prm.solid_km,
                                         cap)
            counts = approx_counts(build_peq(ex["sel_codes"], k), windows_t,
                                   row_mask, k, maxerr=prm.max_error)
            scalars = torch.stack([ex["n_unique"], ex["n_keep"], ex["had_n"],
                                   ex["n_pass"]])
            return (counts, ex["sel_codes"], ex["sel_counts"],
                    ex["sel_valid"], scalars, stats)

        def rank(counts, codes, sel_counts, valid, scalars, stats):
            ex = dict(zip(("n_unique", "n_keep", "had_n", "n_pass"),
                          scalars.unbind(0)), sel_codes=codes,
                      sel_counts=sel_counts, sel_valid=valid)
            approx = rank_with_zero_counts(codes, counts, k, valid)
            return torch.cat([pack_pass_output(ex, approx, k),
                              stats.reshape(-1).to(torch.int32)])

        return self._cached(
            ("sharded", cap, bucket, m, n, prm.solid_km > 0), lambda: [
                _FusedGraph(lambda w, r: mesh.local_segment(
                    w, r, k, n_ranks, bucket, me)),
                _FusedGraph(lambda recv: mesh.owner_segment(
                    recv, k, self.lc_sum_thr, self.forbidden, prm.limit,
                    prm.solid_km, cap, me)),
                _FusedGraph(count),
                _FusedGraph(rank)], rerun)

    def _sharded_output(self, cap: int, bucket: int, windows_t, row_mask,
                        rerun: bool) -> np.ndarray:
        """One run of the sharded step: the segments run on the current
        stream with the collectives issued between them on the engine's
        process group, then one fetch.  Each segment and collective is a
        ``--profile`` range."""
        seg = self._sharded_segments(cap, bucket, *windows_t.shape, rerun)
        group = self._group
        with span("exact local"):
            send = seg[0].run(windows_t, row_mask)
        with span("exact exchange"):
            recv = mesh.exchange(send, group)
        with span("exact owner"):
            row = seg[1].run(recv)
        with span("exact gather"):
            gathered = mesh.gather(row, group)
        with span("approx count"):
            counts, *rest = seg[2].run(gathered, windows_t, row_mask)
        with span("approx reduce"):
            dist.all_reduce(counts, group=group)
        with span("approx rank"):
            packed = seg[3].run(counts, *rest)
        return _fetch(packed)

    def _candidates(self, codes: np.ndarray):
        """``candidates_from_codes`` on the device: (int64 codes, bool
        valid) of ``cap`` slots."""
        sel_codes, sel_valid, _ = candidates_from_codes(codes)
        return self._upload(sel_codes.view(np.int64), sel_valid)

    def _resume(self, windows_t, row_mask, cand, valid):
        """The resume pass at the candidates' fixed cap: ``build_peq``, the
        counts (all-reduced over the ranks of a sharded engine),
        ``rank_with_zero_counts(valid=)`` and a pack of int64 ``[3, cap]``
        (codes, counts, valid), fetched once; on one device one graph,
        sharded two around the ``all_reduce``.  Returns the ranking's
        first ``min(valid, limit)`` as host uint64 (codes, counts), the
        JAX package's ``_approx_finish``."""
        prm = self.prm
        k = prm.k

        def count(cand, windows_t, row_mask):
            return approx_counts(build_peq(cand, k), windows_t, row_mask,
                                 k, maxerr=prm.max_error)

        def rank(counts, cand, valid):
            codes, counts, valid = rank_with_zero_counts(cand, counts, k,
                                                         valid)
            return torch.stack([codes, counts.long(), valid.long()])

        group = self._group
        if group is None:
            seg = self._cached(
                ("resume", cand.shape[0], *windows_t.shape),
                lambda: [_FusedGraph(lambda c, v, w, r: rank(
                    count(c, w, r), c, v))])
            packed = seg[0].run(cand, valid, windows_t, row_mask)
        else:
            seg = self._cached(
                ("resume sharded", cand.shape[0], *windows_t.shape),
                lambda: [_FusedGraph(count), _FusedGraph(rank)])
            counts = seg[0].run(cand, windows_t, row_mask)
            dist.all_reduce(counts, group=group)
            packed = seg[1].run(counts, cand, valid)
        codes, counts, valid = _fetch(packed)
        n = min(int(valid.sum()), prm.limit)
        return codes[:n].view(np.uint64), counts[:n].astype(np.uint64)

    def approx_stage(self, windows: np.ndarray, n_valid: int,
                     codes: np.ndarray):
        """Resume-mode pass, dispatched and waited for: the uint64
        ``codes`` of a prior exact export (repeats included) scored
        against the batch, re-ranked and cut to ``limit`` -> host uint64
        (codes, counts)."""
        return self.start_pass(windows, n_valid, codes=codes).finish()


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
        with span("parse"):
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

    runs_end_pass, quirk_end_is_start = end_plan(prm)

    # Pass pipelining (not in resume mode): while one pass counts on the
    # device, the NEXT pass is sampled, packed and shipped on the host.
    # The next pass is the same run's end pass, or (in memory) the next
    # run's start pass.  The sampling order (start, end, start, ...) is
    # unchanged, so seeded outputs are byte-identical to running the
    # passes one by one.

    # Device window pool: for multi-pass runs, ship every eligible read's
    # cut windows ONCE and gather each pass's batch on the device from an
    # index vector.  Worth it when the pool's rows (one set per reachable
    # end) undercut the rows the passes would ship (each pass's sample,
    # padded as the JAX package pads it to WT rows); forced by
    # --device-pool on/off.
    use_pool = False
    if (not prm.stream and resume_codes is None
            and prm.device_pool != "off"):
        total_passes = prm.nb_of_runs * (2 if runs_end_pass else 1)
        # the end plane is unreachable when the end pass never runs OR the
        # quirk makes it a start re-sample
        need_end = runs_end_pass and not quirk_end_is_start
        ends_needed = ("start", "end") if need_end else ("start",)
        n_elig = int(np.count_nonzero(reads.lengths >= 2 * prm.sl))
        eff = min(sn, len(reads), n_elig)
        w_rows = max(_round_up(max(eff, 1), WT), WT)
        worth = (total_passes >= 2
                 and len(ends_needed) * n_elig < total_passes * w_rows)
        if n_elig > 0 and (prm.device_pool == "on" or worth):
            use_pool = engine.build_pool(reads, prm.sl, ends=ends_needed)

    def dispatch_pass(batch, end_flag: bool):
        if use_pool:
            return engine.start_pass_pool(batch.chosen, batch.n_valid,
                                          end=end_flag)
        return engine.start_pass(batch.windows, batch.n_valid,
                                 codes=resume_codes)

    def next_pass_key(run: int, which_end: str):
        if resume_codes is not None:
            return None
        if which_end == "start" and runs_end_pass:
            return (run, "end")
        if run + 1 < prm.nb_of_runs and not prm.stream:
            # cross-run: the next run's start (streaming re-reads the file
            # at the top of the run loop, so only in-memory mode prefetches)
            return (run + 1, "start")
        return None

    def sample(end_flag: bool, warn_sink=None):
        with span("sample"):
            return sample_windows(reads, sn, prm.sl, end=end_flag, rng=rng,
                                  pad_to=1, v=mr_v, warn_sink=warn_sink,
                                  gather=not use_pool)

    prefetched = None  # (key, batch, t_sample, pending, warn_msgs)

    def one_end(current_run: int, which_end: str, stream_batches,
                run_suffix: str) -> bool:
        """Sample (or take the prefetched batch), count, score and export
        one end, prefetching the next pass meanwhile; False on an export
        failure."""
        nonlocal prefetched
        bottom = which_end == "end" and not quirk_end_is_start
        log_end_start(log, v, mr_v, tab_level, which_end, bottom)
        pending = None
        if prefetched is not None and prefetched[0] == (current_run,
                                                       which_end):
            _, batch, t_sample, pending, warn_msgs = prefetched
            prefetched = None
            for msg in warn_msgs:  # deferred short-read warnings (sampled
                warn(msg)          # early by the prefetcher)
        else:
            t_sample = time.perf_counter()
            if stream_batches is not None:
                batch = stream_batches[which_end]
            else:
                batch = sample(bottom)
            t_sample = time.perf_counter() - t_sample

        def finish():
            nonlocal prefetched
            current = (pending if pending is not None
                       else dispatch_pass(batch, bottom))
            nxt = next_pass_key(current_run, which_end)
            if nxt is not None:
                # a pass is in flight: sample, pack and ship the next one
                with span("prefetch"):
                    t_s2 = time.perf_counter()
                    warn_msgs2: list = []
                    end2 = nxt[1] == "end" and not quirk_end_is_start
                    if stream_batches is not None and nxt[0] == current_run:
                        batch2 = stream_batches[nxt[1]]
                    else:
                        batch2 = sample(end2, warn_msgs2)
                    t_s2 = time.perf_counter() - t_s2
                    prefetched = (nxt, batch2, t_s2,
                                  dispatch_pass(batch2, end2), warn_msgs2)
            return current.finish()

        return count_and_export_end(
            prm, log, mr_v, tab_level, run_suffix, which_end, batch.n_valid,
            t_sample, pending is not None, finish, resume_codes)

    # A pass prefetched when the run stops early (an export failure, an
    # exception) still counts on the worker: close() waits for it and
    # drops its result, so no pass outlives the run.
    try:
        for current_run in range(prm.nb_of_runs):
            run_suffix = f"_{current_run}"
            if prm.nb_of_runs > 1 and v > 0:
                print(f"Starting run number {current_run + 1}")

            stream_batches = None
            if prm.stream:
                # one reservoir pass over the file per run, the rng carried on
                if mr_v > 0:
                    log("Streaming pass (reservoir sampling both ends)",
                        tab_level)
                with span("sample"):
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
                with span(f"{which_end} pass"):
                    if not one_end(current_run, which_end, stream_batches,
                                   run_suffix):
                        return 1

                if prm.skip_end:
                    # runs_end_pass decides both whether the end pass runs and
                    # whether next_pass_key prefetches it: were they to differ,
                    # a prefetched pass would be orphaned and its sampling
                    # would shift the seeded rng stream.
                    # Reference bug (compat_quirks): the break sits inside
                    # if(mr_v>0), so muted runs process the end anyway.
                    if mr_v > 0:
                        log("Skipping end adapter ressearch")
                    if not runs_end_pass:
                        break
            tab_level -= 1
        return 0
    finally:
        engine.close()
