"""Read-end window sampling (host, numpy).

A copy of ``approx_counter_tpu/sample/sampler.py`` with the same rng draws,
so that both packages sample the same reads from the same seed.  Mirrors
``sampleSequences`` (approx_counter.cpp:415-476):

  * shuffle all read indices (reference: random_device -> mt19937 -> shuffle,
    nondeterministic by design; we add a seeded mode for tests/parity)
  * walk the shuffled order; only reads with ``len >= 2*sl`` are eligible
    (:461, "long enough to contain both adapters")
  * start windows are ``seq[:sl]`` (prefix, :466); end windows are
    ``seq[len-1-sl:]`` -- **sl+1 bases**, the reference's off-by-one at :463,
    reproduced because it affects counts
  * stop at ``sn`` samples or exhaustion

Because eligibility already guarantees ``len >= 2*sl``, every window in a
batch has the same real length (sl for start, sl+1 for end) -- the batch is
a dense ``[n_pad, sl+1]`` uint8 array: **both ends share the sl+1 width**,
start windows carrying one trailing ``BASE_PAD`` column.  Pad symbols are
inert in both counting stages (they invalidate any k-mer position touching
them and cannot lower an edit distance), so this changes no counts.  Rows
beyond the real sample count (up to a multiple of ``pad_to``) are filled
with ``BASE_PAD`` and masked out downstream.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from approx_counter_tpu_torch.core.codec import BASE_PAD
from approx_counter_tpu_torch.io.fastx import Reads


@dataclasses.dataclass
class WindowBatch:
    """Dense sampled-window batch: ``windows[i]`` valid iff ``i < n_valid``."""

    windows: np.ndarray | None  # uint8 [n_pad, sl+1]; start rows end in one
    #                             pad col; None when not gathered
    n_valid: int
    chosen: np.ndarray | None = None  # int64 [n_valid] sampled read ids
    #                                   (the device pool gathers by them);
    #                                   None for streaming reservoirs


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def gather_rows(buf: np.ndarray, starts: np.ndarray, ncols: int,
                out: np.ndarray) -> None:
    """Gather ``len(starts)`` rows of ``ncols`` bases from ``buf`` into
    ``out[:len(starts), :ncols]`` (native memcpy per row).  Shared by the
    per-pass sampler and the device window pool
    (``pipeline.Engine.build_pool``)."""
    from approx_counter_tpu_torch.io.native import gather_windows_native

    gather_windows_native(buf, starts, ncols, out)


def sample_windows(
    reads: Reads,
    sn: int,
    sl: int,
    end: bool,
    rng: np.random.Generator | None = None,
    pad_to: int = 8,
    v: int = 0,
    warn_sink: list | None = None,
    gather: bool = True,
) -> WindowBatch:
    """Sample up to ``sn`` windows of the read starts (or ends).

    ``v`` is the reference's ``mr_v`` passed into ``sampleSequences``: at
    ``v >= 2`` every *walked* read shorter than ``sl`` emits the per-read
    stderr warning (approx_counter.cpp:449-457) in walk order.
    ``warn_sink``: collect those warning texts instead of emitting them
    (the pipelined driver samples the NEXT pass early and flushes its
    warnings at the reference's point in the log).
    ``gather=False`` skips the window gather and returns ``windows=None``:
    the device-pool path gathers on the device by ``chosen``.  The rng
    draws, the walk and the warnings are the same either way.
    """
    n_reads = len(reads)
    if rng is None:
        rng = np.random.default_rng()  # OS entropy, like the reference
    order = rng.permutation(n_reads)
    lengths = reads.lengths
    width = sl + 1          # unified batch width (module docstring)
    ncols = sl + 1 if end else sl  # real bases per window

    # Eligibility (:461) preserved in shuffled order, truncated to sn.
    lens_walk = lengths[order]
    eligible = order[lens_walk >= 2 * sl]
    chosen = eligible[:sn]
    n_valid = len(chosen)

    if v >= 2:
        # The reference walks the shuffled order until sn eligible reads
        # are collected; every walked read with len < sl (min(len, sl)
        # shortens the cut) warns to stderr (:449-457) -- including
        # ineligible reads, which consume walk steps but never sample.
        from approx_counter_tpu_torch.io.logging import (
            short_read_warning,
            warn,
        )

        if sn <= 0:
            walk_end = 0
        else:
            cum = np.cumsum(lens_walk >= 2 * sl)
            if len(cum) and cum[-1] >= sn:
                walk_end = int(np.argmax(cum == sn)) + 1
            else:
                walk_end = n_reads
        for sid in order[:walk_end][lens_walk[:walk_end] < sl]:
            msg = short_read_warning(sid)
            if warn_sink is not None:
                warn_sink.append(msg)
            else:
                warn(msg)

    if not gather:
        return WindowBatch(windows=None, n_valid=n_valid, chosen=chosen)

    n_pad = max(_round_up(n_valid, pad_to), pad_to)
    windows = np.full((n_pad, width), BASE_PAD, dtype=np.uint8)
    offs = reads.offsets
    if end:
        starts = offs[chosen + 1] - 1 - sl  # suffix(seq, len-1-sl) -> sl+1 bases
    else:
        starts = offs[chosen]
    gather_rows(reads.buf, starts, ncols, windows)
    return WindowBatch(windows=windows, n_valid=n_valid, chosen=chosen)
