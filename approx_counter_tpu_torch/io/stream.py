"""Streaming FASTA/FASTQ reading with reservoir window sampling.

Port of ``approx_counter_tpu/io/stream.py``.  The reference loads the whole
file into RAM (approx_counter.cpp:824-825) and shuffles read indices to
sample.  For datasets larger than host RAM this module streams records in
bounded memory and keeps two reservoirs (start / end) of up to ``sn``
windows each.

Distributional equivalence: the reference's shuffle-then-filter-eligible
walk yields a uniform ``sn``-subset of the *eligible* reads
(len >= 2*sl, approx_counter.cpp:461); reservoir sampling over the eligible
stream yields the same distribution.  Windows are cut at once (sl bases from
the start; sl+1 from the end, the reference's off-by-one at :463), so memory
is O(sn * sl) plus one IO chunk, whatever the file size.

Records arrive in batches (``Reads`` of one IO chunk) from the native chunk
parser (``io/native.py``), which reads gzip files through ``gzip.open``'s
decompressed bytes.  The reservoirs take a batch at a time, and the seeded draws are those of the JAX package's
read-by-read loop: once the reservoirs are full, each eligible read draws
``rng.integers(0, n_seen + 1)`` for the start reservoir, then for the end
one, from one shared generator.  A batch's draws come from one call with an
array of bounds, which numpy's ``Generator`` serves element by element,
exactly as the same bounds one call at a time (the tests hold the two
apart), and a slot drawn twice keeps the later read.
"""

from __future__ import annotations

import gzip

import numpy as np

from approx_counter_tpu_torch.core.codec import BASE_PAD
from approx_counter_tpu_torch.io.fastx import (
    InputFormatError,
    Reads,
    is_gzip,
)
from approx_counter_tpu_torch.sample.sampler import WindowBatch, _round_up


class _Reservoir:
    """Up to ``sn`` windows of one end, [sn, sl+1] wide like the sampler's
    batches (start rows end in one pad column)."""

    def __init__(self, sn: int, sl: int, end: bool):
        self.sn = sn
        self.sl = sl
        self.ncols = sl + 1 if end else sl
        self.windows = np.full((sn, sl + 1), BASE_PAD, dtype=np.uint8)

    def fill(self, first: int, rows: np.ndarray) -> None:
        """Rows of the reads seen while the reservoir is not full go to
        slots ``first, first + 1, ...``."""
        self.windows[first:first + len(rows), :self.ncols] = rows

    def replace(self, rows: np.ndarray, slots: np.ndarray) -> None:
        """Read i's row replaces slot ``slots[i]`` when that is below
        ``sn``; of the reads that draw one slot, the last one stays."""
        keep = slots < self.sn
        rows, slots = rows[keep], slots[keep]
        last = len(slots) - 1 - np.unique(slots[::-1], return_index=True)[1]
        self.windows[slots[last], :self.ncols] = rows[last]

    def batch(self, n_seen: int, pad_to: int = 8) -> WindowBatch:
        n_valid = min(n_seen, self.sn)
        n_pad = max(_round_up(n_valid, pad_to), pad_to)
        out = np.full((n_pad, self.windows.shape[1]), BASE_PAD, np.uint8)
        out[:n_valid] = self.windows[:n_valid]
        return WindowBatch(windows=out, n_valid=n_valid)


def _iter_native(f, chunk_size):
    """Yield one ``Reads`` per IO chunk through the native chunk parser
    (record scanning and char translation in C++).  The same records as
    the JAX package's line iterators (tested)."""
    from approx_counter_tpu_torch.io.native import parse_chunk_native

    carry = b""
    while True:
        chunk = f.read(chunk_size)
        final = not chunk
        data = carry + chunk if carry else chunk
        if not data:
            return
        buf, offsets, consumed = parse_chunk_native(data, final)
        if len(offsets) > 1:
            yield Reads(buf=buf, offsets=offsets)
        if final:
            return
        carry = data[consumed:]


def iter_read_batches(paths: str | list[str], chunk_size: int = 1 << 22):
    """Stream a FASTA/FASTQ file, or several one after another (each plain
    or gzip), as ``Reads`` batches of consecutive records, one per IO
    chunk; a batch never spans two files.  Records come in the JAX
    package's ``iter_read_seqs`` order, file by file."""
    for path in [paths] if isinstance(paths, str) else paths:
        with (gzip.open if is_gzip(path) else open)(path, "rb") as f:
            first = f.read(1)
            f.seek(0)
            if not first:
                continue
            if first not in (b">", b"@"):
                raise InputFormatError("Unrecognized sequence file format "
                                       "(expected FASTA or FASTQ)")
            yield from _iter_native(f, chunk_size)


def _cut(reads: Reads, idx: np.ndarray, sl: int, end: bool) -> np.ndarray:
    """[len(idx), ncols] windows of reads ``idx``: the sl-base prefix, or
    the sl+1-base suffix (``suffix(seq, len-1-sl)``)."""
    ncols = sl + 1 if end else sl
    starts = reads.offsets[idx + 1] - ncols if end else reads.offsets[idx]
    return np.lib.stride_tricks.sliding_window_view(reads.buf, ncols)[starts]


def stream_sample_windows(
    path: str,
    sn: int,
    sl: int,
    rng: np.random.Generator | None = None,
    pad_to: int = 8,
    chunk_size: int = 1 << 22,
    end_is_start: bool = False,
    v: int = 0,
):
    """One streaming pass -> (start WindowBatch, end WindowBatch, n_reads).

    Bounded memory: O(sn * sl) plus one IO chunk.  ``end_is_start``: the
    second reservoir samples the START again (an independent draw) -- the
    ``--compat-quirks`` skip_end bug, where the reference's second pass
    runs with ``bottom == false`` (approx_counter.cpp:943-953).  ``v >= 2``:
    the per-read short-read stderr warning (approx_counter.cpp:449-457),
    read id = stream ordinal.
    As in the JAX package, this mode warns ONCE per short read per run (one
    streaming walk feeds both reservoirs), walks every read, and numbers
    reads in file order.
    """
    if rng is None:
        rng = np.random.default_rng()
    end_end = not end_is_start
    r_start = _Reservoir(sn, sl, end=False)
    r_end = _Reservoir(sn, sl, end=end_end)
    n_reads = 0
    n_seen = 0  # eligible reads so far (both reservoirs saw each of them)
    for reads in iter_read_batches(path, chunk_size):
        lengths = reads.lengths
        if v >= 2:
            from approx_counter_tpu_torch.io.logging import (
                short_read_warning,
                warn,
            )

            for i in np.nonzero(lengths < sl)[0]:
                warn(short_read_warning(n_reads + int(i)))
        n_reads += len(reads)
        elig = np.nonzero(lengths >= 2 * sl)[0]  # approx_counter.cpp:461
        if not len(elig):
            continue
        rows_s = _cut(reads, elig, sl, end=False)
        rows_e = _cut(reads, elig, sl, end=end_end) if end_end else rows_s
        n_fill = min(max(sn - n_seen, 0), len(elig))
        r_start.fill(n_seen, rows_s[:n_fill])
        r_end.fill(n_seen, rows_e[:n_fill])
        if n_fill < len(elig):
            # one draw per full reservoir and read: start, end, start, ...
            seen = np.arange(n_seen + n_fill, n_seen + len(elig))
            bounds = np.repeat(seen + 1, 2)
            draws = rng.integers(0, bounds)
            r_start.replace(rows_s[n_fill:], draws[0::2])
            r_end.replace(rows_e[n_fill:], draws[1::2])
        n_seen += len(elig)
    return r_start.batch(n_seen, pad_to), r_end.batch(n_seen, pad_to), n_reads

