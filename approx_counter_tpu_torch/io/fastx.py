"""FASTA/FASTQ reading into dense 2-bit-friendly buffers.

The reference reads the whole file into RAM via SeqAn's ``SeqFileIn`` /
``readRecords`` with auto-detected format (approx_counter.cpp:824-825).  Here
reads land in a single contiguous ``uint8`` ordinal buffer plus an offsets
vector -- the shape the sampler and the device pipeline want.  A copy of
``approx_counter_tpu/io/fastx.py``: plain files go through the native C++
parser (``io/native.py``, built from ``csrc/fastx_parser.cpp`` at first use),
gzip files through the Python parser, which is also the plain reference the
tests hold the native one to.  The native parser is not optional: when it
cannot be built, ``read_fastx`` raises.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from approx_counter_tpu_torch.core.codec import _CHAR_TO_CODE


class InputFormatError(ValueError):
    """Malformed/unrecognized input file (COMPAT #19).  A ValueError
    subclass so existing parser tests keep matching; the CLI catches
    THIS type only, so internal ValueErrors still traceback instead of
    masquerading as bad input."""


#: bytes.translate table: ASCII -> base ordinals.  All big-buffer char
#: mapping goes through bytes.translate / bytes.join, NOT numpy fancy
#: indexing -- numpy's gather/memcpy paths run at ~15 MB/s on some
#: virtualized hosts while CPython bytes ops hit ~1 GB/s.
_TRANS = bytes(_CHAR_TO_CODE.tolist())


def _codes_from_chunks(chunks: list[bytes], lengths: list[int]) -> "Reads":
    joined = b"".join(chunks).translate(_TRANS)
    # bytearray -> frombuffer is a writable view without a numpy memcpy
    buf = np.frombuffer(bytearray(joined), dtype=np.uint8)
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return Reads(buf=buf, offsets=offsets)


@dataclasses.dataclass
class Reads:
    """n reads as one contiguous ordinal buffer (A=0..T=3, N=4).

    ``buf[offsets[i]:offsets[i+1]]`` is read i.
    """

    buf: np.ndarray       # uint8 [total_bases]
    offsets: np.ndarray   # int64 [n+1]

    def __len__(self) -> int:
        return len(self.offsets) - 1

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def read(self, i: int) -> np.ndarray:
        return self.buf[self.offsets[i] : self.offsets[i + 1]]


def _detect_format(first_byte: int) -> str:
    if first_byte == ord(">"):
        return "fasta"
    if first_byte == ord("@"):
        return "fastq"
    raise InputFormatError(
        "Unrecognized sequence file format (expected FASTA or FASTQ)"
    )


def is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def read_fastx_py(path: str) -> Reads:
    """Pure-Python FASTA/FASTQ parser (format auto-detected, like SeqAn).

    Transparently decompresses gzip inputs (framework extension -- the
    reference build has no zlib, but .gz FASTQ is ubiquitous for nanopore
    data)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":
        import gzip

        data = gzip.decompress(data)
    if not data:
        return Reads(np.empty(0, np.uint8), np.zeros(1, np.int64))
    fmt = _detect_format(data[0])
    chunks: list[bytes] = []
    lengths: list[int] = []
    if fmt == "fasta":
        # Records separated by '>' header lines; sequence may span lines.
        pos = 0
        n = len(data)
        while pos < n:
            if data[pos] != ord(">"):
                raise InputFormatError("Malformed FASTA: expected '>' header")
            hdr_end = data.find(b"\n", pos)
            if hdr_end == -1:
                chunks.append(b"")
                lengths.append(0)
                break
            nxt = data.find(b">", hdr_end)
            seq_block = data[hdr_end + 1 : nxt if nxt != -1 else n]
            seq = seq_block.replace(b"\n", b"").replace(b"\r", b"")
            chunks.append(seq)
            lengths.append(len(seq))
            pos = nxt if nxt != -1 else n
    else:
        # SeqAn's readRecords accepts *wrapped* records
        # (approx_counter.cpp:824-825): sequence spans lines
        # until a '+' separator line; quality lines accumulate until their
        # total length equals the sequence length (quality may legally
        # start with '@' or '+', so record boundaries are length-driven).
        lines = data.split(b"\n")
        i = 0
        nl = len(lines)
        while i < nl:
            if not lines[i].rstrip(b"\r"):
                i += 1
                continue
            if lines[i][0] != ord("@"):
                raise InputFormatError("Malformed FASTQ: expected '@' header")
            i += 1
            seq_parts: list[bytes] = []
            while i < nl and not lines[i].startswith(b"+"):
                seq_parts.append(lines[i].rstrip(b"\r"))
                i += 1
            if i >= nl:
                raise InputFormatError("Malformed FASTQ: truncated record")
            i += 1  # '+' separator (may carry a tag)
            need = sum(len(p) for p in seq_parts)
            got = 0
            while i < nl and got < need:
                got += len(lines[i].rstrip(b"\r"))
                i += 1
            if got != need:
                raise InputFormatError("Malformed FASTQ: quality length mismatch")
            seq = b"".join(seq_parts)
            chunks.append(seq)
            lengths.append(len(seq))
    return _codes_from_chunks(chunks, lengths)


def read_fastx(path: str) -> Reads:
    """Read a FASTA/FASTQ file: the native parser for plain files, the
    Python parser for gzip inputs."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if is_gzip(path):
        return read_fastx_py(path)
    from approx_counter_tpu_torch.io.native import read_fastx_native

    return read_fastx_native(path)
