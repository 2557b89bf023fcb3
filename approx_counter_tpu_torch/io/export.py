"""Counter export / printing.

Byte-parity with the reference:
  * ``exportCounter`` (approx_counter.cpp:157-174): ``kmer\\tcount\\n`` per
    line, in iteration order (for us: CompareCount order).  Open failure ->
    stderr message + False.
  * ``printCounters`` (approx_counter.cpp:143-149): ``kmer count`` to stdout,
    space-separated.

``parse_exact_export`` reads an export back for ``--from-exact``.
"""

from __future__ import annotations

import sys

import numpy as np

from approx_counter_tpu_torch.core.codec import (
    BASE_N,
    decode_kmers,
    encode_kmer,
    seq_to_codes,
)


def _lines(codes: np.ndarray, counts: np.ndarray, k: int, sep: str) -> str:
    kmers = decode_kmers(np.asarray(codes, dtype=np.uint64), k)
    counts = np.asarray(counts)
    return "".join(f"{km}{sep}{int(c)}\n" for km, c in zip(kmers, counts))


def export_counter(codes, counts, k: int, output: str) -> bool:
    """Write ``kmer\\tcount`` lines; returns False on open failure
    (approx_counter.cpp:169-172)."""
    try:
        with open(output, "w") as f:
            f.write(_lines(codes, counts, k, "\t"))
    except OSError:
        sys.stderr.write(f"/!\\ ERROR: COULD NOT OPEN FILE {output}\n")
        return False
    return True


def print_counters(codes, counts, k: int) -> None:
    """Print ``kmer count`` lines to stdout (approx_counter.cpp:143-149)."""
    sys.stdout.write(_lines(codes, counts, k, " "))


def parse_exact_export(path: str, k: int) -> np.ndarray:
    """Read a ``kmer\\tcount`` export back as uint64 codes, in file order
    and with repeats (resume mode; the counts are ignored).

    Lines whose k-mer is not pure ACGT of length k raise
    ``InputFormatError`` naming ``path:line`` -- a resume file from a
    different k is a user error, not data.  A missing file raises
    ``FileNotFoundError``.
    """
    from approx_counter_tpu_torch.io.fastx import InputFormatError

    codes = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            kmer = line.split("\t")[0]
            c = seq_to_codes(kmer)
            if len(c) != k or (c >= BASE_N).any():
                raise InputFormatError(
                    f"{path}:{ln}: '{kmer}' is not a pure-ACGT {k}-mer"
                )
            codes.append(encode_kmer(c))
    return np.array(codes, dtype=np.uint64)
