"""Counter export.

Byte-parity with the reference's ``exportCounter``
(approx_counter.cpp:157-174): ``kmer\\tcount\\n`` per line, in iteration
order (for us: CompareCount order).  Open failure -> stderr message + False.
"""

from __future__ import annotations

import sys

import numpy as np

from approx_counter_tpu_torch.core.codec import decode_kmers


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
