"""Forbidden-k-mer list parsing.

Mirrors ``parse_kmer_list`` (approx_counter.cpp:340-364):
one k-mer per line; chars outside ACGT become N (Dna5 conversion) and any
line containing an N is silently dropped; an unopenable file prints to
stderr and exits 1.
"""

from __future__ import annotations

import sys

import numpy as np

from approx_counter_tpu_torch.core.codec import BASE_N, encode_kmer, seq_to_codes


def parse_kmer_list(path: str) -> np.ndarray:
    """Returns the sorted unique uint64 codes of the valid k-mers."""
    try:
        f = open(path, "r")
    except OSError:
        sys.stderr.write("/!\\ ERROR: COULD NOT OPEN EXCLUDED KMER FILE, must quit\n")
        sys.exit(1)
    codes: set[int] = set()
    with f:
        for line in f.read().split("\n"):
            if not line:
                continue
            c = seq_to_codes(line)
            if np.all(c < BASE_N):
                codes.add(encode_kmer(c))
    return np.array(sorted(codes), dtype=np.uint64)
