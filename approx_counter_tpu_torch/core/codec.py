"""2-bit DNA codec.

Reproduces the packing semantics of the reference's ``dna2int`` / ``int2dna``
(approx_counter.cpp:55-78): bases are packed **first base in
the high bits** -- ``value = value << 2 | ord(c)`` with A=0, C=1, G=2, T=3
(the SeqAn Dna5 ordinal order, N=4).

k-mer codes are up to 64 bits (k <= 32).  On the host they are plain Python
ints / ``np.uint64``; in torch they are int64 tensors (the same bits; a
k <= 31 code is non-negative).  ``split_code``/``join_code`` convert to and
from the JAX package's ``(hi, lo)`` uint32 pairs.  A numpy-only copy of the
first part of ``approx_counter_tpu/core/codec.py``, without its window
packers.
"""

from __future__ import annotations

import numpy as np

# Base ordinals (SeqAn Dna5 order, approx_counter.cpp:22 "ACGT" + N).
BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 0, 1, 2, 3, 4
#: Padding symbol used for rows/columns beyond real data.  Distinct from N so
#: that padding never triggers the reference's had-N warning accounting
#: (approx_counter.cpp:513-517) and never matches any needle base.
BASE_PAD = 5

_DNA = "ACGT"

# char -> ordinal lookup (everything unknown -> N, matching SeqAn's Dna5
# conversion of arbitrary chars to 'N'; lowercase maps like uppercase).
_CHAR_TO_CODE = np.full(256, BASE_N, dtype=np.uint8)
for _i, _c in enumerate(_DNA):
    _CHAR_TO_CODE[ord(_c)] = _i
    _CHAR_TO_CODE[ord(_c.lower())] = _i

_CODE_TO_CHAR = np.frombuffer(b"ACGTN?", dtype=np.uint8)


def seq_to_codes(seq: str | bytes) -> np.ndarray:
    """ASCII DNA -> uint8 ordinal array (A=0..T=3, other=4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _CHAR_TO_CODE[raw]


def encode_kmer(seq: str | bytes | np.ndarray) -> int:
    """Pack a pure-ACGT k-mer into an int, first base in the high bits.

    Mirrors ``dna2int`` (approx_counter.cpp:55-62).  The caller must guard
    with a DNA-validity check, as the reference does: an N injects ordinal 4
    and corrupts the code.
    """
    codes = seq if isinstance(seq, np.ndarray) else seq_to_codes(seq)
    value = 0
    for c in codes:
        value = (value << 2) | int(c)
    return value


def decode_kmers(values: np.ndarray, k: int) -> list[str]:
    """Vectorized ``int2dna`` over an array of uint64 codes."""
    values = np.asarray(values, dtype=np.uint64)
    n = values.shape[0]
    if n == 0:
        return []
    chars = np.empty((n, k), dtype=np.uint8)
    v = values.copy()
    for i in range(k - 1, -1, -1):
        chars[:, i] = _CODE_TO_CHAR[(v & np.uint64(3)).astype(np.uint8)]
        v >>= np.uint64(2)
    return [row.tobytes().decode("ascii") for row in chars]


def split_code(value: int | np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 code -> (hi, lo) uint32 pair for device-side use."""
    v = np.asarray(value, dtype=np.uint64)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def join_code(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) uint32 pair -> uint64 code (host side)."""
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        lo, dtype=np.uint64
    )

