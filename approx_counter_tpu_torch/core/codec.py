"""2-bit DNA codec.

Reproduces the packing semantics of the reference's ``dna2int`` / ``int2dna``
(approx_counter.cpp:55-78): bases are packed **first base in
the high bits** -- ``value = value << 2 | ord(c)`` with A=0, C=1, G=2, T=3
(the SeqAn Dna5 ordinal order, N=4).

k-mer codes are up to 64 bits (k <= 32).  On the host they are plain Python
ints / ``np.uint64``; in torch they are int64 tensors (the same bits; a
k <= 31 code is non-negative).  ``split_code``/``join_code`` convert to and
from the JAX package's ``(hi, lo)`` uint32 pairs.  A copy of
``approx_counter_tpu/core/codec.py``: its numpy host side, the window
packers included, and torch counterparts of its device-side unpackers.
"""

from __future__ import annotations

import numpy as np
import torch

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


def codes_to_seq(codes: np.ndarray) -> str:
    """uint8 ordinal array -> ASCII DNA string (4 -> 'N')."""
    return _CODE_TO_CHAR[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def is_dna(seq: str | bytes | np.ndarray) -> bool:
    """True iff the sequence is pure ACGT (case-insensitive).

    Mirrors ``is_DNA`` (approx_counter.cpp:313-321): any symbol with
    ordinal >= 4 (N or other IUPAC) fails.
    """
    codes = seq if isinstance(seq, np.ndarray) else seq_to_codes(seq)
    return bool(np.all(codes < BASE_N))


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


def decode_kmer(value: int, k: int) -> str:
    """Unpack an int code back to a k-length DNA string.

    Mirrors ``int2dna`` (approx_counter.cpp:70-78): consume low 2 bits per
    base, prepending.  A negative int64 code (bit 63 set, k = 32) decodes
    to the same bases as its uint64 value.
    """
    value = int(value)
    out = []
    for _ in range(k):
        out.append(_DNA[value & 3])
        value >>= 2
    return "".join(reversed(out))


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



# ---------------------------------------------------------------------------
# Packed window transfer: the sampled batch is 3-bit symbols (0..3 bases,
# 4 N, 5 pad), one byte per base -- ~4 MB per default pass.  Two packed
# formats ship it to the device in fewer bytes:
#
#   * sparse-N (0.25 B/base): the 2-bit plane alone + a fixed-size list of
#     N positions; pad is *derived* on the device from (ncols, n_valid)
#     masks via the sampler contract (every valid row holds exactly ncols
#     real symbols, rows >= n_valid are all pad).  Not usable when the
#     batch has > ncap Ns or breaks the contract.  The upload path packs
#     with the native entry (io/native.py pack_windows_sparse_native);
#     ``pack_windows_sparse`` here is its plain numpy version.
#   * dense two-plane (0.375 B/base): 2-bit base plane (4 bases/byte) +
#     high-bit plane (8 bases/byte); represents ANY symbol batch exactly:
#     sym == (sym & 3) | ((sym >> 2) << 2) restores 4 -> 0|4, 5 -> 1|4.
#
# The unpackers are a handful of torch shifts and ands (+ one small
# scatter for sparse) on the device; every consumer sees the same uint8
# batch.
# ---------------------------------------------------------------------------

#: Capacity of the sparse format's N-position list.
NCAP = 4096
INT32_MAX = np.iinfo(np.int32).max


def _padded_words(windows: np.ndarray):
    """[n, m] uint8 -> contiguous uint32 view of the mp-padded batch
    (mp = ceil(m/8)*8; pad value BASE_PAD), 4 bases per little-endian
    word.  Shared by both pack formats so their 2-bit planes can never
    diverge."""
    n, m = windows.shape
    mp = -(-m // 8) * 8
    w = windows
    if mp != m or not w.flags.c_contiguous:
        w = np.full((n, mp), BASE_PAD, np.uint8)
        w[:, :m] = windows
    return w.reshape(-1).view(np.uint32), mp


def _lo_plane_swar(x: np.ndarray, n: int, mp: int) -> np.ndarray:
    """uint32 word view -> [n, mp/4] 2-bit plane (base j of each 4-group
    at bit 2*(j%4)): SWAR bit-gather of the four 2-bit fields of each
    word into one byte."""
    t = x & np.uint32(0x03030303)
    t = t | (t >> np.uint32(6))
    t = (t | (t >> np.uint32(12))) & np.uint32(0xFF)
    return t.astype(np.uint8).reshape(n, mp // 4)


def pack_windows_host(windows: np.ndarray):
    """uint8 [n, m] ordinal batch -> (planes [n, ceil(m/8)*3], m): one
    contiguous uint8 buffer holding the 2-bit plane (first 2*mp/8 columns)
    then the high-bit plane (byte j%8 at bit j) -- a single array so the
    transfer is one copy."""
    n, m = windows.shape
    x, mp = _padded_words(windows)
    planes = np.empty((n, (mp // 8) * 3), np.uint8)
    planes[:, : mp // 4] = _lo_plane_swar(x, n, mp)
    # high-bit plane: nibble per word via bit-gather multiply
    u = (x >> np.uint32(2)) & np.uint32(0x01010101)
    nib = ((u * np.uint32(0x01020408)) >> np.uint32(24)) & np.uint32(0xF)
    nib = nib.reshape(n, mp // 4)
    planes[:, mp // 4 :] = (nib[:, 0::2] | (nib[:, 1::2] << np.uint32(4))
                            ).astype(np.uint8)
    return planes, m


def sparse_ncols(windows: np.ndarray, n_valid: int) -> int:
    """Real symbols per valid row under the sampler contract: ``m - 1``
    for a start batch (its valid rows end in a pad column), else ``m``."""
    m = windows.shape[1]
    if n_valid > 0 and (windows[:n_valid, m - 1] == BASE_PAD).all():
        return m - 1
    return m


def pack_windows_sparse(windows: np.ndarray, n_valid: int,
                        ncols: int | None = None, ncap: int = NCAP):
    """Sparse-N variant of :func:`pack_windows_host`: ONLY the 2-bit plane
    (0.25 bytes/base) plus a fixed-size list of N positions, as flattened
    row*m+col indices padded with INT32_MAX.

    Returns (lo_planes uint8 [n, mp/4], n_idx int32 [ncap], ncols, m), or
    **None** when the batch has more than ``ncap`` Ns, breaks the sampler
    contract (a symbol other than N at or above 4 inside the valid region)
    or has ``n*m >= 2**31`` cells (the indices are int32): the caller then
    ships the dense format.  ``ncols=None`` detects start vs end batches
    (:func:`sparse_ncols`)."""
    n, m = windows.shape
    if n * m >= 2**31:
        return None
    if ncols is None:
        ncols = sparse_ncols(windows, n_valid)
    valid = windows[:n_valid, :ncols]
    n_idx = np.full(ncap, INT32_MAX, np.int32)
    if valid.size and int(valid.max()) >= BASE_N:
        rows, cols = np.nonzero(valid >= BASE_N)
        if len(rows) > ncap:
            return None
        if (valid[rows, cols] != BASE_N).any():
            # pad (or junk) INSIDE the valid region: the scatter would
            # rewrite it as N; the dense format keeps it exactly
            return None
        n_idx[: len(rows)] = rows.astype(np.int64) * m + cols
    x, mp = _padded_words(windows)
    return _lo_plane_swar(x, n, mp), n_idx, ncols, m


def _lo_bases(lo: torch.Tensor, dim: int) -> torch.Tensor:
    """The four 2-bit fields of each packed byte, stacked after ``dim``."""
    return torch.stack([(lo >> (2 * j)) & 3 for j in range(4)], dim=dim + 1)


def _scatter_n(sym: torch.Tensor, tgt: torch.Tensor,
               n_idx: torch.Tensor) -> torch.Tensor:
    """``sym`` with BASE_N written at the flat indices ``tgt`` of the
    listed (not INT32_MAX) entries of ``n_idx``.  ``scatter_`` cannot drop
    an index, so the pad entries write into one spare element past the
    batch instead: no host sync on the list's length."""
    flat = torch.empty(sym.numel() + 1, dtype=torch.uint8, device=sym.device)
    flat[:-1].view(sym.shape).copy_(sym)
    tgt = torch.where(n_idx == INT32_MAX, sym.numel(), tgt.long())
    flat[tgt] = BASE_N
    return flat[:-1].view(sym.shape)


def unpack_windows_sparse(lo_planes: torch.Tensor, n_idx: torch.Tensor,
                          n_valid: int, ncols: int, m: int) -> torch.Tensor:
    """Inverse of :func:`pack_windows_sparse` -> uint8 [n, m]: pad from the
    (ncols, n_valid) masks, BASE_N at the listed positions."""
    n = lo_planes.shape[0]
    b = _lo_bases(lo_planes, 1).reshape(n, -1)[:, :m]
    col = torch.arange(m, device=b.device)[None, :]
    row = torch.arange(n, device=b.device)[:, None]
    sym = torch.where((col < ncols) & (row < n_valid), b, BASE_PAD)
    return _scatter_n(sym, n_idx, n_idx)


def unpack_windows_sparse_t(lo_planes: torch.Tensor, n_idx: torch.Tensor,
                            n_valid: int, ncols: int, m: int) -> torch.Tensor:
    """Transposed inverse of :func:`pack_windows_sparse` -> uint8 [m, n],
    the text-major layout the exact stage and the kernels consume: only the
    packed plane (1/4 of the batch) is transposed, and the flat N indices
    r*m + c become c*n + r."""
    n = lo_planes.shape[0]
    b = _lo_bases(lo_planes.t(), 0).reshape(-1, n)[:m]
    row = torch.arange(m, device=b.device)[:, None]   # text position axis
    col = torch.arange(n, device=b.device)[None, :]   # window axis
    sym = torch.where((row < ncols) & (col < n_valid), b, BASE_PAD)
    return _scatter_n(sym, (n_idx % m) * n + n_idx // m, n_idx)


def unpack_windows(planes: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse of :func:`pack_windows_host` -> uint8 [n, m]."""
    n = planes.shape[0]
    mp8 = planes.shape[1] // 3
    b = _lo_bases(planes[:, : 2 * mp8], 1).reshape(n, -1)
    hib = planes[:, 2 * mp8 :]
    hi = torch.stack([(hib >> j) & 1 for j in range(8)], dim=2).reshape(n, -1)
    return (b | (hi << 2))[:, :m].contiguous()
