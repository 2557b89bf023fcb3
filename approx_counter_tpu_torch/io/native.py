"""ctypes binding to the port's native FASTA/FASTQ parser.

Port of ``approx_counter_tpu/io/native.py``: the whole-file and the chunk
parser, the window gather and the sparse-N window packer.  The library is
built from ``csrc/fastx_parser.cpp`` by ``g++`` at first use
(``kernels/_build.py:host_build``), never when this module is imported; a
missing ``g++`` or a failed build raises, and there is no fallback to the
Python parser.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np

from approx_counter_tpu_torch.io.fastx import InputFormatError, Reads

_LIB = None


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    from approx_counter_tpu_torch.kernels._build import host_build

    lib = host_build("fastx_parser").lib
    lib.fastx_parse.restype = ctypes.c_void_p
    lib.fastx_parse.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p)
    ]
    lib.fastx_parse_chunk.restype = ctypes.c_void_p
    lib.fastx_parse_chunk.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_char_p),
    ]
    lib.fastx_n_reads.restype = ctypes.c_int64
    lib.fastx_n_reads.argtypes = [ctypes.c_void_p]
    lib.fastx_total_bases.restype = ctypes.c_int64
    lib.fastx_total_bases.argtypes = [ctypes.c_void_p]
    lib.fastx_buf.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.fastx_buf.argtypes = [ctypes.c_void_p]
    lib.fastx_offsets.restype = ctypes.POINTER(ctypes.c_int64)
    lib.fastx_offsets.argtypes = [ctypes.c_void_p]
    lib.fastx_free.restype = None
    lib.fastx_free.argtypes = [ctypes.c_void_p]
    lib.fastx_gather_windows.restype = None
    lib.fastx_gather_windows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.fastx_pack_windows_sparse.restype = ctypes.c_int64
    lib.fastx_pack_windows_sparse.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    _LIB = lib
    return lib


def _copy(ptr, n: int, dtype) -> np.ndarray:
    """A numpy copy of ``n`` items at a C pointer (one memmove)."""
    out = np.empty(n, dtype)
    if n:
        ctypes.memmove(out.ctypes.data, ptr, out.nbytes)
    return out


def gather_windows_native(buf: np.ndarray, starts: np.ndarray, ncols: int,
                          out: np.ndarray) -> None:
    """Row i of ``out[:, :ncols]`` <- ``buf[starts[i] : starts[i]+ncols]``,
    one memcpy per row.  ``buf`` and ``out`` are uint8, ``out``
    C-contiguous with at least ``len(starts)`` rows of ``ncols``; every
    window must lie inside ``buf``."""
    lib = _load()
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    n = len(starts)
    if not (out.dtype == np.uint8 and out.flags.c_contiguous
            and out.ndim == 2 and out.shape[0] >= n
            and out.shape[1] >= ncols):
        raise ValueError(f"gather_windows_native: out {out.dtype} "
                         f"{out.shape} cannot take {n} rows of {ncols}")
    if n == 0:
        return
    if starts.min() < 0 or starts.max() + ncols > len(buf):
        raise ValueError("gather_windows_native: a window lies outside buf")
    lib.fastx_gather_windows(buf.ctypes.data, starts.ctypes.data, n, ncols,
                             out.ctypes.data, out.strides[0])


def pack_windows_sparse_native(windows: np.ndarray, n_valid: int,
                               ncols: int, ncap: int):
    """The sparse-N 2-bit pack and N scan of ``core/codec.py:
    pack_windows_sparse`` in one native pass: (lo uint8 [n, mp/4], n_idx
    int32 [ncap]), or None where that function gives None (more than
    ``ncap`` Ns, a contract violation, or ``n*m >= 2**31``).  A batch that
    is not C-contiguous uint8 is copied to one first."""
    lib = _load()
    windows = np.ascontiguousarray(windows, dtype=np.uint8)
    n, m = windows.shape
    if n * m >= 2**31:  # the N indices are int32
        return None
    lo = np.empty((n, -(-m // 8) * 2), np.uint8)
    n_idx = np.full(ncap, np.iinfo(np.int32).max, np.int32)
    rc = lib.fastx_pack_windows_sparse(windows.ctypes.data, n, m, n_valid,
                                       ncols, lo.ctypes.data,
                                       n_idx.ctypes.data, ncap)
    return None if rc < 0 else (lo, n_idx)


def read_fastx_native(path: str) -> Reads:
    """Parse a whole plain (not gzip) FASTA/FASTQ file into ``Reads``."""
    lib = _load()
    err = ctypes.c_char_p()
    h = lib.fastx_parse(path.encode(), ctypes.byref(err))
    if not h:
        msg = err.value.decode() if err.value else "parse failed"
        if "could not open" in msg:
            raise FileNotFoundError(path)
        raise InputFormatError(msg)
    n = lib.fastx_n_reads(h)
    total = lib.fastx_total_bases(h)
    if total == 0:
        lib.fastx_free(h)
        return Reads(buf=np.empty(0, np.uint8),
                     offsets=np.zeros(n + 1, np.int64))
    # offsets are 8*(n+1) bytes: a copy is cheap and decouples the lifetime
    offsets = _copy(lib.fastx_offsets(h), n + 1, np.int64)
    # Zero-copy wrap of the C++ base buffer (a second pass over a multi-GB
    # file only to copy it costs time): the ctypes array borrows the
    # handle's memory and becomes the numpy base; the finalizer frees the
    # handle once the last view of it is gone.
    cbuf = (ctypes.c_uint8 * total).from_address(
        ctypes.addressof(lib.fastx_buf(h).contents)
    )
    weakref.finalize(cbuf, lib.fastx_free, h)
    return Reads(buf=np.frombuffer(cbuf, dtype=np.uint8), offsets=offsets)


def parse_chunk_native(
    data: bytes, is_final: bool
) -> tuple[np.ndarray, np.ndarray, int]:
    """Parse the complete records in ``data`` -> (buf, offsets, consumed).

    ``buf`` holds the records' bases as ordinals, ``offsets`` is
    [n_records + 1] boundaries into it, ``consumed`` is how many input
    bytes were used (a trailing partial record is left for the caller to
    carry into the next chunk).  With ``is_final`` the tail is resolved
    with the streaming iterators' EOF semantics (io/stream.py)."""
    lib = _load()
    err = ctypes.c_char_p()
    consumed = ctypes.c_int64()
    h = lib.fastx_parse_chunk(data, len(data), 1 if is_final else 0,
                              ctypes.byref(consumed), ctypes.byref(err))
    if not h:
        raise InputFormatError(
            err.value.decode() if err.value else "parse failed"
        )
    try:
        n = lib.fastx_n_reads(h)
        total = lib.fastx_total_bases(h)
        buf = _copy(lib.fastx_buf(h), total, np.uint8)
        offsets = _copy(lib.fastx_offsets(h), n + 1, np.int64)
    finally:
        lib.fastx_free(h)
    return buf, offsets, int(consumed.value)
