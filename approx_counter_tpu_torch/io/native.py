"""ctypes binding to the port's native FASTA/FASTQ parser.

Port of ``approx_counter_tpu/io/native.py`` for the whole-file and the
chunk parser.  The library is built from ``csrc/fastx_parser.cpp`` by
``g++`` at first use (``kernels/_build.py:host_build``), never when this
module is imported; a missing ``g++`` or a failed build raises, and there is
no fallback to the Python parser.
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
    _LIB = lib
    return lib


def _copy(ptr, n: int, dtype) -> np.ndarray:
    """A numpy copy of ``n`` items at a C pointer (one memmove)."""
    out = np.empty(n, dtype)
    if n:
        ctypes.memmove(out.ctypes.data, ptr, out.nbytes)
    return out


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
