"""Build the CUDA kernels from ``csrc/`` with nvcc at first use.

Each kernel is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The sliced level NFA is built once per (k, maxerr) with
``-DKMER`` and ``-DMAXERR``; the other kernels take their sizes (k, maxerr
and the pack width, or the stage network's rows and stages) as arguments
and are built once each.  Libraries go to
``build/torch_kernels/`` beside the package, named by a hash of the source,
the headers of ``csrc/`` and the flags, so a changed source rebuilds and an
unchanged one is reused.  A missing ``nvcc`` or a failed build raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


# argtypes of each library's C entry, which has the library's name: the
# tensors' pointers, then ints, then the CUDA stream.
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "nfa_sliced": [_P] * 5 + [_I] * 3 + [_P],   # p0 p1 win valid out | words m W
    "bpm_myers": [_P] * 4 + [_I] * 5 + [_P],    # peq win valid out | C m W k e
    "bpm_packed": [_P] * 4 + [_I] * 6 + [_P],   # words win valid out | n m W k e pack
    "nfa_packed": [_P] * 4 + [_I] * 6 + [_P],
    "sort_stage": [_P] * 2 + [_I] * 3 + [_P],   # in out | rows stages transpose_every
}


class KernelBuild:
    """One built library: the ctypes handle, its path, nvcc's output
    (ptxas register and spill report) and the build's wall seconds (0.0
    when reused)."""

    def __init__(self, lib: ctypes.CDLL, so: Path, log: str, seconds: float):
        self.lib = lib
        self.so = so
        self.log = log
        self.seconds = seconds


_builds: dict[tuple, KernelBuild] = {}
_locks: dict[tuple, threading.Lock] = {}
_locks_guard = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _compile(src: Path, defines: tuple[str, ...], stem: str) -> tuple[Path, str, float]:
    flags = NVCC_FLAGS + defines
    headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(flags).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"{stem}_{digest}.so"
    log_path = so.with_suffix(".log")
    if so.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return so, log, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name} {' '.join(defines)}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    return so, log, seconds


def kernel_build(name: str, defines: tuple[str, ...] = ()) -> KernelBuild:
    """The library of ``csrc/<name>.cu`` built with ``defines``, built on
    first use (once per process and argument set, also across threads)."""
    key = (name, defines)
    with _locks_guard:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        if key not in _builds:
            stem = "_".join([name, *(d.split("=")[-1] for d in defines)])
            so, log, seconds = _compile(SRC_DIR / f"{name}.cu", defines, stem)
            lib = ctypes.CDLL(str(so))
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = SIGNATURES[name]
            _builds[key] = KernelBuild(lib, so, log, seconds)
        return _builds[key]


def nfa_sliced_build(k: int, maxerr: int) -> KernelBuild:
    """The sliced level-NFA library for (k, maxerr), built on first use."""
    if not (2 <= k <= 32 and 0 <= maxerr <= 3):
        raise ValueError(f"no nfa_sliced kernel for k={k}, maxerr={maxerr}")
    return kernel_build("nfa_sliced", (f"-DKMER={k}", f"-DMAXERR={maxerr}"))
