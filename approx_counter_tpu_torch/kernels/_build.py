"""Build the CUDA kernels and the host parser from ``csrc/`` at first use.

Each kernel is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The FASTA/FASTQ parser ``csrc/fastx_parser.cpp`` is host C++,
compiled the same way by ``g++`` (``host_build``), as is the bench's
C++ baseline, an executable (``host_program``).  The two level-NFA
kernels are built once per (k, maxerr) with ``-DKMER`` and ``-DMAXERR``,
the two bit-sliced Myers kernels once per k with ``-DKMER``; the stage
network takes its sizes (the rows and stages) as arguments and is built
once.
Libraries go to ``build/torch_kernels/`` beside the package, named by a hash
of the source, the headers of ``csrc/``, the flags, the compiler's
``--version``, the machine and its C library: a changed source rebuilds, an
unchanged one is reused, and a library cached on one host is rebuilt, not
reused, on a host with another toolchain.  A build writes a temporary file
and renames it into place, so processes that build the same library at once
are safe.  A missing compiler or a failed build raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
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
GXX_FLAGS = ("-O3", "-std=c++14", "-shared", "-fPIC")


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
    """One built library or program: the ctypes handle (None for a
    program), its path, the compiler's output (for a kernel, ptxas's
    register and spill report) and the build's wall seconds (0.0 when
    reused)."""

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


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's FASTA/FASTQ parser is "
                           "built with g++ at first use")
    return gxx


@functools.lru_cache(maxsize=None)
def _toolchain(cc: str) -> bytes:
    """What a library depends on besides its source and flags: the
    compiler's version, the machine and its C library."""
    version = subprocess.run([cc, "--version"], capture_output=True,
                             text=True).stdout
    return "\n".join([version, platform.machine(),
                      *platform.libc_ver()]).encode()


def _compile(compiler, flags: tuple[str, ...], src: Path, stem: str,
             suffix: str = ".so",
             salt: bytes = b"") -> tuple[Path, str, float]:
    """Build ``src`` with ``compiler()`` and ``flags`` into ``BUILD_DIR``,
    or reuse the library built from the same inputs (``salt`` among them)
    by the same toolchain; returns (library, the compiler's output, build
    seconds)."""
    cc = compiler()
    headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(flags).encode() + _toolchain(cc)
        + salt
    ).hexdigest()[:16]
    so = BUILD_DIR / f"{stem}_{digest}{suffix}"
    log_path = so.with_suffix(".log")
    if so.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return so, log, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([cc, *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(cc).name} failed for {src.name} {' '.join(flags)}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.chmod(tmp, 0o755)  # mkstemp's 0600 would stop a program
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    return so, log, seconds


def _cached(key: tuple, make) -> KernelBuild:
    """``make()``'s build, made once per process and key (also across
    threads)."""
    with _locks_guard:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        if key not in _builds:
            _builds[key] = make()
        return _builds[key]


def kernel_build(name: str, defines: tuple[str, ...] = ()) -> KernelBuild:
    """The library of ``csrc/<name>.cu`` built with ``defines``, built on
    first use."""
    def make():
        stem = "_".join([name, *(d.split("=")[-1] for d in defines)])
        so, log, seconds = _compile(_nvcc, NVCC_FLAGS + defines,
                                    SRC_DIR / f"{name}.cu", stem)
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = SIGNATURES[name]
        return KernelBuild(lib, so, log, seconds)

    return _cached((name, defines), make)


def host_build(name: str) -> KernelBuild:
    """The library of the host C++ source ``csrc/<name>.cpp``, built by
    ``g++`` on first use.  The caller declares its functions' types."""
    def make():
        so, log, seconds = _compile(_gxx, GXX_FLAGS, SRC_DIR / f"{name}.cpp",
                                    name)
        return KernelBuild(ctypes.CDLL(str(so)), so, log, seconds)

    return _cached((name, "host"), make)


def _cpu_model() -> bytes:
    """The host CPU's model name, for a build with ``-march=native``."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"model name")),
                        b"")
    except OSError:
        return platform.processor().encode()


def host_program(src: Path, flags: tuple[str, ...]) -> Path:
    """The executable built by ``g++`` from the C++ source ``src`` with
    ``flags`` into ``BUILD_DIR``, on first use; the host CPU's model is
    part of its hash, since ``-march=native`` ties it to that CPU.  A
    missing ``g++`` or a failed build raises."""
    def make():
        exe, log, seconds = _compile(_gxx, flags, src, src.stem, suffix="",
                                     salt=_cpu_model())
        return KernelBuild(None, exe, log, seconds)

    return _cached((str(src), flags), make).so


def _nfa_build(name: str, k: int, maxerr: int) -> KernelBuild:
    if not (2 <= k <= 32 and 0 <= maxerr <= 3):
        raise ValueError(f"no {name} kernel for k={k}, maxerr={maxerr}")
    return kernel_build(name, (f"-DKMER={k}", f"-DMAXERR={maxerr}"))


def nfa_sliced_build(k: int, maxerr: int) -> KernelBuild:
    """The sliced level-NFA library for (k, maxerr), built on first use."""
    return _nfa_build("nfa_sliced", k, maxerr)


def nfa_packed_build(k: int, maxerr: int) -> KernelBuild:
    """The packed level-NFA library for (k, maxerr), built on first use."""
    return _nfa_build("nfa_packed", k, maxerr)


def myers_build(name: str, k: int) -> KernelBuild:
    """The bit-sliced Myers library ``name`` (``bpm_myers``: 2 <= k <= 32,
    ``bpm_packed``: 2 <= k <= 16) for k, built on first use."""
    if name not in ("bpm_myers", "bpm_packed") or not (
            2 <= k <= (32 if name == "bpm_myers" else 16)):
        raise ValueError(f"no {name} kernel for k={k}")
    return kernel_build(name, (f"-DKMER={k}",))
