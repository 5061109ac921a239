"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, into ``build/kernels/``
at the repository root (the file name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded). The library is bound with ``ctypes``; every C entry point
returns ``cudaGetLastError()`` after its launch, and the binding raises
when that is not 0.

Nothing here runs at import time: the CPU tests import every module of
the port, and this machine's CPU-only PyTorch has no compiler to call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, List, Optional, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def library_path(source: str) -> str:
    """Path of the built library for csrc/<source>.cu."""
    with open(os.path.join(CSRC_DIR, source + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"lib{source}-{digest.hexdigest()[:12]}.so")


def build(sources: Iterable[str]) -> Dict[str, str]:
    """Compile every source whose library is missing, one nvcc process
    per source, all started together. Returns {source: library path};
    the ptxas report (registers, shared memory, spills) is kept beside
    each library as <library>.log. Raises with nvcc's output on failure.
    """
    paths = {s: library_path(s) for s in sources}
    todo = {s: p for s, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for s, p in todo.items():
        tmp = f"{p}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, s + ".cu")]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, p)
    errors = []
    for s, (proc, tmp, p) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {s}.cu:\n{log}")
            continue
        with open(p + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, p)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def build_log(source: str) -> str:
    """The ptxas report of a built library ('' if it was built by
    another process that kept no log)."""
    p = library_path(source) + ".log"
    if not os.path.exists(p):
        return ""
    with open(p) as f:
        return f.read()


# every binding made, in order (`launch_counts`)
BINDINGS: List["CudaKernel"] = []


class CudaKernel:
    """One C entry point of one csrc library, with its launch count.

    `launches` counts successful launches through this binding only: a
    caller that wants the launches of one run sets it to 0 first. A
    second entry point of the same kernel (`counts`: the binding of the
    first) adds its launches to that binding's count instead.
    """

    def __init__(self, source: str, symbol: str,
                 argtypes: Sequence[type],
                 counts: Optional["CudaKernel"] = None):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.counts = counts or self
        self._fn = None
        self._lib = None
        BINDINGS.append(self)

    def load(self):
        if self._fn is None:
            path = build([self.source])[self.source]
            lib = ctypes.CDLL(path)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        err = self.load()(*args)
        if err != 0:
            msg = self._lib.error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.counts.launches += 1


def launch_counts() -> Dict[str, int]:
    """{symbol: launches} of every counting binding (a snapshot)."""
    return {k.symbol: k.launches for k in BINDINGS if k.counts is k}


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Put the counts of a `launch_counts` snapshot back (a CUDA graph's
    capture records launches that run only at its replays)."""
    for k in BINDINGS:
        if k.symbol in counts:
            k.launches = counts[k.symbol]


P = ctypes.c_void_p
I = ctypes.c_int
U64 = ctypes.c_uint64
L = ctypes.c_long
F32 = ctypes.c_float
