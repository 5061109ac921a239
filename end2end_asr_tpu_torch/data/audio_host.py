"""The port's host C++ audio library (``csrc/audio_host.cc``): the JAX
package's native WSOLA tempo (with the linear resampler it calls for short
input; the port's NumPy `data.audio.resample` equals that resampler).

Built with ``g++`` at first use into ``build/host/`` at the repository
root, with the JAX package's flags (``-O3 -fPIC -shared -std=c++17``); the
file name carries a hash of the source and the flags, so an edited source
is rebuilt and a stale library is never loaded. Bound with ``ctypes``.

As in the JAX package (``end2end_asr_tpu/native/__init__.py``), a missing
compiler leaves the library unbuilt and the callers take their NumPy
paths; ``ASR_TPU_NO_NATIVE`` set in the environment skips the build (a
library already built still loads, as there), so one variable puts both
packages on the same path. `active()` says which path runs, and
`build_error()` why the library is unavailable (logged once as a
warning, unless ``ASR_TPU_NO_NATIVE`` asked for it).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PKG_DIR, "csrc", "audio_host.cc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "host")
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False
_error = ""


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libaudio_host-{digest.hexdigest()[:12]}.so")


def _build(path: str) -> str:
    """'' on success, else why the build failed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(["g++", *FLAGS, "-o", tmp, SOURCE],
                           capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        return f"g++ did not run: {e}"
    if r.returncode != 0:
        return f"g++ failed:\n{r.stderr}"
    os.replace(tmp, path)
    return ""


def _load():
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = library_path()
        if not os.path.exists(path):
            if os.environ.get("ASR_TPU_NO_NATIVE"):
                _error = "ASR_TPU_NO_NATIVE is set"
                return None
            _error = _build(path)
        if not _error:
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                _error = f"{path} did not load: {e}"
        if _error:
            logging.getLogger("end2end_asr_tpu_torch").warning(
                "%s is unavailable, augmentation's tempo runs the Python "
                "WSOLA: %s", SOURCE, _error)
            return None
        fp = ctypes.POINTER(ctypes.c_float)
        lib.tempo_wsola.restype = ctypes.c_int64
        lib.tempo_wsola.argtypes = [fp, ctypes.c_int64, ctypes.c_float,
                                    ctypes.c_int32, fp, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def active() -> str:
    """The tempo path augmentation runs: "native" (this library) or
    "python" (`data.audio._wsola_py`)."""
    return "native" if available() else "python"


def build_error() -> str:
    """Why the library is unavailable ('' when it loaded)."""
    _load()
    return _error


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def tempo_wsola(y: np.ndarray, tempo: float, sample_rate: int
                ) -> Optional[np.ndarray]:
    L = _load()
    if L is None:
        return None
    y = np.ascontiguousarray(y, np.float32)
    max_out = int(len(y) / tempo) + 16
    out = np.empty(max_out, np.float32)
    n = L.tempo_wsola(_ptr(y), len(y), ctypes.c_float(tempo), sample_rate,
                      _ptr(out), max_out)
    return None if n < 0 else out[:n]
