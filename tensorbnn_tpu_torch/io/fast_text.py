"""ctypes loader for the native text parser and formatter, with a numpy
fallback.

A copy of ``tensorbnn_tpu/io/fast_text.py`` (the port never imports the
JAX package). ``io/native/fast_text.cpp`` is compiled by ``g++`` on first
use into ``tensorbnn_tpu_torch/_build/``, under a name keyed by a hash of
the source, and loaded with ctypes (a plain C interface). Without a
compiler the parser falls back to ``np.loadtxt`` and the writer to
``np.savetxt``, which write the same bytes. This is host text I/O, not a
device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "fast_text.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    digest.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libfast_text_{digest.hexdigest()[:16]}.so"


def start_build() -> Optional[subprocess.Popen]:
    """Starts ``g++`` on the source unless its library exists; returns the
    process (None when there is nothing to build or no compiler). The
    library appears under its final name only once ``finish_build`` has
    seen the process succeed."""
    out = library_path()
    if out.exists():
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.Popen(["g++", *_FLAGS, str(_SRC), "-o", tmp],
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
    except OSError:
        os.unlink(tmp)
        return None
    proc.tmp_path = tmp
    return proc


def finish_build(proc: Optional[subprocess.Popen]) -> bool:
    """Waits for a build from ``start_build``; True when the library
    exists afterwards."""
    if proc is not None:
        try:
            ok = proc.wait(timeout=120) == 0
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            ok = False
        if ok:
            os.replace(proc.tmp_path, library_path())
        else:
            os.unlink(proc.tmp_path)
    return library_path().exists()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not finish_build(start_build()):
            return None
        try:
            lib = ctypes.CDLL(str(library_path()))
        except OSError:
            return None
        lib.tbnn_parse_floats.restype = ctypes.c_long
        lib.tbnn_parse_floats.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_long,
        ]
        lib.tbnn_count_floats.restype = ctypes.c_long
        lib.tbnn_count_floats.argtypes = [ctypes.c_char_p]
        lib.tbnn_format_floats.restype = ctypes.c_long
        lib.tbnn_format_floats.argtypes = [
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.c_long,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the native library built and loaded."""
    return _load() is not None


def load_floats(path: str, dtype=np.float32) -> np.ndarray:
    """Parses all whitespace-separated floats in ``path`` into a flat array
    (the native parser when available, ``np.loadtxt`` otherwise). Raises
    FileNotFoundError on a missing file either way."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} not found.")
    lib = _load()
    if lib is None:
        return np.loadtxt(path, dtype=dtype, ndmin=1).reshape(-1)

    # every value costs >= 2 bytes ("0\n"), so size/2+2 bounds the count
    cap = max(os.path.getsize(path) // 2 + 2, 8)
    out = np.empty(cap, np.float64)
    n = lib.tbnn_parse_floats(path.encode(), out, cap)
    if n == -2:  # capacity miss (pathological formatting); exact recount
        cap = lib.tbnn_count_floats(path.encode())
        out = np.empty(cap, np.float64)
        n = lib.tbnn_parse_floats(path.encode(), out, cap)
    if n < 0:
        raise IOError(f"native parser failed on {path} (code {n})")
    return out[:n].astype(dtype)


def format_floats(arr: np.ndarray) -> Optional[bytes]:
    """Formats an array exactly like ``np.savetxt``'s default ``%.18e``
    (1-D arrays one value per line, 2-D arrays one row per line) with the
    native formatter; None when the native library is unavailable, and
    callers fall back to ``np.savetxt``."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(np.atleast_1d(np.asarray(arr)), np.float64)
    if a.ndim == 1:
        a = a[:, None]
    elif a.ndim > 2:
        a = a.reshape(a.shape[0], -1)
    n = a.size
    cols = a.shape[1] if n else 1
    # each "%.18e" value is <= 25 chars (sign + 1.18 digits + e+XXX for
    # 3-digit exponents) plus a separator
    cap = 32 * n + 16
    buf = ctypes.create_string_buffer(cap)
    wrote = lib.tbnn_format_floats(a.reshape(-1), n, cols, buf, cap)
    if wrote < 0:
        return None
    return buf.raw[:wrote]
