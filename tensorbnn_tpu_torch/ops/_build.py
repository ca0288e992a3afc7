"""Builds the package's CUDA kernels and loads them with ctypes.

Every ``tensorbnn_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` into
one shared library with a plain C interface, at first use, into
``tensorbnn_tpu_torch/_build/``, keyed by a hash of the sources and the
flags, and loaded with ``ctypes``. No PyTorch header is included, so a
build takes seconds. A missing ``nvcc`` raises: the kernels have no
fallback.

Each C entry point takes device pointers and the CUDA stream as
``c_void_p``, launches on that stream, and returns ``cudaGetLastError()``
(0 on success), which the Python wrapper turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: argtypes of every C entry point, by name
SIGNATURES = {
    # theta, mom, eta, x, y, eps, L, beta (null: untempered), ops, n_ops,
    # prior, n_prior, C, D, H, N, lik, sd, sd_idx (-1: fixed sd), full,
    # threads, smem_bytes, q_out, v_out, lp0, lp1, ut (null: no U-turn
    # recording), stream
    "tbnn_fused_trajectory": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                              _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                              _P, _P, _P, _P, _P, _P],
    # eta, mom, stats, eps, blocks, n_blocks, coupled, sd_idx,
    # C, H, S, n_steps, q_out, v_out, lp0, lp1, stream
    "tbnn_fused_hyper": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P],
    # thetas, x, y, sd, layers (host), n_layers, lik, C, D, N, work,
    # work_floats, ll_out, grad_out, stream
    "tbnn_fused_potential": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                             ctypes.c_longlong, _P, _P, _P],
}

_lib = None
build_seconds = None


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda): "
        "the CUDA kernels of tensorbnn_tpu_torch are built from source and "
        "need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libtbnn_kernels_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compiles the kernels unless a library for these sources exists.
    Returns the library path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, out)
    return out


def load(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(verbose=verbose)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tbnn_error_string.argtypes = [ctypes.c_int]
        lib.tbnn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raises when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = load().tbnn_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
