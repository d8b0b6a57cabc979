"""Build and load the port's CUDA kernels.

Every ``ops/csrc/*.cu`` source compiles with ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library with a plain C interface, loaded with
ctypes.  The build runs at first use, keyed by a hash of the sources and
flags, into ``build/quantumcomputer_tpu_torch/`` beside the package (a
git-ignored directory), so a fresh checkout builds its own kernels and a
changed source never loads a stale library.  A failed build raises.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``; the
wrappers in ``ops/fused.py`` and ``ops/measure.py`` raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "quantumcomputer_tpu_torch",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> list:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")) + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")


def library_path() -> str:
    """Path of the library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libqc_kernels_{h.hexdigest()[:16]}.so")


def build_log_path() -> str:
    return library_path()[:-3] + ".log"


def _build(out: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out[:-3]}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[s for s in sources() if s.endswith(".cu")]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}):\n{' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
        )
    with open(build_log_path(), "w") as f:
        f.write(res.stdout + res.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file


def _bind(lib: ctypes.CDLL) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for name in ("qc_fused_segment_f32", "qc_fused_segment_f64"):
        fn = getattr(lib, name)
        # re, im, ops_i, ops_f, nops, n, t, naxes, axes_packed, M, stream
        fn.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i64, p]
        fn.restype = ctypes.c_int
    for name in ("qc_block_sums_f32", "qc_block_sums_f64"):
        fn = getattr(lib, name)
        # re, im, out, nblocks, block, stream
        fn.argtypes = [p, p, p, i64, i64, p]
        fn.restype = ctypes.c_int
    lib.qc_error_string.argtypes = [ctypes.c_int]
    lib.qc_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernel library, built first if needed.  Raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            _bind(lib)
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = load().qc_error_string(err) or b"unknown"
        raise RuntimeError(f"{what}: CUDA error {err} ({msg.decode()})")
