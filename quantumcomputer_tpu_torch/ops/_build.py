"""Build and load the port's CUDA kernels.

Every ``ops/csrc/*.cu`` source compiles with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and the objects
link into ONE shared library with a plain C interface, loaded with ctypes.  The build runs at first use, keyed by a hash of the sources and
flags, into ``build/quantumcomputer_tpu_torch/`` beside the package (a
git-ignored directory), so a fresh checkout builds its own kernels and a
changed source never loads a stale library.  A failed build raises.  A
file lock beside the library lets one process build it while the others
that need it (the processes of a mesh on a fresh checkout) wait and load.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``; the
wrappers in ``ops/fused.py``, ``ops/measure.py``, ``ops/oracle.py``,
``ops/transpose.py``, ``ops/chunkgather.py``, ``ops/probes.py`` and
``ops/sc_step.py`` raise when it is not 0.  A kernel has one entry point
per plane dtype, named ``<kernel>_f32``, ``_f64`` or ``_bf16`` (``entry``).
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "quantumcomputer_tpu_torch",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: Entry-point suffix per plane dtype.
SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}

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


def _run(cmd: list) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}):\n{' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
        )
    return res.stdout + res.stderr


def _build(out: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out[:-3]}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    cus = [s for s in sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cus]
    # One nvcc per source, all at once: the build costs the slowest source.
    with ThreadPoolExecutor(max_workers=len(cus)) as pool:
        logs = list(pool.map(_run, [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(cus, objs)]))
    logs.append(_run([nvcc, "-shared", "-o", f"{tmp}.so", *objs]))
    for o in objs:
        os.remove(o)
    with open(build_log_path(), "w") as f:
        f.write("".join(logs))
    os.replace(f"{tmp}.so", out)  # atomic: a concurrent build never loads a partial file


def _build_once(path: str) -> None:
    """Build the library at `path` unless it exists, one process at a time:
    the first to take the lock builds, the others wait for it and find the
    library built.  The operating system drops the lock of a process that
    dies."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(path[:-3] + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path):
                _build(path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    kernels = (
        # re, im, ops_i, ops_f, groups, ngroups, ftab, ptab, nperm, nops, n, t, naxes, axes_packed, M, vb, ne, stream
        ("qc_fused_segment", ("f32", "f64", "bf16"), [p, p, p, p, p, i64, p, p, i64, i64, i64, i64, i64, i64, i64, i64, i64, p]),
        # the same, then mtab (the matrix groups' tables), stream
        ("qc_fused_matmul", ("f32", "bf16"), [p, p, p, p, p, i64, p, p, i64, i64, i64, i64, i64, i64, i64, i64, i64, p, p]),
        # re, im, cases, ntab, n, M, k, positions, stream
        ("qc_camodc_permute", ("f32", "f64", "bf16"), [p, p, p, i64, i64, i64, i64, i64, p]),
        # re, im, out, nblocks, block, stream
        ("qc_block_sums", ("f32", "f64", "bf16"), [p, p, p, i64, i64, p]),
        # in_re, in_im, out_re, out_im, combo, K, controls_packed, C, log_rows, log_rest, stream
        ("qc_oracle_ladder", ("f32", "f64", "bf16"), [p, p, p, p, p, i64, i64, i64, i64, i64, p]),
        # in_re, in_im, out_re, out_im, ginv, log_rows, log_rest, c_phys, stream
        ("qc_oracle_gather", ("f32", "f64", "bf16"), [p, p, p, p, p, i64, i64, i64, p]),
        # re, im, sched, segs, scratch, S, log_rows, log_rest, c_phys, vec, stream
        ("qc_oracle_cycle", ("f32", "f64", "bf16"), [p, p, p, p, p, i64, i64, i64, i64, i64, p]),
        # re, im, sched, segs, scratch, S, nmasks, log_rows, log_rest, pos_a, pos_b, vec, stream
        ("qc_oracle_cycle_masked", ("f32", "f64", "bf16"), [p, p, p, p, p, i64, i64, i64, i64, i64, i64, i64, p]),
        # re, im, tab, K, C, log_rows, log_rest, strip_bytes, stream
        ("qc_oracle_strip", ("f32", "bf16"), [p, p, p, i64, i64, i64, i64, i64, p]),
        # x, out, B, R, Cc, extra_rows, stream
        ("qc_transpose", ("f32", "f64", "bf16"), [p, p, i64, i64, i64, i64, p]),
        # x, out, B, dim, C, R, m, sign, leg, stream
        ("qc_offset_transpose", ("f32", "f64", "bf16"), [p, p, i64, i64, i64, i64, i64, i64, i64, p]),
        # x, x2, out, a0, a1, a2, mode, B, P, P2, NC, W, v, vpad, stream
        ("qc_chunk_gather", ("f32", "f64", "bf16"), [p, p, p, p, p, p, i64, i64, i64, i64, i64, i64, i64, i64, p]),
        # wr, wi, gr, gi, ct, st, s2, partials, grid, n, stream
        ("qc_sc_branch_sums", ("f32", "f64"), [p, p, p, p, p, p, f64, p, i64, i64, p]),
        # wr, wi, gr, gi, ct, st, s2, partials, nparts, r, force, bit, pcond, grid, n, stream
        ("qc_sc_collapse", ("f32", "f64"), [p, p, p, p, p, p, f64, p, i64, p, i64, p, p, i64, i64, p]),
        # re, im, cost, ph, levels, grid, n, stream
        ("qc_qaoa_phase", ("f32", "f64", "bf16"), [p, p, p, p, i64, i64, i64, p]),
        # re, im, cost, vals, lre, lim, partials, levels, grid, n, stream
        ("qc_qaoa_expect", ("f32", "f64", "bf16"), [p, p, p, p, p, p, p, i64, i64, i64, p]),
        # re, im, lre, lim, cost, vals, ph, partials, levels, write, grid, n, stream
        ("qc_qaoa_cost_grad", ("f32", "f64", "bf16"), [p, p, p, p, p, p, p, p, i64, i64, i64, i64, p]),
        # re, im, lre, lim, partials, nq, t, naxes, axes_packed, qmask, grid, stream
        ("qc_qaoa_mixer_grad", ("f32", "f64", "bf16"), [p, p, p, p, p, i64, i64, i64, i64, i64, i64, p]),
    )
    for kernel, suffixes, argtypes in kernels:
        for suffix in suffixes:
            fn = getattr(lib, f"{kernel}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    for name in ("qc_probe_copy", "qc_probe_roll2", "qc_probe_mxuroll"):
        fn = getattr(lib, name)
        # x, starts, out, dim, nc, W, stream
        fn.argtypes = [p, p, p, i64, i64, i64, p]
        fn.restype = ctypes.c_int
    for name in ("qc_probe_dynroll", "qc_probe_rowroll"):
        fn = getattr(lib, name)
        # x, shifts, out, B, stream
        fn.argtypes = [p, p, p, i64, p]
        fn.restype = ctypes.c_int
    lib.qc_oracle_strip_room.argtypes = [p]  # int64_t* bytes
    lib.qc_oracle_strip_room.restype = ctypes.c_int
    lib.qc_error_string.argtypes = [ctypes.c_int]
    lib.qc_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernel library, built first if needed.  Raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build_once(path)
            lib = ctypes.CDLL(path)
            _bind(lib)
            _lib = lib
        return _lib


def entry(kernel: str, dtype: torch.dtype):
    """The C entry point of `kernel` (e.g. "qc_transpose") for planes of
    `dtype`; raises TypeError for a dtype the kernel has no instance of."""
    fn = getattr(load(), f"{kernel}_{SUFFIX.get(dtype, '?')}", None)
    if fn is None:
        raise TypeError(f"{kernel} has no {dtype} instance")
    return fn


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = load().qc_error_string(err) or b"unknown"
        raise RuntimeError(f"{what}: CUDA error {err} ({msg.decode()})")
