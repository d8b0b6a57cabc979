"""ctypes binding to the native classical layer (native/qc_classical.cpp).

The same C++ shared library the JAX package loads: compiled on first use
with the in-repo Makefile and loaded via ctypes.  It is host code only
(gcd, modpow, continued fractions); nothing here touches the device.  Everything degrades gracefully to the
pure-Python implementations in number_theory.py when no compiler or
library is available (load() returns None).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libqc_classical.so")


def _find_lib() -> Optional[str]:
    """Locate the shared library: a package-local libqc_classical*.so, or
    the dev checkout's native/libqc_classical.so next to the Makefile."""
    import glob as _glob

    cands = [
        c
        for c in _glob.glob(os.path.join(_PKG_DIR, "libqc_classical*.so")) + [_LIB_PATH]
        if os.path.exists(c)
    ]
    if not cands:
        return None
    # Newest build wins: an editable install leaves a package-local copy
    # that would otherwise shadow a freshly rebuilt native/ library.
    return max(cands, key=os.path.getmtime)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        res = subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            capture_output=True,
            timeout=120,
        )
        return res.returncode == 0 and os.path.exists(_LIB_PATH)
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("QC_TPU_DISABLE_NATIVE"):
            return None
        path = _find_lib()
        if path is None:
            # Dev layout only: compile via the in-repo Makefile on first use.
            if not (os.path.isdir(_NATIVE_DIR) and _build()):
                return None
            path = _LIB_PATH
        try:
            lib = ctypes.CDLL(path)
            _bind(lib)
        except (OSError, AttributeError):
            # AttributeError: a stale library predating newer symbols —
            # degrade to pure Python rather than crash at first use.
            return None
        _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.qc_gcd.restype = ctypes.c_uint64
    lib.qc_gcd.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.qc_modpow.restype = ctypes.c_uint64
    lib.qc_modpow.argtypes = [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64]
    lib.qc_cf_denominators.restype = None
    lib.qc_cf_denominators.argtypes = [ctypes.c_double, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)]
    lib.qc_find_period.restype = ctypes.c_int64
    lib.qc_find_period.argtypes = [
        ctypes.c_double,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.qc_mult_order.restype = ctypes.c_uint64
    lib.qc_mult_order.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.qc_modinv.restype = ctypes.c_uint64
    lib.qc_modinv.argtypes = [ctypes.c_uint64, ctypes.c_uint64]


def available() -> bool:
    return load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(
            "native classical layer unavailable (no compiler/library; or "
            "QC_TPU_DISABLE_NATIVE set) — check _native.available() first, "
            "or use the pure-Python twins in algorithms/number_theory.py"
        )
    return lib


def gcd(a: int, b: int) -> int:
    return int(_lib_or_raise().qc_gcd(a, b))


def modpow(base: int, exp: int, mod: int) -> int:
    return int(_lib_or_raise().qc_modpow(base, exp, mod))


def continued_fraction_denominators(omega: float, num_fractions: int) -> List[int]:
    buf = (ctypes.c_uint64 * num_fractions)()
    _lib_or_raise().qc_cf_denominators(omega, num_fractions, buf)
    return list(buf)


def find_period_from_omega(omega: float, a: int, C: int, num_fractions: int, trials: int) -> Optional[int]:
    p = int(_lib_or_raise().qc_find_period(omega, a, C, num_fractions, trials))
    return p if p > 0 else None


def multiplicative_order(a: int, C: int) -> Optional[int]:
    p = int(_lib_or_raise().qc_mult_order(a, C))
    return p if p > 0 else None
