"""Shared arithmetic of the per-layer metrics: a kernel's identifier on the
trace, the state's bytes, and the card's peak bandwidth from peaks.json."""

from __future__ import annotations

from typing import Optional

from portbench.core import short_name

ITEMSIZE = {"complex64": 4, "complex128": 8, "complex32": 2}


def ident(name: str) -> str:
    """A kernel's identifier: its name without `void `, template arguments and arguments."""
    return short_name(name).split("<")[0].strip()


def planes_bytes(n: int, precision: str) -> int:
    """Bytes of a planar (2, 2^n) state."""
    return 2 * (1 << n) * ITEMSIZE[precision]


def hbm_bytes_per_s(obs) -> Optional[float]:
    """The card's published HBM bandwidth, or None for a card peaks.json lacks."""
    if obs.trace is None:
        return None
    import torch

    entry = obs.peaks.get(torch.cuda.get_device_name(0))
    return None if entry is None else float(entry["hbm_bytes_per_s"])


def share(nbytes: float, bw: Optional[float], seconds: float) -> Optional[float]:
    """Roofline share in %: the least time the bytes need over the time taken."""
    if bw is None or seconds <= 0.0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / bw / seconds


def mean(xs) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None
