"""What the per-layer metrics read of the program's own spans
(``quantumcomputer_tpu_torch/utils/profiling.py``: ``span_records``).

The program records spans while torch.profiler records, and the
traced slice is the only profiled region of a run, so the records read
after it are exactly the slice's.  A span's ``host_ms`` is its host-clock
time, its ``device_ms`` the time between two CUDA events on the card's
current stream at its start and end.  The readers normalise by the slice's
root spans (``driver.attempt`` or ``sc.attempt``), one an attempt.

Every reader gives None where there is no trace, where the program records
no spans (it has no ``span_records``), where spans were dropped, or where
the count of root spans differs from the slice's attempts.
"""

from __future__ import annotations

from typing import Iterable, List, Optional


def records(obs) -> Optional[list]:
    """The program's span records of the traced slice (read once a run), or None."""
    if obs.trace is None:
        return None
    if not hasattr(obs, "_program_spans"):
        obs._program_spans = _read()
    return obs._program_spans


def _read() -> Optional[list]:
    try:
        from quantumcomputer_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "span_records", None)
    if read is None or profiling.dropped_spans():
        return None
    return read()


def roots(obs, root: str) -> Optional[list]:
    """The root spans named `root`, or None unless there is one an attempt of the slice."""
    recs = records(obs)
    if recs is None:
        return None
    found = [r for r in recs if r.name == root]
    if not found or len(found) != obs.counters.get("attempts"):
        return None
    return found


def total_ms(recs: Iterable, names: tuple, clock: str) -> Optional[float]:
    """Summed `clock` ("host_ms" or "device_ms") of the records named in
    `names`; None where one of them has no such time (work off the card)."""
    values = [getattr(r, clock) for r in recs if r.name in names]
    if any(v is None for v in values):
        return None
    return float(sum(values))


def per_attempt(obs, root: str, names: tuple, clock: str, steps: int = 1) -> Optional[float]:
    """total_ms of `names` over the slice, over its attempts times `steps`."""
    found = roots(obs, root)
    if found is None:
        return None
    t = total_ms(records(obs), names, clock)
    return None if t is None else t / (len(found) * steps)


def self_ms(obs, root: str) -> Optional[float]:
    """Host ms of the root spans less the host ms of their direct
    children, an attempt."""
    found = roots(obs, root)
    if found is None:
        return None
    ids = {r.id for r in found}
    children: List[float] = [r.host_ms for r in records(obs) if r.parent in ids]
    return (sum(r.host_ms for r in found) - sum(children)) / len(found)
