"""Checkpoint/resume: state-vector snapshots between circuit segments.

The counterpart of the JAX package's ``sim/checkpoint.py``, in its file
format, so a snapshot written by one package loads in the other bit for
bit: an ``.npz`` with every plane of the planar state (``planes``), a JSON
metadata blob (``meta``: circuit fingerprint, segment index, segmentation,
register size) and the plane dtype (``plane_dtype``); bf16 ("complex32")
planes are stored as their uint16 bit patterns.  Only pre-measurement states
are snapshotted: find_period always measures fresh (the reference's
no-remeasure semantic, qc_shor.c:299-301).  Resuming with a different
circuit, segmentation, plane count or plane dtype is refused, and the
resume scans from the newest snapshot down to the first valid one.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from quantumcomputer_tpu_torch.models.circuit import Circuit
from quantumcomputer_tpu_torch.utils.logging import get_logger

log = get_logger("checkpoint")

# A snapshot's planes: the port's engines carry two (re, im); the JAX
# package's double-float engine four, which this package never resumes.
PLANES = 2


def circuit_fingerprint(circuit: Circuit) -> str:
    """16 hex digits of a hash of every gate's log form and, for gates with
    an explicit unitary, its matrix (two circuits differing only in their
    matrices must not share a fingerprint)."""
    h = hashlib.sha256()
    for g in circuit:
        h.update(repr(g).encode())
        if g.matrix is not None:
            h.update(repr(g.matrix).encode())
    return h.hexdigest()[:16]


def save_state(path: str, state: torch.Tensor, meta: dict) -> None:
    """Snapshot every plane of a planar state (a host copy) with `meta`,
    through a temporary file renamed into place."""
    host = state.detach().cpu()
    if host.dtype == torch.bfloat16:
        planes, plane_dtype = host.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    else:
        planes = host.numpy()
        plane_dtype = str(planes.dtype)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, planes=planes, meta=json.dumps(meta), plane_dtype=plane_dtype)
    os.replace(tmp, path)


def load_state(path: str, device="cpu") -> Tuple[torch.Tensor, dict]:
    """Load a snapshot onto `device`: (planes, meta).  bf16 bit patterns
    become a bfloat16 tensor; the older format with separate re / im keys
    loads as two planes."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        planar = z["planes"] if "planes" in z else np.stack([z["re"], z["im"]])
        bf16 = "plane_dtype" in z and str(z["plane_dtype"]) == "bfloat16"
    if bf16:
        return torch.from_numpy(planar.view(np.int16).copy()).view(torch.bfloat16).to(device), meta
    return torch.from_numpy(np.array(planar, copy=True)).to(device), meta


def _segment_path(directory: str, seg: int) -> str:
    return os.path.join(directory, f"segment_{seg:05d}.npz")


def all_segments(directory: str) -> list:
    """Segment numbers present in `directory`, ascending (the one parser of
    the segment_NNNNN.npz naming of _segment_path)."""
    if not os.path.isdir(directory):
        return []
    segs = []
    for f in os.listdir(directory):
        if f.startswith("segment_") and f.endswith(".npz"):
            try:
                segs.append(int(f[len("segment_") : -len(".npz")]))
            except ValueError:
                pass
    return sorted(segs)


def latest_segment(directory: str) -> Optional[int]:
    segs = all_segments(directory)
    return segs[-1] if segs else None


def _sharded(engine) -> bool:
    """A sharded engine (parallel/sharded.py): its state is a list of
    shards, snapshotted as one joined planar array."""
    return hasattr(engine, "mesh")


def _resume(engine, fp: str, directory: str, segment_gates: int, nsegments: int):
    """(state, segment) of the newest valid snapshot, or (None, 0).  A
    snapshot is valid when its fingerprint, segment number and segmentation
    match (segment k means k * segment_gates gates applied), and it holds
    the engine's plane count and plane dtype; an unreadable one is skipped
    with a warning, so a stale or corrupt newer file never blocks resume."""
    for seg in reversed(all_segments(directory)):
        if not 0 < seg <= nsegments:
            continue
        path = _segment_path(directory, seg)
        try:
            st, meta = load_state(path, getattr(engine, "device", "cpu"))
        except Exception as e:  # corrupt or unreadable snapshot
            log.warning("failed to load checkpoint %s (%s: %s); trying older segments", path, type(e).__name__, e)
            continue
        if (
            meta.get("fingerprint") == fp
            and meta.get("segment") == seg
            and meta.get("segment_gates") == segment_gates
            and st.shape[0] == PLANES
            and st.dtype == engine.real_dtype
        ):
            return (engine.from_planar(st) if _sharded(engine) else st), seg
        log.warning(
            "checkpoint %s rejected (fingerprint/segmentation/dtype mismatch); trying older segments", path
        )
    return None, 0


def run_with_checkpoints(engine, circuit: Circuit, directory: str, segment_gates: int = 8) -> torch.Tensor:
    """Run a circuit in segments of `segment_gates` gates from
    engine.initial_state(), snapshotting the state after each, and resuming
    from the newest valid snapshot in `directory` where there is one.  Each
    segment is planned on its own, so the result equals an unsegmented run
    within the circuit tolerance, and a resumed run equals an uninterrupted
    segmented one bit for bit.  Returns the state engine.run returned for
    the last segment.  A sharded engine's state is snapshotted joined, in
    the same format, and cut into its shards again on resume."""
    fp = circuit_fingerprint(circuit)
    segments = [circuit[i : i + segment_gates] for i in range(0, len(circuit), segment_gates)]
    state, start = _resume(engine, fp, directory, segment_gates, len(segments))
    if state is None:
        state = engine.initial_state()
    for seg in range(start, len(segments)):
        state = engine.run(tuple(segments[seg]), state)
        save_state(
            _segment_path(directory, seg + 1),
            engine.to_planar(state) if _sharded(engine) else state,
            {"fingerprint": fp, "segment": seg + 1, "segment_gates": segment_gates, "n": engine.register.n},
        )
    return state
