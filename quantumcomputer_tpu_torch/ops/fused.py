"""Fused multi-gate segments: planner, plain version and CUDA kernel wrapper.

The counterpart of the JAX package's ``ops/pallas_fused.py`` (planner and
``_fused_kernel``) and of ``ops/pallas_gates.py`` (its single-gate entry
points, here one-op segments).  Every gate of a fused segment is applied in
ONE pass over the state: the kernel (``csrc/fused_segment.cu``) loads a tile
into shared memory, applies all of the segment's ops there, and writes the
tile back in place.

A tile holds the low t index bits (contiguous, so memory access coalesces)
plus up to ``TILE_BITS - LOW_BITS`` exposed "axis" bits, one per butterfly
target at or above ``LOW_BITS``; 2^TILE_BITS amplitudes of both planes fill
32 KB of shared memory.  Diagonal ops never constrain the tile: the kernel
computes each element's global index.  The planner packs consecutive
fusable gates until the axis budget is spent; only gates with no op form
(the controlled modular multiply's gather, ``mcphase``) break a run.

Op descriptors (hashable tuples, as in the JAX package):
  ("u1q",   q, (re00, re01, re10, re11, im00, im01, im10, im11))
  ("diag1", q, (re0, im0, re1, im1))
  ("diag2", q_hi, q_lo, (re0..re3, im0..im3))
  ("iqft",  l)           fused H(l) + stage ladder diagonal down to M
  ("u2q",   q_hi, q_lo, (16 re, 16 im)), basis 2*bit(q_hi) + bit(q_lo)

The TPU-only op kinds ``lanemat``/``rowmat``/``xtable`` (MXU rewrites of the
same math) and the opt-in Benes oracle ``camodc_k`` are not ported.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

from quantumcomputer_tpu_torch.models.circuit import (
    DENSE_1Q,
    DIAGONAL_1Q,
    Circuit,
    Gate,
    gate_matrix_1q,
    gate_matrix_2q,
)
from quantumcomputer_tpu_torch.ops import _build
from quantumcomputer_tpu_torch.ops import gates as tops
from quantumcomputer_tpu_torch.sim import statevec as sv

LOW_BITS = 7  # targets below this bit always lie inside a tile
# Tile size per plane dtype: 2^bits amplitudes x 2 planes = 32 KB of shared memory.
TILE_BITS = {torch.float32: 12, torch.float64: 11}

#: Kernel launches made by apply_fused (CUDA tensors only).
LAUNCHES = 0

_KIND = {"u1q": 0, "diag1": 1, "diag2": 2, "iqft": 3, "u2q": 4}
_OPI_STRIDE = 6
_OPF_STRIDE = 32


def gate_to_op(g: Gate) -> Optional[tuple]:
    """The fused-op form of a gate, or None when it has none."""
    name = g.name
    if name in DENSE_1Q:
        u = gate_matrix_1q(g)
        return ("u1q", g.qubits[0], tuple(float(v) for v in np.concatenate([u.real.ravel(), u.imag.ravel()])))
    if name in DIAGONAL_1Q:
        d = np.diagonal(gate_matrix_1q(g))
        return ("diag1", g.qubits[0], (float(d[0].real), float(d[0].imag), float(d[1].real), float(d[1].imag)))
    if name in ("cz", "cphase"):
        d = np.diagonal(gate_matrix_2q(g))
        q_hi, q_lo = g.qubits if g.qubits[0] > g.qubits[1] else (g.qubits[1], g.qubits[0])
        vals = tuple(float(v) for v in np.concatenate([d.real, d.imag]))
        return ("diag2", q_hi, q_lo, vals)
    if name == "iqft_stage":
        return ("iqft", g.qubits[0])
    if name in ("cnot", "swap", "u2q"):
        m4 = gate_matrix_2q(g)
        q_hi, q_lo = g.qubits
        if q_hi < q_lo:
            q_hi, q_lo = q_lo, q_hi
            p = [0, 2, 1, 3]
            m4 = m4[np.ix_(p, p)]
        vals = tuple(float(v) for v in np.concatenate([m4.real.ravel(), m4.imag.ravel()]))
        return ("u2q", q_hi, q_lo, vals)
    return None


def _op_targets(op: tuple) -> List[int]:
    """Butterfly targets of an op (diagonal ops have none)."""
    if op[0] in ("u1q", "iqft"):
        return [op[1]]
    if op[0] == "u2q":
        return [op[1], op[2]]
    return []


def _op_matrix_2x2(op: tuple) -> Optional[np.ndarray]:
    """2x2 complex matrix of a u1q/diag1 op (None for other kinds)."""
    if op[0] == "u1q":
        v = op[2]
        return np.array(v[:4], np.complex128).reshape(2, 2) + 1j * np.array(v[4:], np.complex128).reshape(2, 2)
    if op[0] == "diag1":
        r0, i0, r1, i1 = op[2]
        return np.array([[r0 + 1j * i0, 0.0], [0.0, r1 + 1j * i1]], np.complex128)
    return None


def _matrix_to_op(q: int, m: np.ndarray) -> tuple:
    if abs(m[0, 1]) == 0.0 and abs(m[1, 0]) == 0.0:
        return ("diag1", q, (float(m[0, 0].real), float(m[0, 0].imag), float(m[1, 1].real), float(m[1, 1].imag)))
    return ("u1q", q, tuple(float(v) for v in np.concatenate([m.real.ravel(), m.imag.ravel()])))


def compose_ops(ops) -> tuple:
    """Merge single-qubit ops per qubit inside a fused segment.

    1q gates on distinct qubits commute, so each qubit's u1q/diag1 sequence
    composes into one 2x2 product regardless of interleaving.  Multi-qubit
    ops (diag2, iqft, u2q) flush all pending products."""
    out: list = []
    pending: dict = {}  # q -> (index in out of placeholder, matrix)
    order: list = []

    def flush_all():
        for q in order:
            idx, m = pending[q]
            out[idx] = _matrix_to_op(q, m)
        pending.clear()
        order.clear()

    for op in ops:
        m = _op_matrix_2x2(op)
        if m is None:
            flush_all()
            out.append(op)
            continue
        q = op[1]
        if q in pending:
            idx, acc = pending[q]
            pending[q] = (idx, m @ acc)
        else:
            out.append(None)  # placeholder, filled at flush
            pending[q] = (len(out) - 1, m)
            order.append(q)
    flush_all()
    return tuple(o for o in out if o is not None)


def plan_circuit(circuit: Circuit, n: int, M: int, tile_bits: int = TILE_BITS[torch.float32]):
    """Segment a circuit into fused runs and single gates.

    Returns a list of ("fused", ops_tuple, axes_tuple) / ("single", gate).
    A run closes when its exposed axes would exceed the tile budget
    (tile_bits - LOW_BITS); states of at most 2^tile_bits amplitudes fit
    one tile whole and need no axes."""
    low = LOW_BITS if n > tile_bits else n
    max_axes = tile_bits - LOW_BITS
    segments: List[tuple] = []
    run: List[tuple] = []
    axes: List[int] = []

    def flush():
        nonlocal run, axes
        if run:
            segments.append(("fused", compose_ops(tuple(run)), tuple(sorted(axes, reverse=True))))
        run, axes = [], []

    for g in circuit:
        op = gate_to_op(g)
        if op is None:
            flush()
            segments.append(("single", g))
            continue
        need = [q for q in _op_targets(op) if q >= low and q not in axes]
        if len(axes) + len(need) > max_axes:
            flush()
            need = [q for q in _op_targets(op) if q >= low]
        run.append(op)
        axes.extend(need)
    flush()
    return segments


def tile_geometry(n: int, axes, tile_bits: int) -> Tuple[int, Tuple[int, ...]]:
    """(t, exposed axes >= t ascending) for a segment: the most contiguous
    low bits t such that t plus the exposed axes fit the tile."""
    for t in range(min(n, tile_bits), -1, -1):
        high = tuple(sorted(a for a in axes if a >= t))
        if t + len(high) <= tile_bits:
            return t, high
    raise ValueError(f"axes {axes} do not fit a {tile_bits}-bit tile")


# ---------------------------------------------------------------------------
# Plain version: the same segment, op by op, with the torch gate ops.


def _apply_op(z: torch.Tensor, op: tuple, M: int) -> torch.Tensor:
    kind = op[0]
    if kind == "u1q":
        v = op[2]
        u = np.array(v[:4]).reshape(2, 2) + 1j * np.array(v[4:]).reshape(2, 2)
        return tops.apply_1q(z, u, op[1])
    if kind == "diag1":
        r0, i0, r1, i1 = op[2]
        return tops.apply_diag_1q(z, [r0 + 1j * i0, r1 + 1j * i1], op[1])
    if kind == "diag2":
        v = op[3]
        return tops.apply_diag_2q(z, np.array(v[:4]) + 1j * np.array(v[4:]), op[1], op[2])
    if kind == "iqft":
        return tops.apply_iqft_stage(z, op[1], M)
    if kind == "u2q":
        v = op[3]
        m4 = np.array(v[:16]).reshape(4, 4) + 1j * np.array(v[16:]).reshape(4, 4)
        return tops.apply_2q(z, m4, op[1], op[2])
    raise ValueError(f"unknown fused op {op}")


def plain_segment(planar: torch.Tensor, ops: tuple, M: int) -> torch.Tensor:
    """The segment's unitary applied op by op with plain torch ops; returns
    a new planar tensor (the kernel's spec)."""
    z = sv.to_complex(planar)
    for op in ops:
        z = _apply_op(z, op, M)
    return torch.stack([z.real, z.imag])


# ---------------------------------------------------------------------------
# CUDA kernel wrapper.


@lru_cache(maxsize=256)
def _descriptor(ops: tuple, axes: tuple, n: int, M: int, tile_bits: int, device: torch.device):
    """Tile geometry and the device-side op records of one segment."""
    t, high = tile_geometry(n, axes, tile_bits)

    def local(q: int) -> int:
        if q < t:
            return q
        if q not in high:
            raise ValueError(f"target qubit {q} is neither below t={t} nor an exposed axis {high}")
        return t + high.index(q)

    ops_i = np.zeros((len(ops), _OPI_STRIDE), np.int32)
    ops_f = np.zeros((len(ops), _OPF_STRIDE), np.float64)
    for k, op in enumerate(ops):
        ops_i[k, 0] = _KIND[op[0]]
        ops_i[k, 1] = op[1]
        if op[0] in ("diag2", "u2q"):
            ops_i[k, 2] = op[2]
        targets = _op_targets(op)
        for j, q in enumerate(targets):
            ops_i[k, 3 + j] = local(q)
        vals = op[-1] if op[0] != "iqft" else ()
        ops_f[k, : len(vals)] = vals
    return (
        t,
        high,
        torch.from_numpy(ops_i).to(device),
        torch.from_numpy(ops_f).to(device),
    )


def _check_planar(planar: torch.Tensor) -> int:
    n = sv.num_qubits(planar)
    if planar.dtype not in TILE_BITS:
        raise TypeError(f"planar state must be float32 or float64, got {planar.dtype}")
    if not planar.is_contiguous():
        raise ValueError("planar state must be contiguous")
    return n


def apply_fused(planar: torch.Tensor, ops: tuple, axes: tuple, M: int) -> torch.Tensor:
    """Apply one fused segment to a (2, 2^n) planar state IN PLACE (the
    counterpart of the JAX kernel's input/output aliasing) and return it.

    A CUDA tensor goes through the kernel; a CPU tensor through
    plain_segment.  Any other device raises."""
    global LAUNCHES
    n = _check_planar(planar)
    if planar.device.type == "cpu":
        return planar.copy_(plain_segment(planar, ops, M))
    if planar.device.type != "cuda":
        raise ValueError(f"no fused-segment path for device {planar.device}")
    if not ops:
        return planar
    t, high, ops_i, ops_f = _descriptor(
        tuple(ops), tuple(axes), n, M, TILE_BITS[planar.dtype], planar.device
    )
    lib = _build.load()
    fn = lib.qc_fused_segment_f32 if planar.dtype == torch.float32 else lib.qc_fused_segment_f64
    packed = sum(a << (8 * i) for i, a in enumerate(high))
    with torch.cuda.device(planar.device):
        err = fn(
            planar[0].data_ptr(), planar[1].data_ptr(), ops_i.data_ptr(), ops_f.data_ptr(),
            len(ops), n, t, len(high), packed, M, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "fused_segment")
    LAUNCHES += 1
    return planar
