"""Fused multi-gate segments: planner, plain version and CUDA kernel wrapper.

The counterpart of the JAX package's ``ops/pallas_fused.py`` (planner and
``_fused_kernel``) and of ``ops/pallas_gates.py`` (its single-gate entry
points, here one-op segments).  Every gate of a fused segment is applied in
ONE pass over the state: the kernel (``csrc/fused_segment.cu``) loads a tile
into shared memory, applies all of the segment's ops there, a register
group of ops at a time (``host_descriptor``), and writes the tile back in
place.

A tile holds the low t index bits (contiguous, so memory access coalesces)
plus up to ``TILE_BITS - LOW_BITS`` exposed "axis" bits, one per butterfly
target at or above ``LOW_BITS``; 2^TILE_BITS amplitudes of both planes fill
32 KB of shared memory.  Diagonal ops never constrain the tile: the kernel
computes each element's global index.  The planner packs consecutive
fusable gates until the axis budget is spent; only gates with no op form
(``mcphase``, and the controlled modular multiply unless the oracle is
fused) break a run.

Op descriptors (hashable tuples, as in the JAX package):
  ("u1q",    q, (re00, re01, re10, re11, im00, im01, im10, im11))
  ("diag1",  q, (re0, im0, re1, im1))
  ("diag2",  q_hi, q_lo, (re0..re3, im0..im3))
  ("iqft",   l)           fused H(l) + stage ladder diagonal down to M
  ("u2q",    q_hi, q_lo, (16 re, 16 im)), basis 2*bit(q_hi) + bit(q_lo)
  ("camodc", c, C, A)     where bit c is 1, the work register [0, M) is
                          permuted f -> A*f mod C (f < C): the oracle of
                          ``--oracle benes`` (``fuse_oracle=True``), and
                          a lone oracle gate's one-op segment

A camodc op permutes whole 2^M-element work blocks, so its segment's tile
holds at least the low M bits: its tile budget is max(TILE_BITS, M) bits,
at most 2^13 amplitudes.  plain_segment applies the op as the JAX kernel
does, as the 2M - 1 masked exchange stages of a Benes network
(``ops/benes.py``).  A segment whose every op is a camodc op is one
permutation of each work block, chosen by the block's control bits: the
router (``kernel_body``) sends it to a kernel of its own
(``csrc/camodc_permute.cu``), one gather a moved element through "case
tables" composed once a segment (``permute_descriptor``; plain version
``plain_permute``); a segment that mixes camodc ops with other
ops gathers each work block through the inverse permutation inside the
fused kernel.  All compute the same function.

The case tables are built with torch ops on the device that uses them, the
CPU included (``_case_tables``, cached), and held element for element to
``permute_descriptor``, the host specification.  A lone standard-layout
``camodc`` gate (the default ``--oracle gather``, where the oracle is no
fused op) runs as the one-op camodc segment (``gate_segment`` with the
work register's M), through the same router.

bfloat16 planes ("complex32") take the kernel's bf16 instance: every op
computes in float32 and each amplitude is rounded to bf16 once per pass,
at the store, as the JAX kernel does; its tables are those of a float32
segment, its register groups hold 2^5 amplitudes a thread (2^4 in a
segment with a camodc or matrix op).  The plain version computes the same
in complex64 and rounds once.  The camodc permutation moves bf16 elements
as they are.

Matrix groups.  As the JAX kernel does, apply_fused rewrites a bf16 segment
(``GROUP_DTYPES``: the JAX kernel also groups at float32, where the port
measured the butterfly form faster; states of at least 2^13 amplitudes) with
``matmul_group_ops``: a chain of ops on the lane bits 0-6 becomes one
128 x 128 product (``lanemat``), a chain on the row bits 7-12 one 64 x 64
product on each 64-row x 128-lane group (``rowmat``), and the iQFT row
stages' lane-cross phases one (64, 128) phase table (``xtable``).  The
kernel runs the products on the tensor cores (``csrc/fused_matmul.cu``,
wgmma: 3xTF32 at float32; at bf16 the activations rounded to bf16 against a
hi + lo bf16 split of the table, as the JAX kernel's MXU dots), its tables
packed once a segment by ``matrix_tables`` (pre-split, in the products'
shared-memory layout, 16 KB chunks) and streamed through a shared-memory
ring; an xtable right after a rowmat rides in the rowmat's store.  A segment with
a matrix group takes a 2^13-amplitude tile, and one with a rowmat or
xtable holds all of bits 0-12 in it: the planner (``group=True``) cuts a
run where that would not hold.  ``apply_segment`` and ``plain_ops`` take an
explicit op list, grouped or not.
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
from quantumcomputer_tpu_torch.ops.benes import benes_route
from quantumcomputer_tpu_torch.sim import statevec as sv
from quantumcomputer_tpu_torch.utils import profiling

LOW_BITS = 7  # targets below this bit always lie inside a tile
# Tile size per plane dtype: 2^bits amplitudes x 2 planes = 32 KB of shared
# memory in the compute dtype (a bf16 tile is computed as a float32 one).
TILE_BITS = {torch.float32: 12, torch.float64: 11, torch.bfloat16: 12}
# The kernel's register groups: a thread holds 2^group_bits(...) amplitudes
# of a tile, the low VEC_BITS index bits (16 bytes of a compute-dtype plane)
# plus the rest, and applies every op of a group to them.
VEC_BITS = {torch.float32: 2, torch.float64: 1, torch.bfloat16: 2}

#: Oracle ops in one segment, as in the JAX package (its bound on the VMEM of
#: the Benes mask tables); it groups the Shor circuit's oracles two to a segment.
MAX_CAMODC_PER_SEGMENT = 2

#: Kernel launches made by apply_fused / apply_segment (CUDA tensors only),
#: those of them whose segment holds a camodc op (either kernel), those of
#: the camodc permutation kernel (every op a camodc op, ``kernel_body``), and
#: those whose segment holds a matrix group (lanemat, rowmat or xtable).
LAUNCHES = 0
CAMODC_LAUNCHES = 0
PERMUTE_LAUNCHES = 0
MATMUL_LAUNCHES = 0

#: Plane dtypes whose segments apply_fused groups into matrix products.
#: The JAX kernel groups at float32 and bf16.  The port groups at bf16 only:
#: with the wgmma instance the complex64 m_high flagship (n = 28) took
#: 25.61 / 25.60 ms with its float32 segments grouped against 22.18 / 22.25 ms
#: in the butterfly form (NVIDIA H100 80GB HBM3, 700 W;
#: chip_smoke.time_flagship_forms, PERF.md section 6), so float32 keeps
#: the butterfly form; complex32 grouped took 15.92 / 15.83 ms against
#: 16.63 / 16.62.
GROUP_DTYPES = (torch.bfloat16,)
#: Index bits of a tile that holds whole 64-row x 128-lane groups; a
#: segment with a matrix group takes this tile.
ROW_TILE_BITS = 13
MATRIX_KINDS = ("lanemat", "rowmat", "xtable")

_KIND = {"u1q": 0, "diag1": 1, "diag2": 2, "iqft": 3, "u2q": 4, "camodc": 5, "lanemat": 6, "rowmat": 7, "xtable": 8}
# Op record: kind, q1, q2, slot of q1, slot of q2 (-1: not a group slot),
# then an iQFT op's F_axes and F_low offsets in ftab (-1: none) and 1 when
# it has a phase.  A camodc op's: kind, control, M, the control's tile-local
# position (-1: a tile-base bit), -1, its table's offset in ptab, -1, -1.
# A matrix op's: kind, -1, -1, -1, its table's MAT_CHUNK-byte chunks in
# mtab, their byte offset, 1 when the table is real, and 1 on a rowmat and
# the xtable right after it, which the rowmat applies before its store.
_OPI_STRIDE = 8
OPF_STRIDE = 32
#: Op kinds whose float record is their gate_to_op values (apply_segment_values).
VALUED_KINDS = ("u1q", "diag1", "diag2", "u2q")
_GRP_STRIDE = 8  # op_begin, op_end, then the group's extra slot positions


def gate_to_op(g: Gate, M: int = 0, fuse_oracle: bool = False) -> Optional[tuple]:
    """The fused-op form of a gate, or None when it has none.  The
    controlled modular multiply has one only with fuse_oracle and
    1 <= M <= 13, the JAX package's condition."""
    name = g.name
    if name == "camodc" and fuse_oracle and 1 <= M <= 13:
        C, atox = g.meta
        return ("camodc", g.qubits[0], int(C), int(atox % C))
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


# ---------------------------------------------------------------------------
# Matrix groups: the JAX package's matmul_group_ops (pallas_fused.py:187-410),
# copied as it is.

LANE = 128
LANEMAT_MIN = 2  # lane-class ops per segment before they fuse to one matrix product
ROWMAT_MIN = 2
_SQRT1_2 = 1.0 / np.sqrt(2.0)
_H2 = np.array([[_SQRT1_2, _SQRT1_2], [_SQRT1_2, -_SQRT1_2]])


def _expand_1q(u: np.ndarray, bit: int, nbits: int) -> np.ndarray:
    """u acting on `bit` of an nbits-wide index as a dense 2^nbits matrix."""
    hi = np.eye(1 << (nbits - 1 - bit), dtype=np.complex128)
    lo = np.eye(1 << bit, dtype=np.complex128)
    return np.kron(hi, np.kron(u, lo))


def _expand_2q(u4: np.ndarray, b_hi: int, b_lo: int, nbits: int) -> np.ndarray:
    """u4 (basis 2*bit(b_hi)+bit(b_lo)) acting on two bits of an nbits-wide
    index as a dense 2^nbits matrix."""
    dim = 1 << nbits
    w = np.zeros((dim, dim), np.complex128)
    i = np.arange(dim)
    i_hi = (i >> b_hi) & 1
    i_lo = (i >> b_lo) & 1
    base = i & ~((1 << b_hi) | (1 << b_lo))
    for j_hi in (0, 1):
        for j_lo in (0, 1):
            j = base | (j_hi << b_hi) | (j_lo << b_lo)
            w[i, j] = u4[2 * i_hi + i_lo, 2 * j_hi + j_lo]
    return w


def _op_matrix_4x4(op: tuple):
    """(q_hi, q_lo, 4x4 complex) of a u2q op, or None."""
    if op[0] != "u2q":
        return None
    v = op[3]
    m = np.array(v[:16], np.float64).reshape(4, 4) + 1j * np.array(v[16:], np.float64).reshape(4, 4)
    return op[1], op[2], m


def _lane_op_matrix(op: tuple, M: int) -> Optional[np.ndarray]:
    """128x128 matrix of an op supported entirely on the lane bits [0, 7),
    or None.  Composition order is preserved, so non-commuting lane ops
    (e.g. iQFT stages) chain exactly."""
    m2 = _op_matrix_2x2(op)
    if m2 is not None:
        return _expand_1q(m2, op[1], 7) if op[1] <= 6 else None
    if op[0] == "diag2" and op[1] <= 6 and op[2] <= 6:
        v = op[3]
        d = np.array(v[:4]) + 1j * np.array(v[4:])
        lane = np.arange(LANE)
        return np.diag(d[2 * ((lane >> op[1]) & 1) + ((lane >> op[2]) & 1)])
    if op[0] == "u2q" and op[1] <= 6:
        q_hi, q_lo, m4 = _op_matrix_4x4(op)
        return _expand_2q(m4, q_hi, q_lo, 7)
    if op[0] == "iqft" and op[1] <= 6:
        # H(l) then the closed-form ladder diagonal down to M: the whole
        # stage lives on lane bits (the 2^(l+1)-point no-swap inverse QFT block).
        l = op[1]
        h = _expand_1q(_H2, l, 7)
        lane = np.arange(LANE)
        mask = (1 << l) - (1 << M) if l > M else 0
        theta = np.pi * (lane & mask) / float(1 << l)
        phase = np.where(((lane >> l) & 1) == 1, np.exp(1j * theta), 1.0)
        return np.diag(phase) @ h
    return None


def _row_op_matrix(op: tuple, M: int) -> Optional[np.ndarray]:
    """64x64 matrix of an op supported entirely on row bits [7, 13)."""
    m2 = _op_matrix_2x2(op)
    if m2 is not None:
        return _expand_1q(m2, op[1] - 7, 6) if 7 <= op[1] <= 12 else None
    if op[0] == "diag2" and 7 <= op[2] and op[1] <= 12:
        v = op[3]
        d = np.array(v[:4]) + 1j * np.array(v[4:])
        r = np.arange(64)
        return np.diag(d[2 * ((r >> (op[1] - 7)) & 1) + ((r >> (op[2] - 7)) & 1)])
    if op[0] == "u2q" and 7 <= op[2] and op[1] <= 12:
        q_hi, q_lo, m4 = _op_matrix_4x4(op)
        return _expand_2q(m4, q_hi - 7, q_lo - 7, 6)
    if op[0] == "iqft" and 7 <= op[1] <= 12 and M >= 7:
        l = op[1]
        h = _expand_1q(_H2, l - 7, 6)
        r = np.arange(64)
        mask = ((1 << l) - (1 << M)) >> 7
        theta = np.pi * (r & mask) / float(1 << (l - 7))
        phase = np.where(((r >> (l - 7)) & 1) == 1, np.exp(1j * theta), 1.0)
        return np.diag(phase) @ h
    return None


def _is_diagonal_op(op: tuple) -> bool:
    return op[0] in ("diag1", "diag2")


def _is_neutral(op: tuple) -> bool:
    """Ops on bits >= 13 only: commute with both lane and row chains, so
    they pass through a pending group without flushing it."""
    if op[0] in ("u1q", "diag1"):
        return op[1] >= 13
    if op[0] == "diag2":
        return op[2] >= 13
    if op[0] == "u2q":
        return op[2] >= 13  # q_hi > q_lo, so both qubits are axis-class
    return False


def _row_stage_parts(op: tuple, M: int):
    """Split an iQFT row stage (7 <= l <= 12, M < 7) into a 64x64 row
    operator (H(l) + the ROW part of the ladder diagonal) plus the
    lane-cross residual angles theta(row6, lane): the stage's phase on
    bit_l==1 elements factorizes exp(i(theta_row + theta_lane)), and the
    lane part commutes with every other row/lane-diagonal op, so ALL
    stages' residuals combine into one (64, 128) phase table."""
    l = op[1]
    h = _expand_1q(_H2, l - 7, 6)
    r = np.arange(64)
    rowmask = ((1 << l) - (1 << M)) >> 7
    th_row = np.pi * (r & rowmask) / float(1 << (l - 7))
    gate = ((r >> (l - 7)) & 1) == 1
    w = np.diag(np.where(gate, np.exp(1j * th_row), 1.0)) @ h
    lanemask = ((1 << l) - (1 << M)) & (LANE - 1)
    lane = np.arange(LANE)
    th_lane = np.pi * (lane & lanemask) / float(1 << l)
    theta = np.where(gate[:, None], th_lane[None, :], 0.0)  # (64, 128)
    return w, theta


def matmul_group_ops(ops, M: int):
    """Rewrite a segment's lane-supported (bits < 7) and row-supported
    (bits 7..12) op chains into single matrix products.

    Ops on disjoint bit classes commute, so the lane chain composes (in
    order) into ONE 128x128 operator on the lane index and the row chain
    into ONE 64x64 operator per 64-row group; this includes the iQFT's
    lane-stage suffix and lane-local controlled phases.  iQFT row stages
    (whose ladder reaches into the lanes) split into a row operator + a
    lane-cross residual; all residuals in a chain combine into ONE
    (64, 128) phase-table multiply.  Returns (ops', matrices) with
    matrices[i] the float32 table of table index i: ("lanemat" | "rowmat",
    i, real_only) holds (2, n, n) re/im of W^T (the product is x @ W^T,
    rows: V @ x with V = table^T), ("xtable", i) holds (2, 64, 128) cos/sin."""
    out: list = []
    mats: list = []
    lane: list = []  # (op, matrix)
    rows: list = []
    xtheta = np.zeros((64, LANE))  # accumulated lane-cross residual angles
    has_xtheta = False
    xtheta_bits: set = set()  # row qubits the residual is conditioned on

    def emit_rows():
        nonlocal has_xtheta, xtheta
        _emit(rows, 64, ROWMAT_MIN)
        rows.clear()
        if has_xtheta:
            tab = np.stack([np.cos(xtheta), np.sin(xtheta)]).astype(np.float32)
            out.append(("xtable", len(mats)))
            mats.append(tab)
            xtheta = np.zeros((64, LANE))
            has_xtheta = False
        xtheta_bits.clear()

    def _emit(group, size, min_ops):
        if not group:
            return
        has_iqft = any(op[0] == "iqft" for op, _ in group)
        if len(group) < min_ops and not has_iqft:
            out.extend(op for op, _ in group)
            return
        w = np.eye(size, dtype=np.complex128)
        for _, wg in group:
            w = wg @ w
        wt = w.T  # the product is out = x @ W^T
        real_only = bool(np.all(np.abs(wt.imag) < 1e-300))
        tab = np.stack([wt.real, wt.imag]).astype(np.float32)
        out.append(("lanemat" if size == LANE else "rowmat", len(mats), real_only))
        mats.append(tab)

    def flush():
        emit_rows()
        _emit(lane, LANE, LANEMAT_MIN)
        lane.clear()

    for op in ops:
        wl = _lane_op_matrix(op, M)
        if wl is not None:
            # A pending lane-cross residual is diagonal in the lanes; a
            # dense lane op does not commute with it: flush rows first.
            if has_xtheta and not _is_diagonal_op(op):
                emit_rows()
            lane.append((op, wl))
            continue
        wr = _row_op_matrix(op, M)
        if wr is not None:
            # A dense row op on a bit the pending residual is conditioned
            # on cannot be reordered past it: flush first.
            op_bits = (op[1], op[2]) if op[0] == "u2q" else (op[1],)
            if not _is_diagonal_op(op) and any(q in xtheta_bits for q in op_bits):
                emit_rows()
            rows.append((op, wr))
            continue
        if op[0] == "iqft" and 7 <= op[1] <= 12 and M < 7:
            # The residual is lane-diagonal: it must not be reordered past a
            # pending DENSE lane chain that precedes it: flush lanes first.
            if any(not _is_diagonal_op(o) for o, _ in lane):
                _emit(lane, LANE, LANEMAT_MIN)
                lane.clear()
            if op[1] in xtheta_bits:  # repeated stage on the same bit
                emit_rows()
            w, theta = _row_stage_parts(op, M)
            rows.append((op, w))
            xtheta = xtheta + theta
            has_xtheta = True
            xtheta_bits.add(op[1])
            continue
        if _is_neutral(op):
            out.append(op)
            continue
        flush()
        out.append(op)
    flush()
    return tuple(out), mats


def _low_class(op: tuple) -> bool:
    """True for an op that matmul_group_ops may take into a lane or row
    chain: every bit it touches lies below ROW_TILE_BITS."""
    if op[0] in ("u1q", "diag1", "iqft"):
        return op[1] < ROW_TILE_BITS
    if op[0] in ("diag2", "u2q"):
        return op[1] < ROW_TILE_BITS  # q_hi > q_lo
    return False


@lru_cache(maxsize=256)
def group_ops(ops: tuple, M: int) -> Tuple[tuple, tuple]:
    """matmul_group_ops of a segment, cached: (ops', tables), the tables
    read-only float32 arrays."""
    if not any(_low_class(op) for op in ops):
        return tuple(ops), ()
    gops, mats = matmul_group_ops(tuple(ops), M)
    for m in mats:
        m.flags.writeable = False
    return gops, tuple(mats)


def groups(dtype: torch.dtype, n: int) -> bool:
    """Whether apply_fused groups the segments of an n-qubit state of plane
    dtype `dtype`: planes of a dtype in GROUP_DTYPES (bf16) of at least
    2^ROW_TILE_BITS amplitudes; the JAX kernel, which runs from n = 13 on,
    groups its float32 and bf16 segments."""
    return dtype in GROUP_DTYPES and n >= ROW_TILE_BITS


def matrix_groups(ops: tuple, M: int, dtype: torch.dtype, n: int) -> int:
    """The matrix-group ops (MATRIX_KINDS) of a segment as apply_fused
    applied it: the grouping segment_ops gives, read from group_ops' cache,
    which the segment's launch (_descriptor) or its plain version filled;
    0 for a segment in its butterfly form."""
    return sum(op[0] in MATRIX_KINDS for op in segment_ops(tuple(ops), M, dtype, n)[0])


def _has_rows(ops) -> bool:
    return any(op[0] in ("rowmat", "xtable") for op in ops)


def group_bits(dtype: torch.dtype, ops) -> int:
    """log2 of the amplitudes a kernel thread holds in a register group of
    this segment: 2^5 in the bf16 instance's direct form (128 threads a
    block, csrc/fused_segment.cuh's is_direct), which takes every bf16
    segment without a camodc or matrix op; 2^4 at float32 and in the other
    bf16 instances; 2^3 at float64."""
    if dtype == torch.float64:
        return 3
    if dtype == torch.bfloat16 and not any(op[0] == "camodc" or op[0] in MATRIX_KINDS for op in ops):
        return 5
    return 4


def segment_tile_bits(ops, M: int, tile_bits: int, axes=()) -> int:
    """A segment's tile budget: tile_bits; max(tile_bits, M) when it holds a
    camodc op, whose tile must hold whole 2^M-element work blocks; and
    ROW_TILE_BITS when it holds a matrix group, or when its exposed axes do
    not fit tile_bits (a run of a grouping plan that keeps bits 0-12 in its
    tile)."""
    bits = max(tile_bits, M) if any(op[0] == "camodc" for op in ops) else tile_bits
    if any(op[0] in MATRIX_KINDS for op in ops) or len(axes) > bits - LOW_BITS:
        bits = max(bits, ROW_TILE_BITS)
    return bits


def plan_circuit(
    circuit: Circuit,
    n: int,
    M: int,
    tile_bits: int = TILE_BITS[torch.float32],
    fuse_oracle: bool = False,
    group: bool = False,
):
    """Segment a circuit into fused runs and single gates.

    Returns a list of ("fused", ops_tuple, axes_tuple) / ("single", gate).
    A run closes when its exposed axes would exceed the tile budget
    (tile_bits - LOW_BITS); states of at most 2^tile_bits amplitudes fit
    one tile whole and need no axes.  With fuse_oracle the controlled
    modular multiplies become camodc ops (gate_to_op), at most
    MAX_CAMODC_PER_SEGMENT to a run; a run that holds one keeps its low
    max(LOW_BITS, M) bits in the tile, within max(tile_bits, M) tile bits.

    With group (the segments of a plane dtype that apply_fused groups,
    ``groups``) a run may also hold any targets below ROW_TILE_BITS, in a
    tile of bits 0-12; and a run closes where its matrix groups would need
    a tile it cannot have: a rowmat or xtable beside an exposed axis at or
    above ROW_TILE_BITS, or any matrix group beside a camodc op."""
    low = LOW_BITS if n > tile_bits else n
    perm_low = max(LOW_BITS, M)
    group = group and n >= ROW_TILE_BITS
    segments: List[tuple] = []
    run: List[tuple] = []
    axes: List[int] = []
    n_camodc = 0

    def fits(axes, camodc: bool, ops) -> bool:
        row_tile = group and all(a < ROW_TILE_BITS for a in axes)
        if camodc:
            ok = n <= tile_bits or perm_low + sum(a >= perm_low for a in axes) <= max(tile_bits, M) or row_tile
        else:
            ok = len(axes) <= tile_bits - LOW_BITS or row_tile
        if not ok or not group or (row_tile and not camodc) or not any(_low_class(op) for op in ops):
            return ok
        gops = group_ops(tuple(compose_ops(tuple(ops))), M)[0]
        if camodc:
            return not any(op[0] in MATRIX_KINDS for op in gops)
        return not _has_rows(gops)

    def flush():
        nonlocal run, axes, n_camodc
        if run:
            segments.append(("fused", compose_ops(tuple(run)), tuple(sorted(axes, reverse=True))))
        run, axes, n_camodc = [], [], 0

    for g in circuit:
        op = gate_to_op(g, M, fuse_oracle)
        if op is None:
            flush()
            segments.append(("single", g))
            continue
        camodc = op[0] == "camodc"
        need = [q for q in _op_targets(op) if q >= low and q not in axes]
        if (camodc and n_camodc >= MAX_CAMODC_PER_SEGMENT) or not fits(axes + need, camodc or n_camodc > 0, run + [op]):
            flush()
            need = [q for q in _op_targets(op) if q >= low]
        run.append(op)
        axes.extend(need)
        n_camodc += camodc
    flush()
    return segments


def gate_segment(g: Gate, n: int, tile_bits: int, M: int = 0) -> Optional[Tuple[tuple, tuple]]:
    """(ops, axes) of one gate as a one-op segment, or None when the gate
    has no op form: the single-gate entry points of the JAX package's
    ``pallas_gates``, which run each gate as a one-op fused segment.  A
    standard-layout camodc gate on an M-bit work register is the one-op
    camodc segment where gate_to_op gives it one (1 <= M <= 13); a camodc
    op exposes no axis, so it takes no planning (a new gate of every
    attempt costs no plan_circuit)."""
    op = gate_to_op(g, M, fuse_oracle=True)
    if op is None:
        return None
    if op[0] == "camodc":
        return (op,), ()
    ((_, ops, axes),) = plan_circuit((g,), n, 0, tile_bits)
    return ops, axes


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


def _matrix_planes(xr, xi, tab, real: bool, bf16: bool, rows: bool):
    """(yr, yi) of one lanemat (x @ T, T = table) or rowmat (V @ x on each
    64-row group, V = table^T) on float32 planes viewed as (-1, 128) /
    (-1, 64, 128).  At bf16 as the JAX kernel's MXU dots: the activations
    rounded to bf16, each product the sum of two float32-accumulated
    products against the table's bf16 hi and lo parts."""
    t = torch.tensor(np.asarray(tab), device=xr.device)
    if bf16:
        hi = t.to(torch.bfloat16)
        parts = (hi.float(), (t - hi.float()).to(torch.bfloat16).float())
        xr, xi = xr.to(torch.bfloat16).float(), xi.to(torch.bfloat16).float()
    else:
        parts = (t,)

    def dot(x, reim: int):
        if rows:
            return sum(torch.matmul(p[reim].T, x) for p in parts)
        return sum(x @ p[reim] for p in parts)

    if real:
        return dot(xr, 0), dot(xi, 0)
    return dot(xr, 0) - dot(xi, 1), dot(xr, 1) + dot(xi, 0)


def _apply_matrix_op(z: torch.Tensor, op: tuple, tab, bf16: bool) -> torch.Tensor:
    """A lanemat, rowmat or xtable op on a flat complex64 state (at least
    2^13 amplitudes), from its float32 table."""
    if op[0] == "xtable":
        x = z.view(-1, 64, LANE)
        t = torch.tensor(np.asarray(tab), device=z.device)
        return (x * torch.complex(t[0], t[1])).reshape(-1)
    shape = (-1, 64, LANE) if op[0] == "rowmat" else (-1, LANE)
    yr, yi = _matrix_planes(z.real.reshape(shape), z.imag.reshape(shape), tab, op[2], bf16, op[0] == "rowmat")
    return torch.complex(yr, yi).reshape(-1)


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
    if kind == "camodc":
        return apply_camodc_benes(z, op[1], op[2], op[3], M)
    raise ValueError(f"unknown fused op {op}")


@lru_cache(maxsize=64)
def camodc_route(C: int, A: int, M: int) -> tuple:
    """The Benes stages (bit, bool mask over the 2^M work values) of the
    scatter permutation f -> A*f mod C for f < C, f otherwise, cached per
    (C, A, M) as in the JAX package (the route costs about 0.2 s at M = 13)."""
    return tuple((b, mask.astype(bool)) for b, mask in benes_route(tops.modmul_permutation(C, A, M)))


def apply_camodc_benes(z: torch.Tensor, c: int, C: int, A: int, M: int) -> torch.Tensor:
    """The camodc op on a flat complex state as the JAX kernel computes it:
    where control bit c is 1, stage by stage, work value p takes the value
    at p ^ 2^b where the stage's mask[p] is set."""
    x = tops._camodc_view(z, c, M)
    x1 = x[:, 1]
    p = torch.arange(1 << M, device=z.device)
    for b, mask in camodc_route(C, A % C, M):
        x1 = torch.where(torch.from_numpy(mask).to(z.device), x1[..., p ^ (1 << b)], x1)
    return torch.stack([x[:, 0], x1], dim=1).reshape(-1)


def plain_ops(planar: torch.Tensor, ops: tuple, M: int, tables=()) -> torch.Tensor:
    """An explicit op list, grouped (matrix ops index `tables`) or not,
    applied op by op with plain torch ops; returns a new planar tensor of
    the state's dtype (the kernel's spec).  bf16 planes compute in complex64
    and round to bf16 once, at the end; their lanemat and rowmat products
    follow the JAX kernel's bf16 numerics (_matrix_planes)."""
    z = sv.to_complex(planar)
    bf16 = planar.dtype == torch.bfloat16
    for op in ops:
        z = _apply_matrix_op(z, op, tables[op[1]], bf16) if op[0] in MATRIX_KINDS else _apply_op(z, op, M)
    return torch.stack([z.real, z.imag]).to(planar.dtype)


def segment_ops(ops: tuple, M: int, dtype: torch.dtype, n: int) -> Tuple[tuple, tuple]:
    """(ops, tables) as apply_fused applies a segment: group_ops when the
    plane dtype and size group (``groups``), else the ops as they are."""
    return group_ops(tuple(ops), M) if groups(dtype, n) else (tuple(ops), ())


def plain_segment(planar: torch.Tensor, ops: tuple, M: int) -> torch.Tensor:
    """The plain version of apply_fused: the segment grouped as apply_fused
    groups it (segment_ops), through plain_ops."""
    gops, tables = segment_ops(ops, M, planar.dtype, sv.num_qubits(planar))
    return plain_ops(planar, gops, M, tables)


def plain_permute(planar: torch.Tensor, ops: tuple, M: int) -> torch.Tensor:
    """The plain version of the camodc permutation kernel: _gather_cases
    through the segment's case tables as permute_descriptor builds them on
    the host; a new planar tensor of the state's dtype.  Equal to
    plain_segment on the same segment."""
    positions, _, _, tables = permute_descriptor(tuple(ops), sv.num_qubits(planar), M)
    return _gather_cases(planar, positions, torch.from_numpy(tables.astype(np.int64)).to(planar.device), M)


def _gather_cases(planar: torch.Tensor, positions: tuple, tables: torch.Tensor, M: int) -> torch.Tensor:
    """Each plane's 2^M-element work blocks gathered through the case
    tables (rows of at least 2^M indices on the state's device), a block's
    case from its control bits at `positions` (blocks whose controls are
    all 0 are copied as they are); a new planar tensor."""
    blocks = planar.reshape(2, -1, 1 << M)
    b = torch.arange(blocks.shape[1], device=planar.device)
    case = sum(((b >> p) & 1) << j for j, p in enumerate(positions))
    out = blocks.clone()
    for m in range(1, len(tables) + 1):
        sel = torch.nonzero(case == m).squeeze(1)
        out[:, sel] = torch.index_select(torch.index_select(blocks, 1, sel), 2, tables[m - 1, : 1 << M].long())
    return out.view_as(planar)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper.


def iqft_phases(values, l: int, M: int) -> np.ndarray:
    """exp(i*pi*(v & mask) / 2^l), mask = 2^l - 2^M, for integer values v,
    in complex128: the angle is formed from the exact integer (v & mask)."""
    mask = (1 << l) - (1 << M) if l > M else 0
    frac = (np.asarray(values, np.int64) & mask).astype(np.float64) / float(1 << l)  # exact, in [0, 1)
    # Reduce to an angle of at most pi/4 (exact steps for these dyadic
    # fractions), so that rounding pi * x costs no more than an ulp.
    flip = frac > 0.5
    x = np.where(flip, 1.0 - frac, frac)  # cos(pi x) changes sign, sin does not
    swap = x > 0.25
    y = np.pi * np.where(swap, 0.5 - x, x)
    c, s = np.where(swap, np.sin(y), np.cos(y)), np.where(swap, np.cos(y), np.sin(y))
    return np.where(flip, -c, c) + 1j * s


def iqft_axis_phases(l: int, M: int, high) -> np.ndarray:
    """F_axes: the iQFT op's phase factor of each exposed-axis combination c
    (bit a of c = axis high[a]), 2^len(high) values."""
    c = np.arange(1 << len(high))
    bits = np.zeros_like(c)
    for a, q in enumerate(high):
        bits |= ((c >> a) & 1) << q
    return iqft_phases(bits, l, M)


def iqft_low_phases(l: int, M: int, t: int) -> np.ndarray:
    """F_low: the iQFT op's phase factor of the low t bits of an index.
    Only bits below l count, so 2^min(l, t) values; all ones when M >= t."""
    return iqft_phases(np.arange(1 << min(l, t)), l, M)


def _group_ops(ops, local, t: int, tb: int, vb: int, ne: int) -> list:
    """Cut a segment's ops into register groups, in order: every target of a
    group lies in its 2^ne-amplitude slots, the low vb bits plus at most
    ne - vb more tile bits.  Returns (op_begin, op_end, extra positions
    ascending, padded with the highest unused tile bits to ne - vb, so
    that the threads of a warp take the low tile bits, where the tile is
    contiguous).  A camodc op, which permutes whole work blocks, and a
    matrix op, which reads the whole tile, are groups of their own."""
    groups, cur, begin = [], set(), 0
    for i, op in enumerate(ops):
        if op[0] == "camodc" or op[0] in MATRIX_KINDS:
            if i > begin:
                groups.append((begin, i, cur))
            groups.append((i, i + 1, set()))
            begin, cur = i + 1, set()
            continue
        need = {local(q) for q in _op_targets(op)} - set(range(vb))
        if len(cur | need) > ne - vb:
            groups.append((begin, i, cur))
            begin, cur = i, set()
        cur |= need
    if begin < len(ops) or not groups:
        groups.append((begin, len(ops), cur))
    out = []
    for b, e, extra in groups:
        pad = (p for p in range(tb - 1, vb - 1, -1) if p not in extra)
        while len(extra) < ne - vb:
            extra = extra | {next(pad)}
        out.append((b, e, tuple(sorted(extra))))
    return out


def host_descriptor(ops: tuple, axes: tuple, n: int, M: int, dtype: torch.dtype, tables=()):
    """The kernel's view of one segment, as numpy arrays: (t, high, vb, ne,
    ops_i, ops_f, groups, ftab).  A grouped segment's matrix ops index
    `tables` (group_ops); their records hold each table's chunks and
    their byte offset in matrix_tables' buffer, and mark a rowmat and the
    xtable right after it, which the kernel applies in the rowmat's store.

    A tile holds the low t index bits plus the exposed axes `high`; a thread
    holds 2^ne of its amplitudes (the low vb bits plus ne - vb group bits).
    States too small for that (t < vb or fewer than ne tile bits) take the
    edge form vb = 0, ne = all tile bits: one thread holds the whole tile.
    An iQFT op's phase exp(i*pi*(idx & mask)/2^l) splits over disjoint bit
    fields of idx: F_base (the tile base, formed in the kernel once per
    tile), F_axes (the axis bits) and F_low (the low bits, slot bits zero),
    both in ftab, and one factor w_s per slot bit s, in the op's ops_f
    record; all in the compute dtype (float32 for bf16 planes), re/im
    interleaved, so no amplitude needs a transcendental.  A camodc op's record holds its control's
    tile-local position (-1 when the control is a tile-base bit) and the
    offset of its inverse permutation in camodc_tables; the tile holds at
    least the low M bits.  A segment with a matrix group has a tile of
    ROW_TILE_BITS bits with the lane bits 0-6 in it, and all of bits 0-12
    when it holds a rowmat or xtable; one with a matrix group and a camodc op
    has no kernel instance."""
    t, high = tile_geometry(n, axes, segment_tile_bits(ops, M, TILE_BITS[dtype], axes))
    tb = t + len(high)
    if any(op[0] == "camodc" for op in ops) and t < M:
        raise ValueError(f"a camodc segment needs the low M={M} bits in its tile, got t={t}")
    vb, ne = VEC_BITS[dtype], group_bits(dtype, ops)
    if t < vb or tb < ne:
        vb, ne = 0, tb
    if ne < 1:
        raise ValueError(f"a {n}-qubit state has no tile bits")
    matrix = [op for op in ops if op[0] in MATRIX_KINDS]
    if matrix:
        if dtype == torch.float64 or any(op[0] == "camodc" for op in ops):
            raise ValueError(f"no kernel instance applies matrix groups to {dtype} planes beside camodc ops")
        if tb != ROW_TILE_BITS or t < (ROW_TILE_BITS if _has_rows(ops) else LOW_BITS):
            raise ValueError(f"the matrix groups of a segment need bits 0-12 (rowmat, xtable) or 0-6 (lanemat) "
                             f"in a {ROW_TILE_BITS}-bit tile, got t={t}, axes {high}")
    chunks = [table_chunks(op, dtype) if op[0] in MATRIX_KINDS else 0 for op in ops]
    offsets = MAT_CHUNK * np.concatenate([[0], np.cumsum(chunks)]).astype(np.int64)

    def local(q: int) -> int:
        if q < t:
            return q
        if q not in high:
            raise ValueError(f"target qubit {q} is neither below t={t} nor an exposed axis {high}")
        return t + high.index(q)

    def glob(p: int) -> int:  # global bit of tile-local position p
        return p if p < t else high[p - t]

    groups = _group_ops(ops, local, t, tb, vb, ne)
    ops_i = np.full((len(ops), _OPI_STRIDE), -1, np.int32)
    ops_f = np.zeros((len(ops), OPF_STRIDE), np.float64)
    grp = np.zeros((len(groups), _GRP_STRIDE), np.int32)
    ftabs: list = []
    size = 0

    def table(values) -> int:
        nonlocal size
        ftabs.append(values)
        size += len(values)
        return size - len(values)

    n_perm = 0
    for gi, (b, e, extra) in enumerate(groups):
        grp[gi, :2] = b, e
        grp[gi, 2 : 2 + len(extra)] = extra
        slots = list(range(vb)) + list(extra)  # slot s holds tile-local position slots[s]
        for k in range(b, e):
            op = ops[k]
            if op[0] == "camodc":
                c = op[1]
                if not M <= c < n:
                    raise ValueError(f"camodc control {c} must be a bit of the L register [{M}, {n})")
                ops_i[k, :6] = _KIND["camodc"], c, M, local(c) if (c < t or c in high) else -1, -1, n_perm << M
                n_perm += 1
                continue
            if op[0] in MATRIX_KINDS:
                ops_i[k, 0], ops_i[k, 4], ops_i[k, 5] = _KIND[op[0]], chunks[k], offsets[k]
                ops_i[k, 6] = int(op[0] != "xtable" and op[2])
                fused_x = op[0] == "rowmat" and k + 1 < len(ops) and ops[k + 1][0] == "xtable"
                fused_x = fused_x or (op[0] == "xtable" and k > 0 and ops[k - 1][0] == "rowmat")
                ops_i[k, 7] = int(fused_x)
                continue
            qs = (op[1], op[2]) if op[0] in ("diag2", "u2q") else (op[1],)
            ops_i[k, 0] = _KIND[op[0]]
            for j, q in enumerate(qs):
                ops_i[k, 1 + j] = q
                p = local(q) if (q < t or q in high) else -1
                ops_i[k, 3 + j] = slots.index(p) if p in slots else -1
            if op[0] == "iqft":
                l = op[1]
                if l > M:
                    mask = (1 << l) - (1 << M)
                    if any(mask >> q & 1 for q in high):
                        ops_i[k, 5] = table(iqft_axis_phases(l, M, high))
                    if mask & ((1 << t) - 1):
                        ops_i[k, 6] = table(iqft_low_phases(l, M, t))
                    ops_i[k, 7] = 1
                    w = iqft_phases([1 << glob(p) for p in slots], l, M)
                    ops_f[k, : 2 * ne] = np.stack([w.real, w.imag], axis=1).reshape(-1)
            else:
                vals = op[-1]
                ops_f[k, : len(vals)] = vals
    ftab = np.concatenate(ftabs) if ftabs else np.ones(1, np.complex128)
    ftab = np.stack([ftab.real, ftab.imag], axis=1).reshape(-1)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return t, high, vb, ne, ops_i, ops_f.astype(np_dtype), grp, ftab.astype(np_dtype)


def camodc_tables(ops: tuple, M: int) -> np.ndarray:
    """ptab: the inverse permutation f -> A^-1 * f mod C (f < C) of each
    camodc op of a segment, in op order, 2^M int16 values each (one zero
    when the segment has none)."""
    tabs = [tops.modmul_inverse_permutation(op[2], op[3], M) for op in ops if op[0] == "camodc"]
    return np.concatenate(tabs).astype(np.int16) if tabs else np.zeros(1, np.int16)


def permute_descriptor(ops: tuple, n: int, M: int) -> Tuple[tuple, int, int, np.ndarray]:
    """The camodc permutation kernel's view of a segment whose every op is a
    camodc op: (positions, log_q, items, tables).

    positions: the k distinct controls' bits in the work-block index
    (control - M), ascending.  The d-th changed work block (one whose
    controls are not all 0) has case m = (d >> log_q) + 1, log_q =
    n - M - k, and its index is d's low log_q bits with bit j of m inserted
    at positions[j], in ascending order; items = 2 (2^k - 1) 2^log_q, one a
    plane of each changed block.  tables: (2^k - 1, 2^M rounded up to 8)
    uint16, row m - 1 the composition, in op order, of the inverse tables
    (gates.modmul_inverse_permutation) of the ops whose control is bit j of
    m set: out[f] = in[g1[g2[f]]] for ops 1 then 2; the padding is 0."""
    controls = _permute_controls(ops, n, M)
    k = len(controls)
    inverse = [tops.modmul_inverse_permutation(op[2], op[3], M) for op in ops]
    tables = np.zeros(((1 << k) - 1, -(-(1 << M) // 8) * 8), np.uint16)
    for m in range(1, 1 << k):
        h = np.arange(1 << M)
        for op, g in zip(ops, inverse):
            if (m >> controls.index(op[1])) & 1:
                h = h[g]
        tables[m - 1, : 1 << M] = h
    log_q = n - M - k
    return tuple(c - M for c in controls), log_q, 2 * (((1 << k) - 1) << log_q), tables


def _permute_controls(ops: tuple, n: int, M: int) -> list:
    """The distinct controls of a segment of camodc ops alone, ascending;
    raises for any other segment or a control outside [M, n)."""
    controls = sorted({op[1] for op in ops})
    if {op[0] for op in ops} != {"camodc"}:
        raise ValueError(f"the camodc permutation takes camodc ops only, got {ops}")
    if not M <= controls[0] <= controls[-1] < n:
        raise ValueError(f"camodc controls {controls} must be bits of the L register [{M}, {n})")
    return controls


# The matrix groups' tables as the kernel consumes them (csrc/fused_matmul.cu,
# fused_segment.cuh "Matrix groups"): each lanemat / rowmat table is the
# product's shared-memory operand B[k][n] = tab[re/im][k][n] (lanemat:
# K = N = 128 lanes; rowmat, computed transposed: K = N = 64 rows), its
# parts re hi, re lo (then im hi, im lo for a complex table), for each
# k-step of 32 bytes of K (8 TF32 or 16 bf16 values) in the wgmma
# descriptor's no-swizzle K-major layout: core matrices of 8 columns of N x
# 16 bytes of K, the two K halves 128 bytes apart, groups of 8 columns 256
# bytes apart.  The k-steps run over K in the order of ``mat_k_order``, and
# a rowmat's N (its output rows) in ``rowmat_order``.
# Everything is cut into MAT_CHUNK-byte chunks in op order, one stage of the
# kernel's table ring each.

#: Bytes of a table chunk (one stage of the kernel's ring).
MAT_CHUNK = 16 << 10


def tf32_round(x) -> np.ndarray:
    """float32 values rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as the card's cvt.rna.tf32.f32 rounds; float32 result."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_split(x) -> Tuple[np.ndarray, np.ndarray]:
    """(hi, lo): hi = x rounded to TF32, lo = x - hi (exact in float32)
    rounded to TF32: the kernel's 3xTF32 operands."""
    x = np.asarray(x, np.float32)
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def rowmat_order(n: int = 64) -> np.ndarray:
    """The rows of a rowmat's outputs (its N index n is row n ^ ((n >> 1) &
    1)): the four threads of a quad then store rows of both parities, which
    the tile's swizzle spreads over the banks."""
    k = np.arange(n)
    return k ^ ((k >> 1) & 1)


def mat_k_order(kind: str, dtype: torch.dtype) -> np.ndarray:
    """order[k]: the activation index (lane of a lanemat, row of a rowmat)
    of the products' k-th K index.  A rowmat takes its rows in rowmat order
    at bf16 (rowmat_order) and in order at TF32.  A lanemat's
    16-lane group p is one bf16 k-step or two TF32 k-steps, read as one
    16-byte load of 4 lanes a thread (c = 0..3): at bf16 K 2c, 2c + 1,
    2c + 8, 2c + 9 of step p are lanes 16p + 4c + 0..3; at TF32 K c and
    c + 4 of step 2p + h are lanes 16p + 4c + 2h and 16p + 4c + 2h + 1."""
    if kind == "rowmat":
        return rowmat_order() if dtype == torch.bfloat16 else np.arange(64)
    k = np.arange(LANE)
    if dtype == torch.bfloat16:
        kk = k % 16
        return 16 * (k // 16) + 4 * ((kk % 8) // 2) + 2 * (kk // 8) + kk % 2
    step, kk = k // 8, k % 8
    return 16 * (step // 2) + 4 * (kk % 4) + 2 * (step % 2) + kk // 4


def table_chunks(op: tuple, dtype: torch.dtype) -> int:
    """The MAT_CHUNK-byte chunks of a matrix op's packed table: its parts
    (2 real, 4 complex) of an (n, n) table at 4 bytes (TF32 hi / lo) or 2
    (bf16 hi / lo) an entry; an xtable's (2, 64, 128) float32."""
    if op[0] == "xtable":
        return 2 * 64 * LANE * 4 // MAT_CHUNK
    size = LANE if op[0] == "lanemat" else 64
    return (2 if op[2] else 4) * size * size * (2 if dtype == torch.bfloat16 else 4) // MAT_CHUNK


def _pack_product(tab, kind: str, real: bool, dtype: torch.dtype) -> np.ndarray:
    """A lanemat or rowmat table (2 re/im, K, K) float32 packed for the
    kernel (see above): hi / lo parts, K in mat_k_order, the core-matrix
    layout; bytes."""
    t = torch.tensor(np.array(tab, np.float32)[:1 if real else 2])
    if dtype == torch.bfloat16:
        hi = t.to(torch.bfloat16)
        lo = (t - hi.float()).to(torch.bfloat16)
        parts = [x.view(torch.int16).numpy() for x in (hi, lo)]
    else:
        parts = list(tf32_split(t.numpy()))
    per16 = 16 // parts[0].itemsize  # K values in 16 bytes
    b = np.stack(parts, axis=1).reshape(-1, *t.shape[1:])  # (re hi, re lo, im hi, im lo)
    b = b[:, mat_k_order(kind, dtype), :]
    if kind == "rowmat":
        b = b[:, :, rowmat_order()]
    P, K, N = b.shape
    b = b.reshape(P, K // (2 * per16), 2, per16, N // 8, 8)  # (part, step, half, e, group, col)
    return np.ascontiguousarray(b.transpose(1, 0, 4, 2, 5, 3)).reshape(-1).view(np.uint8)


def _pack_xtable(tab) -> np.ndarray:
    """An xtable (2 cos/sin, 64, 128) float32 as four chunks, in the order
    each thread applies it: chunk q, warpgroup wg, float4 v, thread t (warp
    w, lane 4 g + c) holds (cos, sin) of its elements 2v and 2v + 1, element
    i = 4 jj + e at row 16 q + 8 jj + 2 c + ((e ^ c) & 1) (rowmat order) and
    lane 64 wg + 16 w + 2 g + (e >> 1); bytes."""
    q, wg, v, t, f = np.indices((4, 2, 4, 128, 4))
    i = 2 * v + (f >> 1)
    row = 16 * q + 8 * (i >> 2) + 2 * (t & 3) + ((i ^ t) & 1)
    lane = 64 * wg + 16 * (t >> 5) + 2 * ((t & 31) >> 2) + ((i >> 1) & 1)
    return np.asarray(tab, np.float32)[f & 1, row, lane].reshape(-1).view(np.uint8)


def matrix_tables(ops: tuple, tables, dtype: torch.dtype) -> np.ndarray:
    """mtab: the tables of a grouped segment's matrix ops packed as the
    kernel consumes them, one byte buffer of MAT_CHUNK-byte chunks in op
    order (host_descriptor's offsets; one zero byte when there are none).
    float32: each lanemat / rowmat table's TF32 hi / lo split (tf32_split);
    bf16: hi the table rounded to nearest and lo its remainder rounded, as
    the JAX package stages them (pallas_fused.py:1114-1119): the same
    values in another order.  An xtable's float32 cos / sin either way."""
    out = [
        _pack_xtable(tables[op[1]]) if op[0] == "xtable" else _pack_product(tables[op[1]], op[0], op[2], dtype)
        for op in ops
        if op[0] in MATRIX_KINDS
    ]
    return np.concatenate(out) if out else np.zeros(1, np.uint8)


def _device_descriptor(ops: tuple, axes: tuple, n: int, M: int, dtype: torch.dtype, device, tables=()):
    """host_descriptor, camodc_tables and matrix_tables with their arrays on
    the device."""
    t, high, vb, ne, *arrays = host_descriptor(ops, axes, n, M, dtype, tables)
    arrays += [camodc_tables(ops, M), matrix_tables(ops, tables, dtype)]
    return (t, high, vb, ne, *(torch.from_numpy(a).to(device) for a in arrays))


@lru_cache(maxsize=256)
def _descriptor(ops: tuple, axes: tuple, n: int, M: int, dtype: torch.dtype, device: torch.device, group: bool):
    """(ops as applied, _device_descriptor) of a segment, grouped when
    `group`, cached per segment."""
    gops, tables = group_ops(ops, M) if group else (ops, ())
    return gops, _device_descriptor(gops, axes, n, M, dtype, device, tables)


def _permute_tables(ops: tuple, n: int, M: int, device: torch.device):
    """permute_descriptor's positions and tables of a segment of camodc ops
    alone, the tables int16 on `device` and cached by what they depend on:
    each op's control rank, C and A (_case_tables)."""
    controls = _permute_controls(ops, n, M)
    key = tuple((controls.index(op[1]), op[2], op[3] % op[2]) for op in ops)
    return tuple(c - M for c in controls), _case_tables(key, M, device)


@lru_cache(maxsize=256)  # 16 KB a table row at M = 13
def _case_tables(key: tuple, M: int, device: torch.device) -> torch.Tensor:
    """The case tables of the segment `key` ((control rank, C, A) an op),
    built on `device` with torch ops: row m - 1 composes, in op order, the
    inverse maps modmul_permute_onchip(A^-1, f, C) of the ops whose control
    rank is a bit of m, zero-padded; only the int16 result stays.  A miss
    records an oracle.table span of its bytes.  Raises as
    gates.modmul_inverse does."""
    a_inv = [tops.modmul_inverse(C, A, M) for _, C, A in key]
    k = 1 + max(j for j, _, _ in key)
    stride = -(-(1 << M) // 8) * 8
    with profiling.span("oracle.table", device, bytes=2 * ((1 << k) - 1) * stride):
        f = torch.arange(1 << M, device=device)
        maps = [tops.modmul_permute_onchip(a, f, C) for a, (_, C, _) in zip(a_inv, key)]
        tables = torch.zeros(((1 << k) - 1, stride), dtype=torch.int16, device=device)
        for m in range(1, 1 << k):
            h = None
            for (j, _, _), g in zip(key, maps):
                if (m >> j) & 1:
                    h = g if h is None else h[g]
            tables[m - 1, : 1 << M] = h
        return tables


def kernel_body(ops, M: int, dtype: torch.dtype, aligned: bool) -> str:
    """The router: the kernel a segment (ops as applied) launches, by its
    shape.  "matmul" when it holds a matrix group (csrc/fused_matmul.cu);
    "permute" when every op is a camodc op on at most
    MAX_CAMODC_PER_SEGMENT distinct controls, both planes are 16-byte
    aligned (`aligned`) and a work block holds at least 16 bytes of a plane
    (csrc/camodc_permute.cu); else "segment" (csrc/fused_segment.cu)."""
    if any(op[0] in MATRIX_KINDS for op in ops):
        return "matmul"
    itemsize = dtype.itemsize
    if (ops and all(op[0] == "camodc" for op in ops) and len({op[1] for op in ops}) <= MAX_CAMODC_PER_SEGMENT
            and aligned and (itemsize << M) >= 16):
        return "permute"
    return "segment"


def _aligned(planar: torch.Tensor) -> bool:
    return planar[0].data_ptr() % 16 == 0 and planar[1].data_ptr() % 16 == 0


def _permute(planar: torch.Tensor, ops: tuple, n: int, M: int) -> torch.Tensor:
    """A segment that kernel_body sends to "permute", in place, through its
    case tables (_permute_tables): one launch of qc_camodc_permute for a
    CUDA tensor (the k controls' bits above M packed a byte each), the same
    gather by _gather_cases for a CPU one."""
    global LAUNCHES, CAMODC_LAUNCHES, PERMUTE_LAUNCHES
    positions, cases = _permute_tables(ops, n, M, planar.device)
    if planar.device.type == "cpu":
        return planar.copy_(_gather_cases(planar, positions, cases, M))
    fn = _build.entry("qc_camodc_permute", planar.dtype)
    packed = sum(p << (8 * j) for j, p in enumerate(positions))
    with torch.cuda.device(planar.device):
        err = fn(planar[0].data_ptr(), planar[1].data_ptr(), cases.data_ptr(), cases.shape[0], n, M, len(positions),
                 packed, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "camodc_permute")
    LAUNCHES += 1
    CAMODC_LAUNCHES += 1
    PERMUTE_LAUNCHES += 1
    return planar


def _check_planar(planar: torch.Tensor) -> int:
    n = sv.num_qubits(planar)
    if planar.dtype not in TILE_BITS:
        raise TypeError(f"planar state must be float32, float64 or bfloat16, got {planar.dtype}")
    if not planar.is_contiguous():
        raise ValueError("planar state must be contiguous")
    return n


def _launch(planar: torch.Tensor, ops: tuple, n: int, M: int, desc) -> torch.Tensor:
    """One kernel launch of a segment (ops as applied) on a CUDA planar
    state, in place: the matrix instance (qc_fused_matmul) when kernel_body
    says "matmul", else qc_fused_segment."""
    global LAUNCHES, CAMODC_LAUNCHES, MATMUL_LAUNCHES
    t, high, vb, ne, ops_i, ops_f, grp, ftab, ptab, mtab = desc
    matrix = kernel_body(ops, M, planar.dtype, _aligned(planar)) == "matmul"
    fn = _build.entry("qc_fused_matmul" if matrix else "qc_fused_segment", planar.dtype)
    packed = sum(a << (8 * i) for i, a in enumerate(high))
    n_perm = sum(op[0] == "camodc" for op in ops)
    args = [
        planar[0].data_ptr(), planar[1].data_ptr(), ops_i.data_ptr(), ops_f.data_ptr(),
        grp.data_ptr(), grp.shape[0], ftab.data_ptr(), ptab.data_ptr(), n_perm, len(ops), n, t,
        len(high), packed, M, vb, ne,
    ]
    if matrix:
        args.append(mtab.data_ptr())
    with torch.cuda.device(planar.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_matmul" if matrix else "fused_segment")
    LAUNCHES += 1
    CAMODC_LAUNCHES += bool(n_perm)
    MATMUL_LAUNCHES += matrix
    return planar


def _device_kind(planar: torch.Tensor) -> str:
    if planar.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused-segment path for device {planar.device}")
    return planar.device.type


def apply_segment(planar: torch.Tensor, ops: tuple, axes: tuple, M: int, tables=()) -> torch.Tensor:
    """An explicit op list, grouped (its matrix ops index `tables`) or not,
    as one fused pass IN PLACE: the kernel that kernel_body picks for a
    CUDA tensor, its plain version (the "permute" segment's case-table
    gather, else plain_ops) for a CPU tensor.  A segment passed here
    ungrouped runs in its butterfly form (no matrix group)."""
    n = _check_planar(planar)
    ops, axes = tuple(ops), tuple(axes)
    if _device_kind(planar) == "cuda" and not ops:
        return planar
    if kernel_body(ops, M, planar.dtype, _aligned(planar)) == "permute":
        return _permute(planar, ops, n, M)
    if planar.device.type == "cpu":
        return planar.copy_(plain_ops(planar, ops, M, tables))
    if tables:
        desc = _device_descriptor(ops, axes, n, M, planar.dtype, planar.device, tables)
    else:
        desc = _descriptor(ops, axes, n, M, planar.dtype, planar.device, False)[1]
    return _launch(planar, ops, n, M, desc)


def apply_segment_values(planar: torch.Tensor, ops: tuple, axes: tuple, M: int, values: torch.Tensor) -> torch.Tensor:
    """apply_segment of an ungrouped segment of VALUED_KINDS ops whose values
    come from `values` at launch, IN PLACE: row k of the (len(ops),
    OPF_STRIDE) tensor `values` (the compute dtype, on the state's device)
    replaces op k's own values in its descriptor record, laid out as
    gate_to_op gives them.  So a segment planned once for its structure
    runs with new angles, with no new plan or descriptor (a variational
    loop's layers).  The plain version rebuilds the ops with those values."""
    n = _check_planar(planar)
    ops, axes = tuple(ops), tuple(axes)
    if not all(op[0] in VALUED_KINDS for op in ops):
        raise ValueError(f"values at launch take {VALUED_KINDS} ops, got {sorted({op[0] for op in ops})}")
    want = (len(ops), OPF_STRIDE)
    if tuple(values.shape) != want or values.dtype != sv.compute_dtype(planar.dtype) or values.device != planar.device:
        raise ValueError(f"values must be a {want} {sv.compute_dtype(planar.dtype)} tensor on {planar.device}")
    if _device_kind(planar) == "cpu":
        rows = values.double().numpy()
        ops = tuple(op[:-1] + (tuple(float(v) for v in rows[k, : len(op[-1])]),) for k, op in enumerate(ops))
        return planar.copy_(plain_ops(planar, ops, M))
    if not ops:
        return planar
    t, high, vb, ne, ops_i, _, *rest = _descriptor(ops, axes, n, M, planar.dtype, planar.device, False)[1]
    return _launch(planar, ops, n, M, (t, high, vb, ne, ops_i, values.contiguous(), *rest))


def apply_fused(planar: torch.Tensor, ops: tuple, axes: tuple, M: int) -> torch.Tensor:
    """Apply one fused segment to a (2, 2^n) planar state IN PLACE (the
    counterpart of the JAX kernel's input/output aliasing) and return it,
    grouped into matrix products where the plane dtype and size group
    (``groups``), as the JAX apply_fused groups (pallas_fused.py:1103).

    A CUDA tensor goes through the kernel that kernel_body picks; a CPU
    tensor through that kernel's plain version (the "permute" segment's
    case-table gather, else plain_segment).  Any other device raises."""
    n = _check_planar(planar)
    ops = tuple(ops)
    if _device_kind(planar) == "cuda" and not ops:
        return planar
    if kernel_body(ops, M, planar.dtype, _aligned(planar)) == "permute":
        return _permute(planar, ops, n, M)
    if planar.device.type == "cpu":
        return planar.copy_(plain_segment(planar, ops, M))
    gops, desc = _descriptor(ops, tuple(axes), n, M, planar.dtype, planar.device, groups(planar.dtype, n))
    return _launch(planar, gops, n, M, desc)
