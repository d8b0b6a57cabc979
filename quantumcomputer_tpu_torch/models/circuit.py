"""Circuit IR: a hashable, static description of a gate sequence.

The reference has exactly one hard-coded circuit (quantum_computation,
qc_shor.c:712-737).  Here circuits are first-class values: a ``Circuit`` is
an immutable tuple of ``Gate`` descriptors, hashable so the engine can
cache one fused-segment plan per circuit.  A copy of the JAX package's
``models/circuit.py`` (pure numpy), so the port never imports jax.

Gate vocabulary covers the reference set (H, controlled-phase, controlled
a^x mod C, inverse QFT) plus the standard dense set for generic use
(X/Y/Z/S/T/phase/rotations/CNOT/CZ/SWAP/arbitrary 1q & 2q unitaries),
per the generic-gate-set capability target.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Gate descriptor


@dataclass(frozen=True)
class Gate:
    """One gate application.  ``params`` are floats; ``meta`` holds static
    ints (e.g. modulus C); ``matrix`` holds an optional explicit unitary as a
    nested tuple (hashable)."""

    name: str
    qubits: Tuple[int, ...]
    params: Tuple[float, ...] = ()
    meta: Tuple[int, ...] = ()
    matrix: Tuple[Tuple[complex, ...], ...] | None = None

    def __repr__(self) -> str:  # compact, for logs
        ps = f", params={self.params}" if self.params else ""
        ms = f", meta={self.meta}" if self.meta else ""
        return f"{self.name}{list(self.qubits)}{ps}{ms}"


Circuit = Tuple[Gate, ...]


def _tup(m: np.ndarray) -> Tuple[Tuple[complex, ...], ...]:
    return tuple(tuple(complex(v) for v in row) for row in m)


# ---------------------------------------------------------------------------
# Standard gate constructors

_SQRT1_2 = 1.0 / math.sqrt(2.0)


def H(q: int) -> Gate:
    return Gate("h", (q,))


def X(q: int) -> Gate:
    return Gate("x", (q,))


def Y(q: int) -> Gate:
    return Gate("y", (q,))


def Z(q: int) -> Gate:
    return Gate("z", (q,))


def S(q: int) -> Gate:
    return Gate("phase", (q,), (math.pi / 2,))


def T(q: int) -> Gate:
    return Gate("phase", (q,), (math.pi / 4,))


def PHASE(q: int, theta: float) -> Gate:
    return Gate("phase", (q,), (float(theta),))


def RX(q: int, theta: float) -> Gate:
    return Gate("rx", (q,), (float(theta),))


def RY(q: int, theta: float) -> Gate:
    return Gate("ry", (q,), (float(theta),))


def RZ(q: int, theta: float) -> Gate:
    return Gate("rz", (q,), (float(theta),))


def U1Q(q: int, matrix: np.ndarray) -> Gate:
    return Gate("u1q", (q,), matrix=_tup(np.asarray(matrix, dtype=np.complex128)))


def CNOT(control: int, target: int) -> Gate:
    return Gate("cnot", (control, target))


def CZ(control: int, target: int) -> Gate:
    return Gate("cz", (control, target))


def CPHASE(control: int, target: int, theta: float) -> Gate:
    """Controlled phase shift (qc_shor.c:513-565)."""
    return Gate("cphase", (control, target), (float(theta),))


def SWAP(q1: int, q2: int) -> Gate:
    return Gate("swap", (q1, q2))


def U2Q(q_hi: int, q_lo: int, matrix: np.ndarray) -> Gate:
    """Arbitrary 4x4 unitary; basis index 2*bit(q_hi) + bit(q_lo)."""
    return Gate("u2q", (q_hi, q_lo), matrix=_tup(np.asarray(matrix, dtype=np.complex128)))


def MCPHASE(controls, theta: float) -> Gate:
    """Multi-controlled phase: e^{i theta} exactly where EVERY control bit
    is 1.  Diagonal on any number of qubits — one masked elementwise pass,
    never a dense matrix (the reference builds a 2^N x 2^N matrix even for
    its 2-qubit controlled phase, qc_shor.c:513-565).  The primitive that
    makes generic algorithms (Grover oracles/diffusion, multi-controlled
    rotations) expressible in the circuit IR."""
    qs = tuple(sorted(int(q) for q in controls))
    if len(qs) < 1 or len(qs) != len(set(qs)):
        raise ValueError(f"MCPHASE needs >= 1 distinct control qubits, got {controls}")
    return Gate("mcphase", qs, (float(theta),))


def MCZ(*controls: int) -> Gate:
    """Multi-controlled Z: phase-flip the all-ones subspace of `controls`."""
    return MCPHASE(controls, math.pi)


def CAMODC(C: int, atox: int, control: int) -> Gate:
    """Controlled a^x mod C permutation gate (qc_shor.c:595-660)."""
    return Gate("camodc", (control,), meta=(int(C), int(atox)))


def IQFT_STAGE(l: int) -> Gate:
    """Fused inverse-QFT stage on qubit l: H(l) + full phase ladder down to
    the M boundary (the engine supplies M)."""
    return Gate("iqft_stage", (l,))


# ---------------------------------------------------------------------------
# Adjoints.  Circuits are unitary, so the dagger circuit applies the exact
# inverse.


def dagger_gate(g: Gate, M: int = 0) -> Tuple[Gate, ...]:
    """The adjoint of one gate as a (possibly multi-)gate sequence.
    `M` resolves the iQFT stage's ladder boundary (engine-supplied)."""
    name = g.name
    if name in ("h", "x", "y", "z", "cnot", "swap", "cz"):
        return (g,)  # self-adjoint
    if name in ("phase", "rx", "ry", "rz", "mcphase"):
        return (Gate(name, g.qubits, (-g.params[0],)),)
    if name == "cphase":
        return (Gate(name, g.qubits, (-g.params[0],)),)
    if name == "u1q":
        m = np.array(g.matrix, dtype=np.complex128)
        return (U1Q(g.qubits[0], m.conj().T),)
    if name == "u2q":
        m = np.array(g.matrix, dtype=np.complex128)
        return (U2Q(g.qubits[0], g.qubits[1], m.conj().T),)
    if name == "camodc":
        C, atox = g.meta
        return (CAMODC(C, pow(int(atox) % C, -1, C), g.qubits[0]),)
    if name == "camodc_high":
        C, atox, m_reg = g.meta
        return (Gate("camodc_high", g.qubits, meta=(C, pow(int(atox) % C, -1, C), m_reg)),)
    if name in ("camodc_ladder", "camodc_ladder_high"):
        C, m_reg = g.meta[0], g.meta[1]
        inv = tuple(pow(int(A) % C, -1, C) for A in g.meta[2:])
        return (Gate(name, g.qubits, meta=(C, m_reg) + inv),)
    if name == "iqft_stage":
        # stage = H(l) then CP(l, k, pi/2^(l-k)) for k = l-1..M; the dagger
        # reverses with negated angles and the H last.
        l = g.qubits[0]
        ladder = tuple(
            Gate("cphase", (l, k), (-math.pi / (1 << (l - k)),)) for k in range(M, l)
        )
        return ladder + (H(l),)
    raise ValueError(f"no adjoint rule for gate {g}")


def dagger_circuit(circuit: Circuit, M: int = 0) -> Circuit:
    """U^dagger of a whole circuit: reversed gate-wise adjoints."""
    out: list = []
    for g in reversed(circuit):
        out.extend(dagger_gate(g, M))
    return tuple(out)


# ---------------------------------------------------------------------------
# Dense matrices for the standard set (numpy, complex128) — used by both the
# engine dispatch and the CPU oracle in tests.

def gate_matrix_1q(g: Gate) -> np.ndarray:
    n = g.name
    if n == "h":
        return np.array([[_SQRT1_2, _SQRT1_2], [_SQRT1_2, -_SQRT1_2]], dtype=np.complex128)
    if n == "x":
        return np.array([[0, 1], [1, 0]], dtype=np.complex128)
    if n == "y":
        return np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
    if n == "z":
        return np.array([[1, 0], [0, -1]], dtype=np.complex128)
    if n == "phase":
        return np.array([[1, 0], [0, np.exp(1j * g.params[0])]], dtype=np.complex128)
    if n == "rx":
        t = g.params[0] / 2
        return np.array([[np.cos(t), -1j * np.sin(t)], [-1j * np.sin(t), np.cos(t)]], dtype=np.complex128)
    if n == "ry":
        t = g.params[0] / 2
        return np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]], dtype=np.complex128)
    if n == "rz":
        t = g.params[0] / 2
        return np.array([[np.exp(-1j * t), 0], [0, np.exp(1j * t)]], dtype=np.complex128)
    if n == "u1q":
        return np.array(g.matrix, dtype=np.complex128)
    raise ValueError(f"not a 1-qubit dense gate: {g}")


def gate_matrix_2q(g: Gate) -> np.ndarray:
    """4x4 in the 2*bit(qubits[0]) + bit(qubits[1]) basis."""
    n = g.name
    if n == "cnot":
        m = np.eye(4, dtype=np.complex128)
        m[[2, 3]] = m[[3, 2]]
        return m
    if n == "cz":
        m = np.eye(4, dtype=np.complex128)
        m[3, 3] = -1
        return m
    if n == "cphase":
        m = np.eye(4, dtype=np.complex128)
        m[3, 3] = np.exp(1j * g.params[0])
        return m
    if n == "swap":
        m = np.eye(4, dtype=np.complex128)
        m[[1, 2]] = m[[2, 1]]
        return m
    if n == "u2q":
        return np.array(g.matrix, dtype=np.complex128)
    raise ValueError(f"not a 2-qubit dense gate: {g}")


DIAGONAL_2Q = {"cz", "cphase"}
DENSE_1Q = {"h", "x", "y", "rx", "ry", "u1q"}
DIAGONAL_1Q = {"z", "phase", "rz"}
