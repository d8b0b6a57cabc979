"""Quantum Volume: random SU(4) model circuits and heavy-output sampling.

The counterpart of the JAX package's ``algorithms/quantum_volume.py`` (Cross,
Bishop, Smolin, Gambetta, arXiv:1811.12926): a depth-m circuit on m qubits
whose every layer pairs the qubits at random and applies an independent
Haar-random SU(4) to each pair; the heavy-output probability (HOP) of the
sampled bitstrings is held against the 2/3 pass threshold.  The circuits
come from ``np.random.default_rng(seed)`` as in the JAX package, so both
packages build the same ones; the heavy sets come from an independent
complex128 numpy oracle (``ideal_probabilities``, never the engine under
test), and each circuit's shots are one ``engine.sample`` call (one pass
over the state for all of them).  The draws are ``rs``, shape
(num_circuits, shots), or come from ``seed``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from quantumcomputer_tpu_torch.models import circuit as cir
from quantumcomputer_tpu_torch.models.circuit import Circuit


def haar_su4(rng: np.random.Generator) -> np.ndarray:
    """Haar-random SU(4) via QR of a complex Ginibre matrix with the
    R-diagonal phase fix (Mezzadri, arXiv:math-ph/0609050)."""
    z = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    q, r = np.linalg.qr(z)
    d = np.diagonal(r)
    q = q * (d / np.abs(d))
    return q / np.linalg.det(q) ** 0.25


def qv_model_circuit(m: int, rng: np.random.Generator, depth: Optional[int] = None) -> Circuit:
    """One QV model circuit on qubits [0, m): `depth` (default m) layers,
    each a random pairing of the qubits with an independent Haar-random
    SU(4) per pair (odd qubit counts idle one qubit per layer)."""
    if m < 2:
        raise ValueError("quantum volume needs m >= 2 qubits")
    gates: list = []
    for _ in range(m if depth is None else depth):
        perm = rng.permutation(m)
        for i in range(m // 2):
            q_hi, q_lo = sorted((int(perm[2 * i]), int(perm[2 * i + 1])), reverse=True)
            gates.append(cir.U2Q(q_hi, q_lo, haar_su4(rng)))
    return tuple(gates)


def _apply_2q(psi: np.ndarray, u4: np.ndarray, q_hi: int, q_lo: int) -> np.ndarray:
    """A 4x4 unitary on qubits (q_hi, q_lo), q_hi > q_lo, basis index
    2*bit(q_hi) + bit(q_lo), on a flat complex128 state: the JAX package's
    numpy oracle (``sim/reference.apply_2q``), copied."""
    if q_hi <= q_lo:
        raise ValueError("q_hi must be the more significant qubit")
    n_states = psi.shape[0]
    c = 1 << q_lo
    b = 1 << (q_hi - q_lo - 1)
    a = n_states // (4 * b * c)
    x = psi.reshape(a, 2, b, 2, c)
    u = u4.reshape(2, 2, 2, 2)  # (hi', lo', hi, lo)
    return np.einsum("efab,xaybc->xeyfc", u, x).reshape(n_states)


def ideal_probabilities(circ: Circuit, m: int) -> np.ndarray:
    """Exact complex128 output distribution of `circ` from |0...0>, by the
    numpy oracle: the trusted side of the differential."""
    psi = np.zeros(1 << m, dtype=np.complex128)
    psi[0] = 1.0
    for g in circ:
        if g.name != "u2q":
            raise ValueError(f"QV circuits contain only u2q gates, got {g.name}")
        psi = _apply_2q(psi, np.array(g.matrix, dtype=np.complex128), *g.qubits)
    return np.abs(psi) ** 2


def heavy_set(probs: np.ndarray) -> np.ndarray:
    """Boolean mask of the heavy outputs: ideal probability strictly above
    the median ideal probability."""
    return probs > np.median(probs)


@dataclass
class QVResult:
    m: int
    num_circuits: int
    shots: int
    hops: List[float]          # measured heavy-output probability per circuit
    ideal_hops: List[float]    # ideal heavy-output weight per circuit
    mean_hop: float
    lower_2sigma: float        # mean - 2*sqrt(p(1-p)/num_circuits), the paper's bound
    passed: bool               # lower_2sigma > 2/3
    quantum_volume: int        # 2^m if passed else 0

    def to_dict(self) -> dict:
        return {
            "m": self.m, "num_circuits": self.num_circuits, "shots": self.shots,
            "mean_hop": self.mean_hop, "lower_2sigma": self.lower_2sigma,
            "passed": self.passed, "quantum_volume": self.quantum_volume,
        }


def run_quantum_volume(
    m: int,
    engine,
    *,
    num_circuits: int = 20,
    shots: int = 100,
    seed: int = 0,
    rs=None,
) -> QVResult:
    """Run the QV protocol at width m on `engine` and score it: each model
    circuit from zero_state(), `shots` samples with the draws rs[c], the
    heavy set from the complex128 oracle.  Passes when the 2-sigma lower
    bound on the pooled HOP exceeds 2/3; sigma pools over circuits, the
    independent unit, not shots."""
    if rs is None:
        rs = engine.draws((num_circuits, shots), seed)
    if tuple(rs.shape) != (num_circuits, shots):
        raise ValueError(f"rs must have shape ({num_circuits}, {shots}), got {tuple(rs.shape)}")
    rng = np.random.default_rng(seed)
    hops: List[float] = []
    ideal: List[float] = []
    for c in range(num_circuits):
        circ = qv_model_circuit(m, rng)
        probs = ideal_probabilities(circ, m)
        heavy = heavy_set(probs)
        ideal.append(float(probs[heavy].sum()))
        samples = engine.sample(engine.run(circ, engine.zero_state()), rs[c])
        samples = np.array([engine.logical_index(int(s)) for s in samples])
        hops.append(float(np.mean(heavy[samples])))
    mean_hop = float(np.mean(hops))
    sigma = float(np.sqrt(max(mean_hop * (1.0 - mean_hop), 1e-12) / num_circuits))
    lower = mean_hop - 2.0 * sigma
    passed = lower > 2.0 / 3.0
    return QVResult(
        m=m, num_circuits=num_circuits, shots=shots, hops=hops,
        ideal_hops=ideal, mean_hop=mean_hop, lower_2sigma=lower,
        passed=passed, quantum_volume=(1 << m) if passed else 0,
    )
