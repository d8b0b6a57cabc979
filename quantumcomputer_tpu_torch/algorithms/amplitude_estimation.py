"""Quantum amplitude estimation: QPE on the Grover iterate.

The counterpart of the JAX package's ``algorithms/amplitude_estimation.py``,
which holds the algebra: with O the phase flip of the marked set and
D = H^n X^n MCZ X^n H^n (exactly -(2|s><s| - I)), the iterate Q = D O has
eigenphases 1/2 +- theta_a / pi in turns, sin^2(theta_a) = a, so

    theta_hat = pi * |x / 2^t - 1/2|,   a_hat = sin^2(theta_hat)

(Brassard-Hoyer-Mosca-Tapp 2000).  A controlled iterate needs the control
only on its MCZs (c-(V A V^dag) = V (c-A) V^dag), so it stays H / X layers
and MCPHASE diagonals, the latter in place on the planes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

from quantumcomputer_tpu_torch.algorithms.qpe import QPEResult, estimate_phase
from quantumcomputer_tpu_torch.models.circuit import MCPHASE, Gate, H, X


def _controlled_grover_iterate(n: int, marked: Sequence[int], control: int) -> List[Gate]:
    """c-Q for one Grover iterate Q = D O on work qubits 0..n-1; only the
    MCZs carry the extra control."""
    qs = tuple(range(n))
    gates: List[Gate] = []
    for k in marked:
        zeros = [q for q in qs if not (k >> q) & 1]
        gates += [X(q) for q in zeros]
        gates.append(MCPHASE(qs + (control,), math.pi))
        gates += [X(q) for q in zeros]
    gates += [H(q) for q in qs]
    gates += [X(q) for q in qs]
    gates.append(MCPHASE(qs + (control,), math.pi))
    gates += [X(q) for q in qs]
    gates += [H(q) for q in qs]
    return gates


@dataclass
class AmplitudeEstimate:
    """a_hat = sin^2(pi * |phase - 1/2|); error <= pi/2^t * (2 sqrt(a) + pi/2^t)
    with probability >= 8/pi^2 (BHMT theorem 12)."""

    a_hat: float
    qpe: QPEResult


def amplitude_estimate(
    n: int,
    marked: Sequence[int],
    t: int,
    r: Optional[float] = None,
    engine=None,
    dtype=None,
    seed: int = 0,
) -> AmplitudeEstimate:
    """Estimate a = len(marked) / 2^n with t counting bits and one
    measurement (draw r, from `seed` when None).  `engine` must span
    Register(L=t, M=n); the default is complex64 (or `dtype`).  The work
    register starts in the uniform superposition (H^n from |0..0>)."""
    marked = sorted(set(int(k) for k in marked))
    if not marked:
        raise ValueError("marked set is empty (a = 0 has no phase to estimate)")
    if not all(0 <= k < (1 << n) for k in marked):
        raise ValueError(f"marked indices {marked} outside [0, 2^{n})")
    if len(marked) == (1 << n):
        raise ValueError("all indices marked (a = 1): theta_a = pi/2 needs no estimation")

    def controlled_powers(j, control):
        # Q^(2^j): the controlled iterate repeated 2^j times.
        return _controlled_grover_iterate(n, marked, control) * (1 << j)

    if engine is None:
        from quantumcomputer_tpu_torch.algorithms.grover import default_engine

        engine = default_engine(t, n, dtype)
    # Uniform superposition from the engine's |0..01> reset: X the set reset
    # bits back to |0..0>, then H^n.
    prep = tuple(X(q) for q in range(n) if (engine.reset_index >> q) & 1) + tuple(H(q) for q in range(n))
    res = estimate_phase(controlled_powers, t, n, r, engine=engine, prep=prep, seed=seed)
    theta = math.pi * abs(res.phase - 0.5)
    return AmplitudeEstimate(a_hat=math.sin(theta) ** 2, qpe=res)
