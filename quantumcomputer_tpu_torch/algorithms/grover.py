"""Grover search on the generic gate engine.

The counterpart of the JAX package's ``algorithms/grover.py``: a complete
second algorithm in the circuit IR, H / X layers and the MCPHASE diagonal
(``models/circuit.MCZ``), run unchanged on the engine.

  * oracle for marked index k: MCZ over all qubits, conjugated by X on the
    qubits where k's bit is 0, flips the phase of |k> alone;
  * diffusion: H^n X^n MCZ X^n H^n = 2|s><s| - 1 up to a global phase;
  * floor(pi/4 * sqrt(2^n)) iterations put the success probability at
    sin^2((2r+1) asin(2^{-n/2})) ~ 1 - O(2^{-n}).

On the cuda backend the H and X layers run in the fused-segment kernel and
each MCZ in place on the planes, on the sub-view where every control bit is
1 (``ops/gates.apply_mcphase_planes_``).  The measurement takes a uniform
draw ``r``; with none, one is drawn from ``seed`` (``engine.draws``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from quantumcomputer_tpu_torch.models.circuit import Circuit, H, MCZ, X


def grover_iterations(n: int) -> int:
    """The optimal iteration count floor(pi/4 * sqrt(2^n)) (>= 1)."""
    return max(1, int(math.floor(math.pi / 4.0 * math.sqrt(float(1 << n)))))


def grover_circuit(n: int, marked: int, iterations: Optional[int] = None) -> Circuit:
    """The full search circuit over qubits 0..n-1 for one marked index."""
    if not (0 <= marked < (1 << n)):
        raise ValueError(f"marked index {marked} outside [0, 2^{n})")
    if n < 2:
        raise ValueError("Grover needs n >= 2 (at n=1 one iteration overshoots)")
    iters = grover_iterations(n) if iterations is None else int(iterations)
    qs = range(n)
    zeros = [q for q in qs if not (marked >> q) & 1]
    gates: list = [H(q) for q in qs]
    for _ in range(iters):
        # Oracle: phase-flip |marked>.
        gates += [X(q) for q in zeros]
        gates.append(MCZ(*qs))
        gates += [X(q) for q in zeros]
        # Diffusion about the uniform superposition.
        gates += [H(q) for q in qs]
        gates += [X(q) for q in qs]
        gates.append(MCZ(*qs))
        gates += [X(q) for q in qs]
        gates += [H(q) for q in qs]
    return tuple(gates)


def default_engine(L: int, M: int, dtype=None):
    """A single-device engine for the generic algorithms: complex64 unless
    `dtype` says otherwise, on the card when there is one."""
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    return StateVectorEngine(Register(L=L, M=M), dtype=torch.complex64 if dtype is None else dtype)


def grover_search(
    n: int,
    marked: int,
    r: Optional[float] = None,
    engine=None,
    iterations: Optional[int] = None,
    seed: int = 0,
) -> Tuple[int, float]:
    """Run the search and measure once with draw r (drawn from `seed` when
    None): (measured index, success probability).  The probability is the
    pre-measurement |<marked|psi>|^2, read from the one amplitude on the
    device.  The default engine is complex64."""
    if engine is None:
        engine = default_engine(n, 0)
    if r is None:
        r = float(engine.draws((), seed))
    # The engine resets to |0..01>; Grover starts from |0..0>.
    state = engine.run(grover_circuit(n, marked, iterations), engine.zero_state())
    amp = state[:, marked].double()
    p_success = float(amp[0] * amp[0] + amp[1] * amp[1])
    idx, _ = engine.measure(state, r)
    return int(idx), p_success
