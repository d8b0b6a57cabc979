"""Textbook phase-oracle algorithms: Bernstein-Vazirani and Deutsch-Jozsa.

The counterpart of the JAX package's ``algorithms/oracle_algorithms.py``.
Both are H^n / phase-oracle / H^n sandwiches whose single measurement is
deterministic on an ideal simulator, so any engine or dtype that runs them
must return the exact hidden string or verdict.  The phase oracles are
products of Z gates, diagonal ops of the fused-segment kernel.

  * Bernstein-Vazirani: U_s|x> = (-1)^{s.x}|x> is prod_{i: s_i=1} Z_i; the
    H sandwich maps it to X^s, so one measurement reads s.
  * Deutsch-Jozsa: f constant -> |0..0> with certainty; f balanced -> never
    |0..0>.  The balanced oracles here are the inner-product family
    f(x) = s.x (s != 0).

The measurement takes a uniform draw ``r``; with none, one is drawn from
``seed`` (``engine.draws``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from quantumcomputer_tpu_torch.algorithms.grover import default_engine
from quantumcomputer_tpu_torch.models.circuit import Circuit, Gate, H, Z


def bv_oracle(n: int, s: int) -> List[Gate]:
    """Phase oracle U_s|x> = (-1)^{s.x}|x>: Z on every set bit of s."""
    if not (0 <= s < (1 << n)):
        raise ValueError(f"hidden string s={s} outside [0, 2^{n})")
    return [Z(q) for q in range(n) if (s >> q) & 1]


def bv_circuit(n: int, s: int) -> Circuit:
    """H^n . U_s . H^n from |0..0>: the full Bernstein-Vazirani circuit."""
    hs = [H(q) for q in range(n)]
    return tuple(hs + bv_oracle(n, s) + hs)


def _run_and_read(n: int, circ: Circuit, r, engine, dtype, seed: int) -> int:
    if engine is None:
        engine = default_engine(n, 0, dtype)
    if r is None:
        r = float(engine.draws((), seed))
    idx, _ = engine.measure(engine.run(circ, engine.zero_state()), r)
    return engine.logical_index(int(idx))


def bernstein_vazirani(
    n: int, s: int, r: Optional[float] = None, engine=None, dtype=None, seed: int = 0
) -> int:
    """Recover the hidden string s in ONE oracle query; the returned index
    equals s with certainty on an ideal simulator (any engine or dtype)."""
    return _run_and_read(n, bv_circuit(n, s), r, engine, dtype, seed)


def deutsch_jozsa(
    n: int,
    oracle: Sequence[Gate],
    r: Optional[float] = None,
    engine=None,
    dtype=None,
    seed: int = 0,
) -> bool:
    """True iff the phase oracle implements a CONSTANT function.

    `oracle` is any diagonal +-1 phase oracle on qubits [0, n) (e.g.
    `bv_oracle(n, s)` with s != 0 for the balanced inner-product family, or
    `[]` for the constant function): constant -> the measurement is |0..0>
    with certainty; balanced -> |0..0> has amplitude exactly 0."""
    hs = [H(q) for q in range(n)]
    return _run_and_read(n, tuple(hs + list(oracle) + hs), r, engine, dtype, seed) == 0
