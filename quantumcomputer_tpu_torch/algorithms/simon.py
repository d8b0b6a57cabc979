"""Simon's hidden-subgroup algorithm: the quantum sample / classical solve
loop that prefigures Shor.

The counterpart of the JAX package's ``algorithms/simon.py``.  For hidden
s != 0, with k the lowest set bit of s, f(x) = x ^ (x_k * s) is linear over
GF(2) and 2-to-1 with collision pairs {x, x ^ s}; its XOR oracle
|x>|y> -> |x>|y ^ f(x)> is a CNOT network (y_j ^= x_j where s_j = 0,
y_j ^= x_j ^ x_k for j != k where s_j = 1).  Each measurement of the
x-register after the H sandwich gives a uniformly random z with
z . s = 0 (mod 2); n - 1 independent equations fix s as the GF(2)
null-space vector (numpy-free host code, as in the JAX package).

Register convention: Register(L=n, M=n): x is the counting register (bits
[n, 2n)), y the work register (bits [0, n)).  Each round takes one uniform
draw from ``rs``; with none, ``max_rounds`` draws come from ``seed``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from quantumcomputer_tpu_torch.algorithms.grover import default_engine
from quantumcomputer_tpu_torch.models.circuit import CNOT, Circuit, H


def simon_oracle(n: int, s: int) -> List:
    """CNOT network of the linear Simon oracle for hidden s: |x>|y> ->
    |x>|y ^ f(x)> with f(x) = x ^ (x_k * s), k = lowest set bit of s.  x
    lives at bits [n, 2n), y at [0, n)."""
    if not (1 <= s < (1 << n)):
        raise ValueError(f"hidden string s={s} must be in [1, 2^{n}) (s=0 is trivial)")
    k = (s & -s).bit_length() - 1
    gates = []
    for j in range(n):
        if j == k:
            continue  # y_k ^= x_k ^ x_k: cancels
        gates.append(CNOT(n + j, j))
        if (s >> j) & 1:
            gates.append(CNOT(n + k, j))
    return gates


def simon_circuit(n: int, s: int) -> Circuit:
    """H^x . oracle . H^x from |0...0> (both registers zero)."""
    hx = [H(n + q) for q in range(n)]
    return tuple(hx + simon_oracle(n, s) + hx)


def _gf2_nullspace(rows: List[int], n: int) -> Optional[int]:
    """The unique nonzero null-space vector of an (n-1)-rank GF(2) row set,
    or None when rank < n-1.  Rows and the result are n-bit ints."""
    basis: List[int] = []
    pivots: List[int] = []
    for r in rows:
        for b, p in zip(basis, pivots):
            if (r >> p) & 1:
                r ^= b
        if r:
            p = r.bit_length() - 1
            basis.append(r)
            pivots.append(p)
    if len(basis) != n - 1:
        return None
    # Back-substitute to reduced row echelon, then read s off the free column.
    for i in range(len(basis)):
        for j in range(len(basis)):
            if i != j and (basis[j] >> pivots[i]) & 1:
                basis[j] ^= basis[i]
    free = next(p for p in range(n) if p not in pivots)
    s = 1 << free
    for b, p in zip(basis, pivots):
        if (b >> free) & 1:
            s |= 1 << p
    return s


@dataclass
class SimonResult:
    s: int                 # recovered hidden string
    rounds: int            # quantum samples consumed (z = 0 draws included)
    equations: List[int]   # the measured NONZERO z vectors (z . s = 0 for all)


def simon_search(
    n: int,
    s: int,
    rs=None,
    engine=None,
    dtype=None,
    max_rounds: int = 0,
    seed: int = 0,
) -> SimonResult:
    """Run Simon's algorithm end to end: sample z vectors (each orthogonal
    to s over GF(2)) until they span the (n-1)-dimensional complement, then
    solve for s.  Round k measures with draw rs[k - 1]; at most max_rounds
    rounds (default 4n + 12, as in the JAX package), and no more than `rs`
    holds."""
    if engine is None:
        engine = default_engine(n, n, dtype)
    if max_rounds <= 0:
        max_rounds = 4 * n + 12
    if rs is None:
        rs = engine.draws((max_rounds,), seed)
    circ = simon_circuit(n, s)
    zs: List[int] = []
    for rounds in range(1, min(max_rounds, len(rs)) + 1):
        idx, _ = engine.measure(engine.run(circ, engine.zero_state()), float(rs[rounds - 1]))
        z = (engine.logical_index(int(idx)) >> n) & ((1 << n) - 1)  # x-register readout
        if bin(z & s).count("1") % 2:
            raise RuntimeError(f"sampled z={z} is not orthogonal to s={s}")
        if not z:
            continue  # adds no equation
        zs.append(z)
        got = _gf2_nullspace(zs, n)
        if got is not None:
            return SimonResult(s=got, rounds=rounds, equations=zs)
    raise RuntimeError(
        f"Simon sampling did not reach rank {n - 1} in {max_rounds} rounds "
        "(probability ~2^-rounds; re-run with other draws)"
    )
