"""The Shor period-finding circuit as a Circuit value.

Mirrors quantum_computation (qc_shor.c:712-737): Hadamards on the L
register, the controlled a^(2^j) mod C ladder, then the inverse QFT on the
L register.  Two builds are provided:

  * :func:`shor_circuit` — the production form: the inverse QFT emitted as
    L fused stages (H + closed-form phase-ladder diagonal each);
  * :func:`shor_circuit_reference` — gate-for-gate as the reference emits
    them (every controlled phase its own gate), for parity tests.

A third, :func:`shor_circuit_mhigh`, is the production form in the m_high
physical layout.  Exponents a^(2^j) are computed with exact modular
exponentiation.  The JAX package's slot-template circuits are not ported.
"""

from __future__ import annotations

import math
from typing import List

from quantumcomputer_tpu_torch.models.circuit import (
    CAMODC,
    CPHASE,
    Circuit,
    Gate,
    H,
    IQFT_STAGE,
)


def hadamard_layer(L: int, M: int) -> List[Gate]:
    """H on each qubit of the L register (qc_shor.c:720-722)."""
    return [H(l) for l in range(M, M + L)]


def modexp_ladder(C: int, a: int, L: int, M: int) -> List[Gate]:
    """Controlled a^(2^j) mod C gates, control = L-register qubit M+j
    (qc_shor.c:728-731)."""
    return [CAMODC(C, pow(a, 1 << j, C), M + j) for j in range(L)]


def inverse_qft_fused(L: int, M: int) -> List[Gate]:
    """Inverse QFT on the L register as fused stages (qc_shor.c:678-690)."""
    return [IQFT_STAGE(l) for l in range(M + L - 1, M - 1, -1)]


def inverse_qft_reference(L: int, M: int) -> List[Gate]:
    """Inverse QFT emitted gate-for-gate like the reference loop
    (qc_shor.c:682-688): H(l) then CP(l, k, pi/2^(l-k)) for k = l-1 .. M."""
    gates: List[Gate] = []
    for l in range(M + L - 1, M - 1, -1):
        gates.append(H(l))
        for k in range(l - 1, M - 1, -1):
            gates.append(CPHASE(l, k, math.pi / (1 << (l - k))))
    return gates


def shor_circuit(C: int, a: int, L: int, M: int) -> Circuit:
    """Full period-finding circuit, fused-iQFT form (the fast path)."""
    return tuple(hadamard_layer(L, M) + modexp_ladder(C, a, L, M) + inverse_qft_fused(L, M))


def shor_circuit_mhigh(C: int, a: int, L: int, M: int) -> Circuit:
    """Period-finding circuit in the m_high physical layout.

    Physical qubit map: logical L qubits [M, N) -> physical [0, L); logical
    M qubits [0, M) -> physical [N-M, N).  The modular multiply becomes a
    permutation of whole contiguous rows of the (2^M, 2^L) view, and all
    Hadamard and iQFT work lands on low physical qubits.  Run it on an
    engine with layout="m_high" (iQFT ladder boundary at physical bit 0,
    reset at physical index 2^L, measured indices mapped back by
    engine.logical_index)."""
    gates = [H(j) for j in range(L)]
    gates += [Gate("camodc_high", (j,), meta=(C, pow(a, 1 << j, C), M)) for j in range(L)]
    gates += [IQFT_STAGE(l) for l in range(L - 1, -1, -1)]
    return tuple(gates)


def shor_circuit_reference(C: int, a: int, L: int, M: int) -> Circuit:
    """Full period-finding circuit, reference gate-for-gate form."""
    return tuple(hadamard_layer(L, M) + modexp_ladder(C, a, L, M) + inverse_qft_reference(L, M))
