"""Plain PyTorch gate ops on a flat 2^n complex state vector.

The counterpart of the JAX package's ``ops/gates.py``: each gate is a
reshape + contraction, an elementwise multiply or a gather on the amplitude
tensor, O(2^n) and never a 2^n x 2^n matrix.  These ops are the ``torch``
backend of the engine (the CPU path and the spec the kernels are tested
against) and the glue the ``cuda`` backend keeps where the JAX package also
left the work to XLA: the controlled modular multiply is a gather over the
M-register axis in both packages.

Conventions: qubit b == bit b of the flat index, LSB-first; M register =
bits [0, M).  Functions return new tensors unless their name ends in ``_``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SQRT1_2 = 1.0 / math.sqrt(2.0)


def _entries(m) -> list:
    """Python complex scalars of a small numpy/tensor matrix, row-major."""
    return [complex(v) for v in np.asarray(m, dtype=np.complex128).ravel()]


def apply_1q(state: torch.Tensor, u2, q: int) -> torch.Tensor:
    """Apply a 2x2 unitary to qubit q of the flat state."""
    u00, u01, u10, u11 = _entries(u2)
    x = state.view(-1, 2, 1 << q)
    a, b = x[:, 0], x[:, 1]
    return torch.stack([u00 * a + u01 * b, u10 * a + u11 * b], dim=1).reshape(-1)


def apply_diag_1q(state: torch.Tensor, diag2, q: int) -> torch.Tensor:
    """Apply a diagonal 2-vector on qubit q (phase/S/T/Z gates)."""
    d = torch.tensor(_entries(diag2), dtype=state.dtype, device=state.device)
    return (state.view(-1, 2, 1 << q) * d.view(1, 2, 1)).reshape(-1)


def _view5(state: torch.Tensor, q_hi: int, q_lo: int) -> torch.Tensor:
    """(a, 2, b, 2, c) view exposing bits q_hi > q_lo."""
    if q_hi <= q_lo:
        raise ValueError("q_hi must be the more significant qubit")
    c = 1 << q_lo
    b = 1 << (q_hi - q_lo - 1)
    return state.view(-1, 2, b, 2, c)


def apply_diag_2q(state: torch.Tensor, diag4, q_hi: int, q_lo: int) -> torch.Tensor:
    """Apply a diagonal 4-vector over qubits (q_hi, q_lo), basis
    2*bit(q_hi) + bit(q_lo) (controlled phase, CZ)."""
    f = torch.tensor(_entries(diag4), dtype=state.dtype, device=state.device).view(1, 2, 1, 2, 1)
    return (_view5(state, q_hi, q_lo) * f).reshape(-1)


def apply_2q(state: torch.Tensor, u4, q_hi: int, q_lo: int) -> torch.Tensor:
    """Apply a 4x4 unitary on qubits (q_hi, q_lo), q_hi > q_lo; basis index
    2*bit(q_hi) + bit(q_lo) (qc_shor.c:549-551)."""
    x = _view5(state, q_hi, q_lo)
    u = torch.tensor(_entries(u4), dtype=state.dtype, device=state.device).view(2, 2, 2, 2)
    return torch.einsum("efab,xaybc->xeyfc", u, x).reshape(-1)


def apply_mcphase(state: torch.Tensor, controls, theta: float) -> torch.Tensor:
    """Multi-controlled phase: e^{i theta} where every control bit is 1."""
    mask = 0
    for q in controls:
        mask |= 1 << int(q)
    idx = torch.arange(state.shape[0], device=state.device)
    hit = (idx & mask) == mask
    return torch.where(hit, state * complex(np.exp(1j * float(theta))), state)


def iqft_stage_phases(l: int, M: int, dtype=torch.complex64, device="cpu") -> torch.Tensor:
    """Closed-form diagonal of one inverse-QFT stage ladder on bit-l==1
    states: exp(i*pi*(i & mask)/2^l), mask = 2^l - 2^M, for i < 2^l.  The
    angle is formed in float64 from the exact integer (i & mask)."""
    s = 1 << l
    mask = (1 << l) - (1 << M)
    i = torch.arange(s, dtype=torch.int64, device=device)
    theta = (i & mask).to(torch.float64) * (math.pi / float(s))
    return torch.polar(torch.ones_like(theta), theta).to(dtype)


def apply_iqft_stage(state: torch.Tensor, l: int, M: int) -> torch.Tensor:
    """One fused inverse-QFT stage: H(l) then the stage's whole
    controlled-phase ladder (qc_shor.c:678-690) as one diagonal."""
    x = state.view(-1, 2, 1 << l)
    a, b = x[:, 0], x[:, 1]
    hu = SQRT1_2 * (a + b)
    hv = SQRT1_2 * (a - b)
    if l > M:
        hv = hv * iqft_stage_phases(l, M, state.dtype, state.device)
    return torch.stack([hu, hv], dim=1).reshape(-1)


def modmul_inverse_permutation(C: int, A: int, M: int) -> np.ndarray:
    """Gather indices for the controlled modular multiply: output position j
    takes its amplitude from g^{-1}(j), where g: f -> A*f mod C (f < C),
    identity (f >= C).  Requires gcd(A, C) == 1 and 2^M >= C, or the gate
    is not unitary."""
    A = A % C
    if math.gcd(A, C) != 1:
        raise ValueError(f"A={A} not coprime to C={C}: gate is not a permutation")
    if (1 << M) < C:
        raise ValueError(f"2^M={1 << M} < C={C}: the modular-multiply gate is not unitary (increase M)")
    a_inv = pow(A, -1, C)
    f = np.arange(1 << M, dtype=np.int64)
    return np.where(f < C, (np.int64(a_inv) * f) % C, f)


def _camodc_view(x: torch.Tensor, c_q: int, M: int) -> torch.Tensor:
    if c_q < M:
        raise ValueError("control qubit must be outside the M register")
    return x.view(-1, 2, 1 << (c_q - M), 1 << M)


def apply_c_amodc_dyn(state: torch.Tensor, ginv: torch.Tensor, c_q: int, M: int) -> torch.Tensor:
    """apply_c_amodc with the permutation table given as a tensor."""
    x = _camodc_view(state, c_q, M)
    x1 = torch.index_select(x[:, 1], -1, ginv)
    return torch.stack([x[:, 0], x1], dim=1).reshape(-1)


def apply_c_amodc(state: torch.Tensor, C: int, atox: int, c_q: int, M: int) -> torch.Tensor:
    """Controlled a^x mod C gate (qc_shor.c:595-660) as a blockwise gather:
    where control bit c_q == 1, new[.., 1, .., j] = old[.., 1, .., ginv(j)]."""
    ginv = torch.from_numpy(modmul_inverse_permutation(C, atox, M)).to(state.device)
    return apply_c_amodc_dyn(state, ginv, c_q, M)


def apply_c_amodc_planes_(planar: torch.Tensor, C: int, atox: int, c_q: int, M: int) -> torch.Tensor:
    """apply_c_amodc on a (2, 2^n) planar state, IN PLACE: each plane's
    control==1 half is gathered (one half-plane temporary) and written back."""
    ginv = torch.from_numpy(modmul_inverse_permutation(C, atox, M)).to(planar.device)
    for p in range(2):
        x = _camodc_view(planar[p], c_q, M)
        x[:, 1] = torch.index_select(x[:, 1], -1, ginv)
    return planar


def probabilities(state: torch.Tensor) -> torch.Tensor:
    return state.real * state.real + state.imag * state.imag


def sample_index(state: torch.Tensor, r: float) -> int:
    """Inverse-CDF measurement: smallest index with cumulative |amp|^2 >= r,
    falling through to the last index (qc_shor.c:283-292)."""
    cum = torch.cumsum(probabilities(state), 0)
    draw = torch.tensor(r, dtype=cum.dtype, device=cum.device)
    idx = torch.searchsorted(cum, draw.view(1), side="left")
    return min(int(idx.item()), state.shape[0] - 1)
