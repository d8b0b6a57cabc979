"""Plain PyTorch gate ops on a flat 2^n complex state vector.

The counterpart of the JAX package's ``ops/gates.py``: each gate is a
reshape + contraction, an elementwise multiply or a gather on the amplitude
tensor, O(2^n) and never a 2^n x 2^n matrix.  These ops are the ``torch``
backend of the engine (the CPU path and the spec the kernels are tested
against) and the glue the ``cuda`` backend keeps where the JAX package also
left the work to XLA.  The standard layout's controlled modular multiply is
a gather over the M-register axis in both packages; the cuda backend runs a
lone one as the one-op camodc segment (``ops/fused.py``), and
``apply_c_amodc_planes_`` is the gather where the gate has no op form (M
outside 1..13), through the index table that ``inverse_index_table`` builds
and keeps on the state's device.  The m_high layout's
oracle ops (``apply_camodc_high``, ``apply_camodc_ladder_high``) are the
plain versions of the kernels in ``ops/oracle.py``.

Conventions: qubit b == bit b of the flat index, LSB-first; M register =
bits [0, M) in the standard layout, the top M bits in the m_high layout.
Functions return new tensors unless their name ends in ``_``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from quantumcomputer_tpu_torch.utils import profiling

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


#: Calls of apply_mcphase_planes_, the planar mcphase (torch glue, no kernel).
MCPHASE_CALLS = 0


def mcphase_view(x: torch.Tensor, controls) -> torch.Tensor:
    """The strided view of a flat 2^n tensor at the indices whose control
    bits are all 1: one dimension per run of free bits, the storage offset
    the control mask (a 0-d view when every bit is a control)."""
    n = x.shape[0].bit_length() - 1
    mask = 0
    for q in controls:
        mask |= 1 << int(q)
    sizes, strides = [], []
    q = 0
    while q < n:
        start = q
        while q < n and not (mask >> q) & 1:
            q += 1
        if q > start:
            sizes.append(1 << (q - start))
            strides.append(1 << start)
        q += 1
    return x.as_strided(sizes[::-1], strides[::-1], x.storage_offset() + mask)


def apply_mcphase(state: torch.Tensor, controls, theta: float) -> torch.Tensor:
    """Multi-controlled phase: e^{i theta} where every control bit is 1."""
    out = state.clone()
    mcphase_view(out, controls).mul_(complex(np.exp(1j * float(theta))))
    return out


def apply_mcphase_planes_(planar: torch.Tensor, controls, theta: float) -> torch.Tensor:
    """apply_mcphase on a planar state, in place: only the sub-view where
    every control bit is 1 is read and written, as (re c - im s, re s + im c)
    with the phase c + i s rounded to the complex dtype, as the JAX
    package's complex multiply takes it.  bf16 planes are widened to
    float32, multiplied there and rounded once."""
    global MCPHASE_CALLS
    cdt = torch.float32 if planar.dtype == torch.bfloat16 else planar.dtype
    ph = np.asarray(np.exp(1j * float(theta)), np.complex128 if cdt == torch.float64 else np.complex64)
    c = torch.tensor(float(ph.real), dtype=cdt, device=planar.device)
    s = torch.tensor(float(ph.imag), dtype=cdt, device=planar.device)
    re, im = mcphase_view(planar[0], controls), mcphase_view(planar[1], controls)
    xr, xi = re.to(cdt), im.to(cdt)
    new_re = xr * c - xi * s
    new_im = xr * s + xi * c
    re.copy_(new_re)
    im.copy_(new_im)
    MCPHASE_CALLS += 1
    return planar


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


def modmul_inverse(C: int, A: int, M: int) -> int:
    """A^-1 mod C, the multiplier of the controlled modular multiply's
    inverse map.  Requires gcd(A, C) == 1 and 2^M >= C, or the gate is not
    unitary."""
    A = A % C
    if math.gcd(A, C) != 1:
        raise ValueError(f"A={A} not coprime to C={C}: gate is not a permutation")
    if (1 << M) < C:
        raise ValueError(f"2^M={1 << M} < C={C}: the modular-multiply gate is not unitary (increase M)")
    return pow(A, -1, C)


def modmul_inverse_permutation(C: int, A: int, M: int) -> np.ndarray:
    """Gather indices for the controlled modular multiply: output position j
    takes its amplitude from g^{-1}(j), where g: f -> A*f mod C (f < C),
    identity (f >= C).  Raises as modmul_inverse does."""
    a_inv = modmul_inverse(C, A, M)
    f = np.arange(1 << M, dtype=np.int64)
    return np.where(f < C, (np.int64(a_inv) * f) % C, f)


def modmul_onchip(a: int, j: torch.Tensor, C: int) -> torch.Tensor:
    """Elementwise (a * j) mod C on j's device, in int64: exact for a, j
    < 2^30, where the product stays below 2^60.  The JAX package's
    ``modmul_onchip`` reaches the same values by an int32 shift-add, since
    the TPU has no int64."""
    return (j.to(torch.int64) * int(a)) % int(C)


def modmul_permute_onchip(a: int, j: torch.Tensor, C: int) -> torch.Tensor:
    """The oracle's index map on the device: (a * j) mod C for j < C,
    identity for j >= C (``modmul_inverse_permutation``'s table, element by
    element, for a = A^-1)."""
    j = j.to(torch.int64)
    return torch.where(j < C, modmul_onchip(a, j, C), j)


def inverse_index_table(C: int, A: int, M: int, device) -> torch.Tensor:
    """modmul_inverse_permutation's table as a (2^M,) int32 tensor built on
    `device` (modmul_permute_onchip of A^-1 mod C), the index that
    index_select and the row-gather kernel both take.  The last 256 are
    kept per (C, A mod C, M, device); a miss records an oracle.table span of
    the table's bytes.  Raises as modmul_inverse does."""
    return _index_table(int(C), int(A) % int(C), int(M), torch.device(device))


@lru_cache(maxsize=256)  # 32 KB a table at M = 13
def _index_table(C: int, A: int, M: int, device: torch.device) -> torch.Tensor:
    a_inv = modmul_inverse(C, A, M)
    with profiling.span("oracle.table", device, bytes=4 << M):
        return modmul_permute_onchip(a_inv, torch.arange(1 << M, device=device), C).to(torch.int32)


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


def modmul_permutation(C: int, A: int, M: int) -> np.ndarray:
    """Forward map g over the M register: f -> (A*f) mod C for f < C,
    identity for f >= C (qc_shor.c:608-657); the JAX package's
    ``sim/reference.modmul_permutation``.  No unitarity check: when 2^M < C
    the image spills past the register."""
    f = np.arange(1 << M, dtype=np.int64)
    return np.where(f < C, (A % C) * f % C, f)


def apply_c_amodc_strict(state: torch.Tensor, C: int, atox: int, c_q: int, M: int) -> torch.Tensor:
    """Reference bug-compatibility oracle (StateVectorEngine(strict_reference=
    True)): the scatter-add realization of the reference's matrix
    construction (qc_shor.c:595-660), which only warns when 2^M < C; the
    image f' = A*f mod C then spills past the M register and collides,
    and the gate is not unitary.  As the JAX package's scatter does,
    updates whose index falls past the state are dropped."""
    dim = state.shape[0]
    g = torch.from_numpy(modmul_permutation(C, atox % C, M)).to(state.device)
    k = torch.arange(dim, device=state.device)
    m_mask = (1 << M) - 1
    j = torch.where(((k >> c_q) & 1) == 1, (k & ~m_mask) | g[k & m_mask], k)
    keep = j < dim
    return torch.zeros_like(state).index_add_(0, j[keep], state[keep])


def apply_c_amodc_planes_(planar: torch.Tensor, C: int, atox: int, c_q: int, M: int) -> torch.Tensor:
    """apply_c_amodc on a (2, 2^n) planar state, IN PLACE: each plane's
    control==1 half is gathered (one half-plane temporary) through
    inverse_index_table and written back."""
    ginv = inverse_index_table(C, atox, M, planar.device)
    for p in range(2):
        x = _camodc_view(planar[p], c_q, M)
        x[:, 1] = torch.index_select(x[:, 1], -1, ginv)
    return planar


def _row_view(state: torch.Tensor, M: int) -> torch.Tensor:
    """The (2^M, 2^(n-M)) view of a flat state: row = work-register value
    in the m_high layout."""
    return state.view(1 << M, -1)


def _column_bits(rest: int, bits, device) -> torch.Tensor:
    """mask[col] = sum_k bit(col, bits[k]) << k over the 2^(n-M) columns."""
    col = torch.arange(rest, device=device)
    mask = torch.zeros_like(col)
    for k, c in enumerate(bits):
        mask |= ((col >> int(c)) & 1) << k
    return mask


def apply_camodc_high(state: torch.Tensor, C: int, atox: int, c_phys: int, M: int) -> torch.Tensor:
    """Controlled a^x mod C gate in the m_high layout (work register in the
    top M bits): a gather over the rows of the (2^M, 2^(n-M)) view, kept
    where column bit c_phys is 1.  Works on complex states and on single
    real planes alike."""
    x = _row_view(state, M)
    if (1 << c_phys) >= x.shape[1]:
        raise ValueError("control must be a low (non-M) bit")
    ginv = torch.from_numpy(modmul_inverse_permutation(C, atox, M)).to(state.device)
    ctrl = _column_bits(x.shape[1], (c_phys,), state.device).bool()
    return torch.where(ctrl, torch.index_select(x, 0, ginv), x).reshape(-1)


def modexp_combo_multipliers(C: int, A_list) -> np.ndarray:
    """combo[mask] = prod_k (A_k^{-1})^{bit_k(mask)} mod C.

    The controlled modular multiplies all multiply the work register by
    constants mod C, so they commute: a run of K of them composes into one
    permutation whose multiplier depends only on the K control bits.  From
    the native layer when it is available, else in Python."""
    from quantumcomputer_tpu_torch.algorithms import _native

    if _native.available():
        out = _native.combo_multipliers(int(C), [int(A) % C for A in A_list])
        if out is None:
            raise ValueError(f"some multiplier not coprime to C={C}: not a permutation")
        return out.astype(np.int64)
    K = len(A_list)
    ainvs = [pow(int(A) % C, -1, C) for A in A_list]
    combos = np.ones(1 << K, np.int64)
    for mask in range(1, 1 << K):
        low = mask & -mask
        combos[mask] = (combos[mask ^ low] * ainvs[low.bit_length() - 1]) % C
    return combos


def ladder_source_rows(C: int, A_list, controls, M: int, rest: int, device) -> torch.Tensor:
    """(2^M, rest) int64 source rows of a composed run: (combo * f) mod C
    for f < C, identity otherwise, combo selected by each column's control
    bits (controls[k] = column bit of gate k)."""
    if C * C >= (1 << 31):
        raise ValueError(f"C={C} too large for int32 ladder composition")
    if (1 << M) < C:
        raise ValueError(f"2^M={1 << M} < C={C}: the modular-multiply gate is not unitary (increase M)")
    combos = torch.from_numpy(modexp_combo_multipliers(C, A_list)).to(device)
    mult = combos[_column_bits(rest, controls, device)]
    f = torch.arange(1 << M, dtype=torch.int64, device=device)[:, None]
    return torch.where(f < C, (mult[None, :] * f) % C, f.expand(-1, rest))


def apply_camodc_ladder_high(state: torch.Tensor, C: int, A_list, controls, M: int) -> torch.Tensor:
    """A run of controlled modular multiplies as ONE gather, m_high layout:
    out[f, col] = in[(combo(col) * f) mod C, col].  Works on complex states
    and on single real planes alike."""
    x = _row_view(state, M)
    return torch.gather(x, 0, ladder_source_rows(C, A_list, controls, M, x.shape[1], state.device)).reshape(-1)


def apply_camodc_high_planes_(planar: torch.Tensor, C: int, atox: int, c_phys: int, M: int) -> torch.Tensor:
    """apply_camodc_high on a (2, 2^n) planar state, written back in place
    (one plane-sized temporary at a time)."""
    for p in range(2):
        planar[p].copy_(apply_camodc_high(planar[p], C, atox, c_phys, M))
    return planar


def apply_camodc_ladder_high_planes_(planar: torch.Tensor, C: int, A_list, controls, M: int) -> torch.Tensor:
    """apply_camodc_ladder_high on a (2, 2^n) planar state, written back in
    place (one plane-sized temporary at a time)."""
    for p in range(2):
        planar[p].copy_(apply_camodc_ladder_high(planar[p], C, A_list, controls, M))
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
