"""Quantum phase estimation as a generic algorithm.

The counterpart of the JAX package's ``algorithms/qpe.py``.  Shor's
find_period is phase estimation of one unitary, the modular multiply; this
module runs it for any U, in both forms the framework has:

  * ``qpe_circuit`` / ``estimate_phase``: the full-register form, t
    counting qubits, the controlled-U^(2^j) ladder, the fused inverse QFT
    and one measurement (draw ``r``), on any engine;
  * ``run_semiclassical_qpe``: the one-control-qubit form
    (``algorithms/semiclassical.py``): U^(2^j) is an UNCONTROLLED circuit on
    the work register, the control is implicit and the state is the work
    register alone, measured t times (draws ``rs``).

The caller describes U by ``controlled_powers(j, control)``, the gates of
controlled-U^(2^j) on work qubits [0, M) (as the Shor circuit describes the
modular multiply), or, for the semiclassical form, by ``powers(j)``.  With
no draws given, they come from ``seed`` (a CPU torch.Generator).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from quantumcomputer_tpu_torch.algorithms.semiclassical import (
    SemiclassicalRecord,
    _blocks,
    _branch_sums,
    _compute_dtype,
    _rotate,
    _s2,
    collapse_from_a1,
    validate_forced_bits,
)
from quantumcomputer_tpu_torch.models.circuit import Circuit, Gate, H, IQFT_STAGE

ControlledPowers = Callable[[int, int], Iterable[Gate]]
Powers = Callable[[int], Iterable[Gate]]


@dataclass
class QPEResult:
    """One phase-estimation measurement: phase = x / 2^t.

    The engine's fused iQFT keeps the reference's positive-angle convention
    (qc_shor.c:682-688), under which an eigenphase phi reads out as
    x_tilde = -phi*2^t mod 2^t, so x is the negated readout
    (2^t - x_tilde) mod 2^t; `raw` keeps x_tilde for the Shor pipeline."""

    x: int                                  # phase numerator: phase = x / 2^t
    t: int                                  # counting-register width
    raw: int                                # bit-reversed readout (read_omega convention)
    record: Optional[SemiclassicalRecord] = None  # semiclassical form only

    @property
    def phase(self) -> float:
        return self.x / float(1 << self.t)


def _negate_readout(x_tilde: int, t: int) -> int:
    return ((1 << t) - x_tilde) % (1 << t)


def qpe_circuit(controlled_powers: ControlledPowers, t: int, M: int, prep: Circuit = ()) -> Circuit:
    """The full-register QPE circuit on a Register(L=t, M=M) engine: `prep`
    on the work register from the |0..01> reset, H on each counting qubit,
    controlled-U^(2^j) with control M+j, and the fused inverse QFT."""
    gates = list(prep)
    gates += [H(M + j) for j in range(t)]
    for j in range(t):
        gates += list(controlled_powers(j, M + j))
    gates += [IQFT_STAGE(l) for l in range(M + t - 1, M - 1, -1)]
    return tuple(gates)


def estimate_phase(
    controlled_powers: ControlledPowers,
    t: int,
    M: int,
    r: Optional[float] = None,
    engine=None,
    dtype=torch.complex64,
    prep: Circuit = (),
    seed: int = 0,
) -> QPEResult:
    """Build the QPE circuit, run it, measure once with draw r.  `engine`
    must span Register(L=t, M=M) in the standard layout; the default is a
    single-device engine of `dtype`.  The phase is exact when the work
    register holds an eigenstate whose phase has <= t bits."""
    if t > 52:
        raise ValueError(f"t={t} > 52 exceeds the float64 phase mantissa (x / 2^t)")
    if engine is None:
        from quantumcomputer_tpu_torch.algorithms.grover import default_engine

        engine = default_engine(t, M, dtype)
    else:
        reg = engine.register
        if (reg.L, reg.M) != (t, M):
            raise ValueError(
                f"engine register (L={reg.L}, M={reg.M}) does not match QPE geometry (t={t}, M={M})"
            )
        if engine.layout != "standard":
            raise ValueError(
                "QPE circuits assume layout='standard' (work register at bits [0, M)); "
                f"got layout={engine.layout!r}"
            )
    if r is None:
        r = float(engine.draws((), seed))
    idx, _ = engine.measure(engine.run(qpe_circuit(controlled_powers, t, M, prep)), r)
    counting = engine.logical_index(int(idx)) >> M
    x_tilde = 0
    for i in range(t):
        x_tilde = (x_tilde << 1) | ((counting >> i) & 1)
    return QPEResult(x=_negate_readout(x_tilde, t), t=t, raw=x_tilde)


def _blend(w, Uw, phi, r, force: int, rdtype, cdt) -> tuple:
    """One semiclassical QPE step given Uw = U^(2^j) w (a buffer it may
    overwrite): rotate by the deferred phase, fold the two branch weights
    and collapse, with the closed form and the upcast points of the Shor
    step (semiclassical._step, collapse_from_a1) and a generic U in place
    of the modular-multiply gather.  Returns (bit, p_cond, w', phi')."""
    theta = phi * torch.tensor(math.pi, dtype=cdt, device=w.device)
    ct, st = torch.cos(theta), torch.sin(theta)
    s2 = _s2(rdtype, w.device)
    g = Uw.mul_(s2)
    a1 = torch.empty_like(w)
    p0 = torch.zeros((), dtype=cdt, device=w.device)
    p1 = torch.zeros((), dtype=cdt, device=w.device)
    for lo, hi in _blocks(w.shape[1]):
        _rotate(a1[:, lo:hi], g[0, lo:hi], g[1, lo:hi], ct, st, cdt)
        q0, q1 = _branch_sums(w[:, lo:hi], a1[:, lo:hi], s2, cdt)
        p0 += q0
        p1 += q1
    del g
    bit, p_cond, out = collapse_from_a1(w, a1, p0, p1, r, force, rdtype, cdt)
    return bit, p_cond, out, (phi + bit.to(cdt)) / 2


def run_semiclassical_qpe(
    powers: Powers,
    t: int,
    M: int,
    rs=None,
    dtype=torch.complex64,
    prep: Circuit = (),
    forced_bits: Optional[Sequence[int]] = None,
    backend: str = "auto",
    device=None,
    seed: int = 0,
) -> QPEResult:
    """Phase estimation with ONE reused control qubit: the work register
    (2, 2^M) is the whole state, measured t times.  Step s applies
    powers(t-1-s) to a copy of the work state (the engine updates its input
    in place, and the blend still needs w), rotates by the deferred phase
    and measures, collapses and resets the implicit control with draw
    rs[s].  `rs`: t uniforms in the compute dtype (drawn from `seed` when
    None).  `forced_bits` forces the raw readout bits (measurement order).
    The returned QPEResult carries the SemiclassicalRecord in `.record`."""
    if t > 52:
        raise ValueError(f"t={t} > 52 exceeds the float64 phase mantissa (x / 2^t)")
    forced_bits = validate_forced_bits(forced_bits, t, "t")
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    eng = StateVectorEngine(Register(L=0, M=M), dtype=dtype, backend=backend, device=device)
    rdtype = eng.real_dtype
    cdt = _compute_dtype(rdtype)
    if rs is None:
        rs = eng.draws((t,), seed)
    rs = (rs if isinstance(rs, torch.Tensor) else torch.tensor(np.asarray(rs))).to(device=eng.device, dtype=cdt)
    if rs.shape != (t,):
        raise ValueError(f"rs must hold t={t} draws, got shape {tuple(rs.shape)}")
    w = eng.run(tuple(prep)) if prep else eng.initial_state()
    phi = torch.zeros((), dtype=cdt, device=eng.device)
    bits_d, probs_d = [], []
    for s in range(t):
        circ = tuple(powers(t - 1 - s))
        Uw = eng.run(circ, w.clone()) if circ else w.clone()
        force = -1 if forced_bits is None else forced_bits[s]
        bit, p_cond, w, phi = _blend(w, Uw, phi, rs[s], force, rdtype, cdt)
        bits_d.append(bit)
        probs_d.append(p_cond)
    bits = [int(b) for b in torch.stack(bits_d).cpu()]
    probs = [float(p) for p in torch.stack(probs_d).cpu()]
    rec = SemiclassicalRecord.from_bits(bits, probs)
    return QPEResult(x=_negate_readout(rec.x_tilde, t), t=t, raw=rec.x_tilde, record=rec)
