"""Semiclassical (one-control-qubit) period finding on the work register.

The counterpart of the JAX package's ``algorithms/semiclassical.py``, which
holds the derivation.  The Griffiths-Niu semiclassical inverse QFT replaces
the L counting qubits with one control qubit that is prepared, used as the
oracle control, phase-corrected by the bits already measured, Hadamarded,
measured and reset, L times.  The control is implicit: it enters every step
in |0> and leaves it in |0>, so the state is the work register alone,
planar (2, 2^M), and a step is the closed form

    a1  = e^{i theta} U (w / sqrt2)          (U: the modular-multiply map)
    p_m = || (w/sqrt2 + (-1)^m a1) / sqrt2 ||^2
    w'  = (w/sqrt2 + (-1)^m a1) / sqrt2 / sqrt(p_m)

with theta = pi * phi and the deferred phase phi' = (phi + m) / 2.

U runs one of two ways, per step, as in the JAX package:

  * the gather oracle (``_oracle_pass``): 2^22-row index blocks made on the
    device, the branch sums folded into the same sweep;
  * the structured stride permutation (``_oracle_pass_structured``,
    ``ops/modperm.py``: one offset-transpose launch a leg on the card, two
    legs at most), one plane at a time, where the step's multiplier plans;
    the ``sc.permute`` span counts the step's ``legs`` (launches).  On the
    card at float32 / float64 the rest of such a step (the scale, the
    rotation, the branch sums and the collapse) is two passes of
    ``ops/sc_step.py``'s kernels, which never store a1
    (``_structured_step_cuda``).

The JAX package compiles its attempt into one program (fused, per-step or
segmented forms).  Eager PyTorch needs none of that: one step loop updates
the state, and the deferred phase, the bits and the branch probabilities
stay on the device until the attempt ends.  The draws are an argument
(``rs``, L uniforms in the compute dtype), so one draw vector drives both
packages.  dtype="dd64", the JAX package's double-float parity mode, runs
complex128, which the card has natively.  dtype="complex32" stores the work
state in bf16 and rounds where the JAX package does: angles, draws and
branch sums run in float32, the rotation ct * g - st * g' is computed in
float32 and rounded to bf16 once, and the collapse is bf16 arithmetic.
With ``checkpoint_dir`` the attempt snapshots the work state with the bits
and branch probabilities measured so far every ``checkpoint_every`` steps,
in a subdirectory per attempt; a killed attempt called again with the same
arguments and draws resumes from its newest snapshot.  The JAX package needs
two checkpointed forms (per-step dispatches, and segments of its unrolled
structured program); eager PyTorch has one step loop for both oracles, so
one form serves.  ``find_period_semiclassical(mesh=...)`` shards the work
register over a mesh (``parallel/sharded_semiclassical.py``).
"""

from __future__ import annotations

import hashlib
import math
import os
import shutil
from typing import List, Optional

import numpy as np
import torch

from quantumcomputer_tpu_torch.algorithms import number_theory as nt
from quantumcomputer_tpu_torch.ops import gates as tops
from quantumcomputer_tpu_torch.ops import modperm, sc_step
from quantumcomputer_tpu_torch.sim import checkpoint as ckpt
from quantumcomputer_tpu_torch.sim import statevec as sv
from quantumcomputer_tpu_torch.utils import profiling
from quantumcomputer_tpu_torch.utils.logging import get_logger
from quantumcomputer_tpu_torch.utils.memory import device_memory_budget, fused_attempt_fits, step_program_fits

log = get_logger("semiclassical")

# Rows per block of the gather oracle's on-device index vector (32 MB of
# int64) and of the elementwise passes that follow it.
_GATHER_BLOCK_LOG = 22

# Below this M the element gather is cheap; the JAX package's threshold.
_STRUCTURED_MIN_M = 22


def validate_forced_bits(forced_bits, n: int, what: str = "L"):
    """Forced bits as a list of n ints in {0, 1}, or None.  A short list
    would leave steps unforced and any other value gives a non-physical
    collapse, so both raise."""
    if forced_bits is None:
        return None
    if len(forced_bits) != n:
        raise ValueError(f"forced_bits has {len(forced_bits)} entries; expected {what}={n}")
    bits = [int(b) for b in forced_bits]
    if any(b not in (0, 1) for b in bits):
        raise ValueError(f"forced_bits must be 0/1, got {list(forced_bits)!r}")
    return bits


def _compute_dtype(rdtype: torch.dtype) -> torch.dtype:
    """Angles, draws and probability sums run in at least float32."""
    return torch.float32 if rdtype == torch.bfloat16 else rdtype


def _s2(rdtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor(1.0 / math.sqrt(2.0), dtype=rdtype, device=device)


def _branch_sums(w: torch.Tensor, a1: torch.Tensor, s2: torch.Tensor, cdt: torch.dtype) -> tuple:
    """(p0, p1) of one block: b_m = (w*s2 +- a1)*s2, p_m = sum of b_m^2 in cdt."""
    a0 = w * s2
    b0 = (a0 + a1) * s2
    b1 = (a0 - a1) * s2
    p0 = torch.sum(b0[0].to(cdt) ** 2 + b0[1].to(cdt) ** 2)
    p1 = torch.sum(b1[0].to(cdt) ** 2 + b1[1].to(cdt) ** 2)
    return p0, p1


def _blocks(dim: int):
    blk = min(dim, 1 << _GATHER_BLOCK_LOG)
    return ((j, j + blk) for j in range(0, dim, blk))


def _rotate(a1, gr, gi, ct, st, cdt) -> None:
    """a1 = (ct * gr - st * gi, st * gr + ct * gi), computed in cdt and
    rounded to a1's dtype once (a 0-d cdt tensor would not promote a bf16
    tensor, so the operands are widened explicitly)."""
    gr, gi = gr.to(cdt), gi.to(cdt)
    a1[0] = ct * gr - st * gi
    a1[1] = st * gr + ct * gi


def _oracle_pass(w, M: int, rdtype, cdt, C: int, a_inv: int, ct, st) -> tuple:
    """a1 = e^{i theta} U (w/sqrt2) with U the gather by (a_inv * j) mod C,
    and the branch sums (p0, p1), in one blockwise sweep: each block's
    indices are made on the device and die with the block."""
    s2 = _s2(rdtype, w.device)
    a1 = torch.empty_like(w)
    p0 = torch.zeros((), dtype=cdt, device=w.device)
    p1 = torch.zeros((), dtype=cdt, device=w.device)
    for lo, hi in _blocks(1 << M):
        idx = tops.modmul_permute_onchip(a_inv, torch.arange(lo, hi, device=w.device), C)
        g = w[:, idx] * s2  # == (w * s2)[:, idx]: the scale commutes exactly
        _rotate(a1[:, lo:hi], g[0], g[1], ct, st, cdt)
        del g, idx
        q0, q1 = _branch_sums(w[:, lo:hi], a1[:, lo:hi], s2, cdt)
        p0 += q0
        p1 += q1
    return a1, p0, p1


def _count_legs(span, plan) -> None:
    """A recording ``sc.permute`` span counts its step's offset-transpose
    launches: one a leg of each plane."""
    if span is not None:
        span.counts["legs"] = 2 * len(modperm.legs(plan))


def _oracle_pass_structured(w, M: int, rdtype, cdt, plan, ct, st) -> tuple:
    """_oracle_pass with U as the structured stride permutation, one plane
    at a time (each plane's leg transients are freed before the next)."""
    s2 = _s2(rdtype, w.device)
    with profiling.span("sc.permute", w.device) as span:
        gr = modperm.apply_stride_permute(w[0:1], plan)[0].mul_(s2)
        gi = modperm.apply_stride_permute(w[1:2], plan)[0].mul_(s2)
        _count_legs(span, plan)
    with profiling.span("sc.rotate", w.device):
        a1 = torch.empty_like(w)
        if a1.dtype == cdt:
            # The rotation written into a1 plane by plane: one plane of temporaries.
            torch.mul(gr, ct, out=a1[0]).sub_(gi * st)
            torch.mul(gr, st, out=a1[1]).add_(gi * ct)
        else:
            # bf16: widened and rounded once, block by block (temporaries of a block).
            for lo, hi in _blocks(1 << M):
                _rotate(a1[:, lo:hi], gr[lo:hi], gi[lo:hi], ct, st, cdt)
        del gr, gi
    with profiling.span("sc.branch_sums", w.device):
        p0 = torch.zeros((), dtype=cdt, device=w.device)
        p1 = torch.zeros((), dtype=cdt, device=w.device)
        for lo, hi in _blocks(1 << M):
            q0, q1 = _branch_sums(w[:, lo:hi], a1[:, lo:hi], s2, cdt)
            p0 += q0
            p1 += q1
    return a1, p0, p1


def collapse_from_a1(w, a1, p0, p1, r, force: int, rdtype, cdt) -> tuple:
    """Measure, collapse and reset the implicit control given the rotated
    branch a1 and the branch sums: bit = (r * (p0 + p1) >= p0) unless
    force >= 0 names the branch.  The collapsed state is written over a1
    (block by block, in the JAX package's rounding order) and returned.
    Returns (bit, conditional branch probability, new state), the first two
    as 0-d tensors on the device."""
    s2 = _s2(rdtype, w.device)
    total = p0 + p1
    if force >= 0:
        bit = torch.full((), int(force), dtype=torch.int64, device=w.device)
    else:
        bit = (r * total >= p0).to(torch.int64)
    p_branch = torch.where(bit == 1, p1, p0)
    sign = (1 - 2 * bit).to(rdtype)  # exact: a0 + sign*a1 is a0 +- a1
    scale = torch.sqrt(p_branch).to(rdtype)
    for lo, hi in _blocks(w.shape[1]):
        a1[:, lo:hi].mul_(sign).add_(w[:, lo:hi] * s2).mul_(s2).div_(scale)
    return bit, p_branch / total, a1


def _structured_step_cuda(w, plan, ct, st, r, force: int) -> tuple:
    """A structured step on the card at float32 / float64: both planes
    permuted, unscaled, then ops/sc_step's two passes, which fold in the
    1/sqrt2 scale, the rotation, the branch sums and the collapse without
    storing a1.  Rounds as _oracle_pass_structured and collapse_from_a1 do;
    only the sums' order differs.  w' is written over w.  Returns (bit,
    p_cond)."""
    with profiling.span("sc.permute", w.device) as span:
        gr = modperm.apply_stride_permute(w[0:1], plan)[0]
        gi = modperm.apply_stride_permute(w[1:2], plan)[0]
        _count_legs(span, plan)
    with profiling.span("sc.branch_sums", w.device):
        partials = sc_step.branch_sums(w, gr, gi, ct, st)
    with profiling.span("sc.collapse", w.device):
        return sc_step.collapse(w, gr, gi, ct, st, partials, r, force)


def _step(w, phi, M: int, rdtype, C: int, a_inv: int, plan, r, force: int) -> tuple:
    """One step: the oracle pass (structured where `plan` is given, else the
    gather), then the collapse.  phi is the deferred phase, a 0-d tensor in
    the compute dtype.  Returns (bit, p_cond, w', phi'); w' reuses the
    rotated branch's storage, or on the card a structured float32 / float64
    step writes it over w, so the caller drops its reference to w."""
    cdt = _compute_dtype(rdtype)
    theta = phi * torch.tensor(math.pi, dtype=cdt, device=w.device)
    ct, st = torch.cos(theta), torch.sin(theta)
    if plan is not None and w.device.type == "cuda" and rdtype in sc_step.DTYPES:
        bit, p_cond = _structured_step_cuda(w, plan, ct, st, r, force)
        return bit, p_cond, w, (phi + bit.to(cdt)) / 2
    if plan is not None:
        a1, p0, p1 = _oracle_pass_structured(w, M, rdtype, cdt, plan, ct, st)
    else:
        with profiling.span("sc.gather_pass", w.device):
            a1, p0, p1 = _oracle_pass(w, M, rdtype, cdt, C, a_inv, ct, st)
    with profiling.span("sc.collapse", w.device):
        bit, p_cond, out = collapse_from_a1(w, a1, p0, p1, r, force, rdtype, cdt)
    return bit, p_cond, out, (phi + bit.to(cdt)) / 2


def _structured_plans(C: int, a_invs, M: int) -> list:
    """Per-step stride-permutation plans (None where the structured path
    does not apply and the step takes the gather oracle)."""
    return [modperm.plan_stride_permute(C, int(ai), M) for ai in a_invs]


class SemiclassicalRecord:
    """Outcome of one semiclassical period-finding attempt."""

    def __init__(self, bits: List[int], branch_probs: List[float], x_tilde: int, omega: float):
        self.bits = bits  # m_{L-1} .. m_0 in measurement order
        self.branch_probs = branch_probs  # conditional probability per bit
        self.x_tilde = x_tilde
        self.omega = omega
        self.oracles: List[str] = []  # "structured" or "gather", per step

    @property
    def probability(self) -> float:
        """Joint probability of this branch (product of conditionals)."""
        p = 1.0
        for b in self.branch_probs:
            p *= float(b)
        return p

    @classmethod
    def from_bits(cls, bits: List[int], branch_probs: List[float]) -> "SemiclassicalRecord":
        """The readout is bit-reversed (read_omega's convention): the first
        measured bit is the LSB of x~."""
        x_tilde = 0
        for pos, m in enumerate(bits):
            x_tilde |= m << pos
        return cls(bits, branch_probs, x_tilde, x_tilde / float(1 << len(bits)))


def _attempt_fingerprint(C: int, a: int, L: int, M: int, rdtype: torch.dtype, rs: torch.Tensor, forces) -> str:
    """Identity of one attempt for snapshot matching: its arguments, the
    draws and the forced bits pin the whole measurement record (the JAX
    package hashes the key the draws come from)."""
    h = hashlib.sha256()
    h.update(f"semiclassical-work|{C}|{a}|{L}|{M}|{str(rdtype).removeprefix('torch.')}".encode())
    h.update(rs.detach().cpu().numpy().tobytes())
    h.update(np.asarray(forces, np.int32).tobytes())
    return h.hexdigest()[:16]


def _scan_resume(attempt_dir: str, fp: str, L: int, device) -> tuple:
    """The newest snapshot in attempt_dir matching this attempt's
    fingerprint: (state or None, bits, probs, start step)."""
    segs = ckpt.all_segments(attempt_dir)
    for seg in reversed(segs):
        if seg >= L:
            continue
        try:
            loaded, meta = ckpt.load_state(ckpt._segment_path(attempt_dir, seg), device)
        except Exception as e:  # corrupt or unreadable snapshot
            log.warning("semiclassical snapshot %d unreadable (%s): skipped", seg, e)
            continue
        if meta.get("fingerprint") == fp and meta.get("step") == seg:
            log.info("resuming semiclassical attempt at step %d/%d", seg, L)
            return loaded, [int(b) for b in meta["bits"]], [float(p) for p in meta["probs"]], seg
    if segs:
        log.info("no snapshot matches this attempt: cold start")
    return None, [], [], 0


def _phi_from_bits(bits, cdt: torch.dtype, device) -> torch.Tensor:
    """The deferred phase after the measured `bits`, replayed with _step's
    recurrence phi' = (phi + m) / 2 in cdt: the value an uninterrupted run
    carries, bit for bit."""
    phi = torch.zeros((), dtype=cdt, device=device)
    for m in bits:
        phi = (phi + torch.tensor(m, dtype=torch.int64, device=device).to(cdt)) / 2
    return phi


def _use_structured(structured: Optional[bool], M: int, rdtype, device: torch.device) -> bool:
    env = os.environ.get("QC_SC_STRUCTURED")
    if structured is None and env is not None:
        structured = env not in ("0", "false", "")
    if structured is None:
        structured = M >= _STRUCTURED_MIN_M and device.type == "cuda" and fused_attempt_fits(M, rdtype, device)
    return bool(structured)


def run_semiclassical(
    C: int,
    a: int,
    L: int,
    M: int,
    rs,
    dtype=torch.complex64,
    forced_bits: Optional[List[int]] = None,
    structured: Optional[bool] = None,
    device=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 4,
) -> SemiclassicalRecord:
    """One semiclassical attempt: L measure-and-reset steps on the 2^M work
    register, on `device`: None is the CUDA device when one is present and
    the CPU otherwise (``StateVectorEngine``'s rule).

    checkpoint_dir: after every `checkpoint_every` steps (not after the
    last) the work state is snapshotted with the bits and branch
    probabilities so far, under ``sc_<fingerprint>`` (_attempt_fingerprint);
    a call with the same arguments and draws resumes from the newest
    snapshot, its deferred phase replayed from the bits, and the
    subdirectory is removed when the attempt completes.  Each snapshot is a
    host sync.  Not with dtype="dd64", as in the JAX package.

    rs: the L uniform draws (a tensor or array, taken in the compute
    dtype).  forced_bits walks one branch regardless of the draws; the
    branch probabilities are still exact (the distribution-parity hook).

    structured: None auto-selects the stride permutation for M >= 22 on a
    CUDA device while four work states fit its memory; the environment
    variable QC_SC_STRUCTURED (0/1) overrides the choice.  Each step whose
    multiplier does not plan takes the gather oracle."""
    if (1 << M) < C:
        raise ValueError(f"2^M={1 << M} < C={C}: the modular-multiply gate is not unitary")
    if M > 30:
        raise ValueError(f"M={M} > 30 exceeds the int32 index budget")
    if C >= (1 << 30):
        raise ValueError(f"C={C} >= 2^30 exceeds the int32 shift-add modular-arithmetic bound")
    if L > 52:
        raise ValueError(f"L={L} > 52 exceeds the float64 omega mantissa (x_tilde / 2^L)")
    if math.gcd(a, C) != 1:
        raise ValueError(f"a={a} not coprime to C={C}: gate is not a permutation")
    forced_bits = validate_forced_bits(forced_bits, L, "L")
    if checkpoint_dir is not None and checkpoint_every <= 0:
        raise ValueError(f"checkpoint_every={checkpoint_every} must be positive")
    if dtype == "dd64" and checkpoint_dir is not None:
        raise ValueError("dd64 semiclassical has no checkpointing (parity mode)")
    rdtype = sv.real_dtype_of(torch.complex128 if dtype == "dd64" else dtype)
    cdt = _compute_dtype(rdtype)
    device = torch.device(device if device is not None else "cuda" if torch.cuda.is_available() else "cpu")
    if not step_program_fits(M, rdtype, device):
        raise ValueError(
            f"semiclassical work state 2^{M} amplitudes exceeds the device memory budget "
            f"({device_memory_budget(device)} bytes) even for one step"
        )
    with profiling.span("sc.attempt", device):
        rs = (rs if isinstance(rs, torch.Tensor) else torch.tensor(np.asarray(rs))).to(device=device, dtype=cdt)
        if rs.shape != (L,):
            raise ValueError(f"rs must hold L={L} draws, got shape {tuple(rs.shape)}")
        forces = forced_bits if forced_bits is not None else [-1] * L

        a_invs = [pow(pow(a, 1 << (L - 1 - s), C), -1, C) for s in range(L)]
        plans = [None] * L
        if _use_structured(structured, M, rdtype, device):
            with profiling.span("sc.plan") as span:
                plans = _structured_plans(C, a_invs, M)
                if span is not None:
                    span.counts["planned"] = sum(p is not None for p in plans)
        w, bits, probs, start, attempt_dir = None, [], [], 0, None
        if checkpoint_dir is not None:
            fp = _attempt_fingerprint(C, a, L, M, rdtype, rs, forces)
            attempt_dir = os.path.join(checkpoint_dir, f"sc_{fp}")
            w, bits, probs, start = _scan_resume(attempt_dir, fp, L, device)
        if w is None:
            w = sv.initial_planar(M, rdtype, 1, device)
        phi = _phi_from_bits(bits, cdt, device)
        bits_d, probs_d = [], []
        for s in range(start, L):
            with profiling.span("sc.step", device):
                bit, p_cond, w, phi = _step(w, phi, M, rdtype, C, a_invs[s], plans[s], rs[s], forces[s])
            bits_d.append(bit)
            probs_d.append(p_cond)
            if attempt_dir is not None and (s + 1) % checkpoint_every == 0 and s + 1 < L:
                ckpt.save_state(
                    ckpt._segment_path(attempt_dir, s + 1), w,
                    {"kind": "semiclassical", "fingerprint": fp, "step": s + 1,
                     "bits": bits + [int(b) for b in bits_d], "probs": probs + [float(p) for p in probs_d]},
                )
        if bits_d:
            bits += [int(b) for b in torch.stack(bits_d).cpu()]
            probs += [float(p) for p in torch.stack(probs_d).cpu()]
        if attempt_dir is not None:
            shutil.rmtree(attempt_dir, ignore_errors=True)  # attempt complete
        rec = SemiclassicalRecord.from_bits(bits, probs)
        rec.oracles = ["gather" if p is None else "structured" for p in plans]
        return rec


def find_period_semiclassical(
    C: int,
    a: int,
    L: int,
    M: int,
    rs,
    dtype=torch.complex64,
    num_fractions: int = nt.NUM_CONTINUED_FRACTIONS,
    trials_per_denominator: int = nt.TRIALS_PER_DENOMINATOR,
    device=None,
    structured: Optional[bool] = None,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
):
    """The semiclassical attempt, then omega -> continued fractions ->
    period test (the full-register path's classical pipeline).  `device`
    as in run_semiclassical.  With a `mesh` the work register is sharded
    over it (parallel/sharded_semiclassical.run_semiclassical_sharded),
    without checkpointing and not at dd64, as in the JAX package.  Returns
    (period or None, SemiclassicalRecord)."""
    if mesh is not None:
        if checkpoint_dir is not None:
            raise ValueError(
                "checkpoint_dir is single-chip only: the sharded attempt is "
                "one fused dispatch with no step boundary to snapshot"
            )
        if dtype == "dd64":
            raise ValueError("dd64 semiclassical is single-chip (parity mode)")
        from quantumcomputer_tpu_torch.parallel.sharded_semiclassical import run_semiclassical_sharded

        rec = run_semiclassical_sharded(C, a, L, M, rs, mesh, dtype)
    else:
        rec = run_semiclassical(
            C, a, L, M, rs, dtype, structured=structured, device=device, checkpoint_dir=checkpoint_dir
        )
    period = nt.find_period_from_omega(rec.omega, a, C, num_fractions, trials_per_denominator)
    return period, rec
