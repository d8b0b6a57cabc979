"""Single-device state-vector engine on planar torch tensors.

The counterpart of the JAX package's ``sim/engine.py``.  PyTorch runs
eagerly, so there is no compiled program per circuit; the engine caches
the plan per circuit instead.  Backends:

  * ``torch``: every gate through the plain torch ops (``ops/gates.py``),
    per gate.  The CPU path and the spec the kernels are tested against.
  * ``cuda``: the circuit is planned (``plan_circuit``): the m_high
    layout's oracle runs are fused into ladders or pairs as the JAX
    package's pallas path fuses them, then the rest is cut into fused
    segments (``ops/fused.plan_circuit``), each applied by the
    fused-segment kernel in one in-place pass.  The m_high oracles go
    through the row-permutation kernels (``ops/oracle.py``).  The standard
    layout's oracle is a gather, as it is an XLA gather in the JAX
    package: each gate the one-op camodc segment (``fused.gate_segment``),
    which the router sends to one in-place launch of the camodc
    permutation kernel (the fused kernel's camodc op where the permutation
    does not take the shape), unless ``oracle="benes"``: then each oracle
    is a camodc op inside a fused segment's pass, two to a segment (with
    ``fuse=False`` it stays the lone gate, as in the JAX package).  Measurement of f32
    states of >= 2^16 amplitudes goes through the block-sum kernel
    (``ops/measure.py``).  With
    ``fuse=False`` the circuit runs gate by gate (``apply_gate_planes_``),
    every gate with a fused-op form as a one-op segment of the same
    kernel: on this backend no such gate ever runs through the plain ops.
  * ``auto``: ``cuda`` when a CUDA device is present, else ``torch``.

Options, as in the JAX package's engine: ``strict_reference=True`` runs the
oracles as the reference's warn-and-wrap scatter (``camodc_strict``; torch
backend, standard layout, on the CUDA device when one is present);
``nan_checks=True`` prints ``*** non-finite
amplitudes after <label>`` after each gate or segment whose state holds a
non-finite amplitude, with the JAX package's labels.

dtype="complex32" (bf16 planes, computed in float32 and rounded once a
pass, ``sim/statevec.py``) needs the ``cuda`` backend, as the JAX package's
needs pallas: every kernel of the cuda path has a bf16 instance (the
gather oracle's permutation moves bf16 bits as they are), and the per-gate
path of a gate with no op form widens bf16 in torch.  ``backend="auto"``
resolves to ``cuda`` for it and places it as complex64 is placed: on the
CUDA device when one is present, else on the CPU, where every kernel
wrapper takes its plain version on the CPU planes (rounding once a pass, as
the kernel does; the JAX package's interpret mode off the TPU).  An explicit ``backend="cuda"`` with
no CUDA device raises.

Layouts: ``standard`` (the reference's bit convention) and ``m_high`` (the
work register in the top physical bits; ``models/shor_circuit.
shor_circuit_mhigh`` builds its circuit, ``logical_index`` maps measured
indices back).

Buffers.  Every kernel updates the state in place except the out-of-place
ladder, which needs a second state-sized buffer.  A ladder that joins a
strip run (strip_run: the m_high oracle stage of the flagship plans, walks
and ladder, merged into one in-place pass) needs none.  A cuda run
allocates that scratch buffer at its first ladder run alone and then
ping-pongs between the two, so a ladder costs no copy.  The run returns
whichever buffer holds the result when the engine made the state
(``run_and_measure_index``, the main path); when the caller passed the
state in, the result is copied back into it once, at the end, and only if
it ended in the scratch buffer.  The planner
fuses ladders only when two states fit the device
(``utils/memory.two_state_programs_fit``); otherwise it fuses in-place
pairs, as the JAX package does at its memory ceiling.

Randomness is injected: every measuring entry point takes its uniform draw
``r`` in [0, 1) as an argument, so one draw can drive both packages.

Gradients: ``run`` is differentiable in its input planes, as the JAX
engine's is through its custom VJP.  The backward applies the dagger
circuit (``models/circuit.dagger_circuit``) to the cotangent through the
same plan and kernels as the forward pass, so no intermediate state is
saved (``_AdjointRun``); a run with no gradient asked for keeps its in-place
path.  ``run_with_norms``, ``measure`` and ``sample`` take no gradient.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from quantumcomputer_tpu_torch.models.circuit import (
    DENSE_1Q,
    DIAGONAL_1Q,
    Circuit,
    Gate,
    dagger_circuit,
    gate_matrix_1q,
    gate_matrix_2q,
)
from quantumcomputer_tpu_torch.ops import fused
from quantumcomputer_tpu_torch.ops import gates as tops
from quantumcomputer_tpu_torch.ops import measure
from quantumcomputer_tpu_torch.ops import oracle
from quantumcomputer_tpu_torch.sim import statevec as sv
from quantumcomputer_tpu_torch.utils import profiling
from quantumcomputer_tpu_torch.utils.memory import device_memory_budget, state_fits, two_state_programs_fit


@dataclass(frozen=True)
class Register:
    """Qubit register geometry (qc_shor.c:194-203): L counting qubits in the
    high bits [M, N), M work qubits in the low bits [0, M)."""

    L: int
    M: int

    @property
    def n(self) -> int:
        return self.L + self.M


def apply_gate(state: torch.Tensor, g: Gate, M: int) -> torch.Tensor:
    """Dispatch one Gate onto a flat complex state with the plain ops."""
    name = g.name
    if name in DENSE_1Q:
        return tops.apply_1q(state, gate_matrix_1q(g), g.qubits[0])
    if name in DIAGONAL_1Q:
        return tops.apply_diag_1q(state, np.diagonal(gate_matrix_1q(g)), g.qubits[0])
    if name in ("cz", "cphase"):
        q_hi, q_lo = g.qubits if g.qubits[0] > g.qubits[1] else (g.qubits[1], g.qubits[0])
        return tops.apply_diag_2q(state, np.diagonal(gate_matrix_2q(g)), q_hi, q_lo)
    if name == "mcphase":
        return tops.apply_mcphase(state, g.qubits, g.params[0])
    if name in ("cnot", "swap", "u2q"):
        m = gate_matrix_2q(g)
        q_hi, q_lo = g.qubits
        if q_hi < q_lo:
            q_hi, q_lo = q_lo, q_hi
            p = [0, 2, 1, 3]
            m = m[np.ix_(p, p)]
        return tops.apply_2q(state, m, q_hi, q_lo)
    if name == "camodc":
        C, atox = g.meta
        return tops.apply_c_amodc(state, C, atox, g.qubits[0], M)
    if name == "camodc_strict":
        # Emitted only by the strict_reference engine's rewrite (_prep).
        C, atox = g.meta
        return tops.apply_c_amodc_strict(state, C, atox, g.qubits[0], M)
    if name == "camodc_high":
        C, atox, m_reg = g.meta
        return tops.apply_camodc_high(state, C, atox, g.qubits[0], m_reg)
    if name == "camodc_ladder_high":
        C, m_reg = g.meta[0], g.meta[1]
        return tops.apply_camodc_ladder_high(state, C, g.meta[2:], g.qubits, m_reg)
    if name == "iqft_stage":
        return tops.apply_iqft_stage(state, g.qubits[0], M)
    raise ValueError(f"gate not supported by quantumcomputer_tpu_torch: {g}")


def _store_(planar: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    planar[0].copy_(z.real)
    planar[1].copy_(z.imag)
    return planar


def apply_gate_planes_(planar: torch.Tensor, g: Gate, M: int) -> torch.Tensor:
    """One gate on a planar state, in place.  A gate with a fused-op form
    runs as a one-op segment through fused.apply_fused (the kernel for a
    CUDA tensor, its plain version for a CPU tensor), as the JAX package's
    pallas_gates runs single gates, a standard-layout oracle as the one-op
    camodc segment (fused.gate_segment with M; the torch gather
    tops.apply_c_amodc_planes_ where M is outside 1..13); mcphase through
    the planar in-place mcphase (tops.apply_mcphase_planes_); any other
    gate through the complex plain ops.  The m_high oracles dispatch as the JAX package's pallas_gates
    does: a lone gate to the masked walk when perm_supported, else to the
    cycle walk; a K = 2 run to the in-place pair when
    pair_inplace_supported, any other run to the out-of-place ladder
    through a temporary and a copy back (apply_circuit_fused_ avoids that
    copy)."""
    seg = fused.gate_segment(g, sv.num_qubits(planar), fused.TILE_BITS[planar.dtype], M)
    if seg is not None:
        return fused.apply_fused(planar, seg[0], seg[1], M)
    if g.name == "mcphase":
        return tops.apply_mcphase_planes_(planar, g.qubits, g.params[0])
    if g.name == "camodc":
        C, atox = g.meta
        return tops.apply_c_amodc_planes_(planar, C, atox, g.qubits[0], M)
    if g.name == "camodc_high":
        C, atox, m_reg = g.meta
        n, itemsize = sv.num_qubits(planar), planar.element_size()
        if oracle.perm_supported(g.qubits[0], m_reg, n, itemsize):
            return oracle.apply_camodc_high_perm_planar(planar, C, atox, g.qubits[0], m_reg)
        return oracle.apply_camodc_high_cycle_planar(planar, C, atox, g.qubits[0], m_reg)
    if g.name == "camodc_ladder_high":
        C, m_reg = g.meta[0], g.meta[1]
        if _pair_in_place(planar, g):
            return oracle.apply_camodc_pair_inplace_planar(planar, C, g.meta[2:], g.qubits, m_reg)
        out = oracle.apply_camodc_ladder_high_planar(planar, torch.empty_like(planar), C, g.meta[2:], g.qubits, m_reg)
        return planar.copy_(out)
    return _store_(planar, apply_gate(sv.to_complex(planar), g, M))


def _pair_in_place(planar: torch.Tensor, g: Gate) -> bool:
    return oracle.pair_inplace_supported(g.qubits, g.meta[1], sv.num_qubits(planar), planar.element_size())


def check_finite(x: torch.Tensor, label: str) -> None:
    """The JAX engine's nan_checks hook: print its line when `x` holds a
    non-finite value (a host sync; only with nan_checks on)."""
    if not bool(torch.isfinite(x).all()):
        print(f"*** non-finite amplitudes after {label}")


def circuit_plain(
    z: torch.Tensor, circuit: Circuit, M: int, norms: Optional[list] = None, nan_checks: bool = False
) -> torch.Tensor:
    """Every gate through the plain ops on a flat complex state, each gate
    out of place, so autograd runs through the circuit.  With a `norms`
    list, the norm after each gate is appended to it (a 0-d tensor on the
    state's device); with nan_checks, check_finite after each gate."""
    for i, g in enumerate(circuit):
        z = apply_gate(z, g, M)
        if norms is not None:
            norms.append(torch.sum(z.real * z.real) + torch.sum(z.imag * z.imag))
        if nan_checks:
            check_finite(z, f"gate {i} {g.name}{g.qubits}")
    return z


def apply_circuit_plain_(
    planar: torch.Tensor, circuit: Circuit, M: int, norms: Optional[list] = None, nan_checks: bool = False
) -> torch.Tensor:
    """The torch backend: circuit_plain, the result written back into
    `planar`."""
    return _store_(planar, circuit_plain(sv.to_complex(planar), circuit, M, norms, nan_checks))


def apply_circuit_per_gate_(
    planar: torch.Tensor, circuit: Circuit, M: int, norms: Optional[list] = None, nan_checks: bool = False
) -> torch.Tensor:
    """The cuda backend with fusion off: every gate in place through
    apply_gate_planes_ (the JAX package's apply_circuit_planes(fuse=False)).
    `norms` and `nan_checks` as in apply_circuit_plain_."""
    for i, g in enumerate(circuit):
        apply_gate_planes_(planar, g, M)
        if norms is not None:
            norms.append(sv.norm(planar))
        if nan_checks:
            check_finite(planar, f"gate {i} {g.name}{g.qubits}")
    return planar


MAX_LADDER_RUN = oracle.MAX_LADDER_K

#: Plans an engine keeps, the circuits used last.
PLAN_CACHE = 64


def fuse_oracle_ladders(
    circuit: Circuit, M: int, eligible=None, max_run: int = MAX_LADDER_RUN, min_run: int = 2
) -> Circuit:
    """Rewrite maximal runs of >= min_run modular-multiply gates (same C,
    same work register, distinct controls) into single composed-ladder
    gates: the gates commute, so a run of K composes into one permutation
    whose multiplier the K control bits select
    (ops/gates.modexp_combo_multipliers).  The JAX package's
    fuse_oracle_ladders, ported as it is.

    `eligible(gate)` (optional) limits which gates may join a run."""
    out: list = []
    gates = list(circuit)
    i = 0
    while i < len(gates):
        g = gates[i]
        if g.name in ("camodc", "camodc_high") and (eligible is None or eligible(g)):
            C = g.meta[0]
            m_reg = g.meta[2] if g.name == "camodc_high" else M
            j = i + 1
            while j < len(gates):
                if j - i >= max_run:
                    break  # caps the 2^K table; longer runs split
                h = gates[j]
                if h.name != g.name or h.meta[0] != C:
                    break
                if eligible is not None and not eligible(h):
                    break
                if g.name == "camodc_high" and h.meta[2] != m_reg:
                    break
                if h.qubits[0] in {gates[k].qubits[0] for k in range(i, j)}:
                    break  # composition holds only for distinct control bits
                j += 1
            # C must fit the work register, or the composed gather would
            # read rows >= 2^M; such gates stay unfused and their per-gate
            # path raises its clean error.
            if j - i >= max(2, min_run) and C * C < (1 << 31) and C <= (1 << m_reg):
                run = gates[i:j]
                name = "camodc_ladder_high" if g.name == "camodc_high" else "camodc_ladder"
                out.append(
                    Gate(
                        name,
                        qubits=tuple(h.qubits[0] for h in run),
                        meta=(C, m_reg) + tuple(int(h.meta[1]) % C for h in run),
                    )
                )
                i = j
                continue
        out.append(g)
        i += 1
    return tuple(out)


def fuse_oracles(circuit: Circuit, M: int, n: int, itemsize: int, ladder_fits: bool) -> Circuit:
    """The cuda backend's oracle rewrite, as the JAX package's pallas path
    plans it (its engine.apply_circuit_planes): when two states fit, runs of
    m_high oracles the ladder kernel accepts become ladders; otherwise K = 2
    in-place pairs, and any pair the in-place kernel would refuse is split
    back into single gates, so nothing out of place runs at the memory
    ceiling."""
    if ladder_fits:
        return fuse_oracle_ladders(
            circuit, M,
            eligible=lambda g: g.name == "camodc_high"
            and oracle.ladder_high_supported((g.qubits[0],), g.meta[2], n, itemsize),
        )
    circuit = fuse_oracle_ladders(
        circuit, M,
        eligible=lambda g: g.name == "camodc_high"
        and oracle.pair_member_supported(g.qubits[0], g.meta[2], n, itemsize),
        max_run=2,
    )
    split: list = []
    for g in circuit:
        if g.name == "camodc_ladder_high" and not oracle.pair_inplace_supported(g.qubits, g.meta[1], n, itemsize):
            C, m_reg = g.meta[0], g.meta[1]
            split.extend(Gate("camodc_high", (c,), meta=(C, A, m_reg)) for c, A in zip(g.qubits, g.meta[2:]))
        else:
            split.append(g)
    return tuple(split)


def plan_circuit(
    circuit: Circuit, M: int, n: int, real_dtype: torch.dtype, device, fuse_oracle: bool = False
) -> list:
    """The cuda backend's plan of a circuit on an n-qubit state of plane
    dtype `real_dtype` on `device`: fuse_oracles, then fused segments and
    single gates; with fuse_oracle (``oracle="benes"``) the standard
    layout's oracles join the fused segments as camodc ops.  The segments of
    a plane dtype that apply_fused groups into matrix products are planned
    for them (``fused.groups``)."""
    itemsize = torch.empty((), dtype=real_dtype).element_size()
    circuit = fuse_oracles(circuit, M, n, itemsize, two_state_programs_fit(n, real_dtype, device))
    return fused.plan_circuit(
        circuit, n, M, fused.TILE_BITS[real_dtype], fuse_oracle=fuse_oracle, group=fused.groups(real_dtype, n)
    )


def apply_circuit_fused_(
    planar: torch.Tensor,
    circuit: Circuit,
    M: int,
    plan=None,
    norms: Optional[list] = None,
    nan_checks: bool = False,
) -> torch.Tensor:
    """The cuda backend's path: fused segments through fused.apply_fused
    (the kernel for CUDA tensors, its plain version for CPU tensors), an
    out-of-place ladder between `planar` and one scratch buffer, every other
    single gate in place through apply_gate_planes_.  Returns the buffer
    that holds the result: `planar`, or the scratch buffer after an odd
    number of ladders.  A run of adjacent cycle walks and out-of-place
    ladders (strip_run) goes through one in-place strip pass where that
    beats the entries one by one (oracle.strip_pays); a ladder merged so
    needs no scratch buffer.  With a `norms` list, the norm after each entry
    of the plan (segment or single gate) is appended to it, and with
    nan_checks check_finite runs after each entry: then every entry runs on
    its own, walks and ladders included."""
    if plan is None:
        plan = plan_circuit(circuit, M, sv.num_qubits(planar), planar.dtype, planar.device)
    cur, spare = planar, None
    i = 0
    while i < len(plan):
        seg = plan[i]
        run = [] if norms is not None or nan_checks else strip_run(cur, plan, i)
        if run and oracle.strip_pays([g.qubits for g in run], run[0].meta[0], cur.element_size(),
                                     oracle.strip_room(cur.device), sv.num_qubits(cur)):
            C, m_reg, _ = _oracle_terms(run[0])
            A_list = [A for g in run for A in _oracle_terms(g)[2]]
            controls = [c for g in run for c in g.qubits]
            with profiling.span("oracle.gate", cur.device, gates=len(controls), entries=len(run)) as rec:
                oracle.apply_camodc_run_inplace_planar(cur, C, A_list, controls, m_reg)
                _count_pass(rec, cur, C, A_list, m_reg, True)
            i += len(run)
            continue
        with _entry_span(seg, cur.device) as rec:
            if seg[0] == "fused":
                fused.apply_fused(cur, seg[1], seg[2], M)
                if rec is not None and rec.name == "fused.segment":
                    rec.counts["groups"] = fused.matrix_groups(seg[1], M, cur.dtype, sv.num_qubits(cur))
            elif seg[1].name == "camodc_ladder_high" and not _pair_in_place(cur, seg[1]):
                if spare is None:
                    spare = torch.empty_like(cur)
                C, m_reg, A_list = _oracle_terms(seg[1])
                oracle.apply_camodc_ladder_high_planar(cur, spare, C, A_list, seg[1].qubits, m_reg)
                _count_pass(rec, cur, C, A_list, m_reg, False)
                cur, spare = spare, cur
            else:
                g = seg[1]
                apply_gate_planes_(cur, g, M)
                if g.name in ("camodc_high", "camodc_ladder_high"):  # a walk or an in-place pair
                    C, m_reg, A_list = _oracle_terms(g)
                    _count_pass(rec, cur, C, A_list, m_reg, True)
        if norms is not None:
            norms.append(sv.norm(cur))
        if nan_checks:
            g = seg[1]
            check_finite(cur, f"fused segment {i} ({len(g)} ops)" if seg[0] == "fused" else f"gate {g.name}{g.qubits}")
        i += 1
    return cur


def _oracle_terms(g: Gate) -> tuple:
    """(C, work register, multipliers) of an m_high oracle entry: a single
    camodc_high gate (meta C, A, M) or a ladder (meta C, M, A1..AK)."""
    if g.name == "camodc_high":
        return g.meta[0], g.meta[2], g.meta[1:2]
    return g.meta[0], g.meta[1], g.meta[2:]


_ORACLE_GATES = ("camodc", "camodc_high", "camodc_ladder_high")


def _count_pass(rec, planar: torch.Tensor, C: int, A_list, m_reg: int, in_place: bool) -> None:
    """Give a recording m_high `oracle.gate` span (`rec`; None when spans
    are off) the bytes its pass reads and writes (oracle.pass_bytes) and
    whether it ran in place (1) or out of place (0, the ladder)."""
    if rec is not None:
        n = sv.num_qubits(planar)
        A = tuple(int(a) % C for a in A_list)
        rec.counts.update(bytes=oracle.pass_bytes(C, A, n, m_reg, planar.element_size(), in_place),
                          inplace=int(in_place))


def _entry_span(seg, device):
    """The span of one plan entry: ``oracle.gate`` (counting the oracle
    gates it applies) for an oracle gate or a segment of camodc ops alone
    (the Beneš permutation), ``fused.segment`` for any other segment (its
    caller counts the matrix-group ops it ran, ``groups``), none for any
    other single gate."""
    if seg[0] == "fused":
        ops = seg[1]
        if ops and all(op[0] == "camodc" for op in ops):
            return profiling.span("oracle.gate", device, gates=len(ops))
        return profiling.span("fused.segment", device)
    if seg[1].name in _ORACLE_GATES:
        return profiling.span("oracle.gate", device, gates=len(seg[1].qubits))
    return contextlib.nullcontext()


def _strip_entry(planar: torch.Tensor, entry) -> bool:
    """True when a plan entry is one the strip pass may take, on planes
    the strip kernel takes (oracle._STRIP_DTYPES, strip_run_supported): a
    single camodc_high gate that apply_gate_planes_ would send to the cycle
    walk, or a ladder that runs out of place."""
    if entry[0] == "fused" or planar.dtype not in oracle._STRIP_DTYPES:
        return False
    g = entry[1]
    n, itemsize = sv.num_qubits(planar), planar.element_size()
    if g.name == "camodc_high":
        if oracle.perm_supported(g.qubits[0], g.meta[2], n, itemsize):
            return False
    elif g.name != "camodc_ladder_high" or _pair_in_place(planar, g):
        return False
    m_reg = _oracle_terms(g)[1]
    return oracle.strip_run_supported(m_reg, n, itemsize, oracle.planes_aligned(planar), oracle.strip_room(planar.device))


def strip_run(planar: torch.Tensor, plan, i: int) -> list:
    """The gates of the maximal run of adjacent plan entries from plan[i]
    that one strip pass applies (oracle.apply_camodc_run_inplace_planar):
    cycle walks and out-of-place ladders (_strip_entry) on one C and work
    register, with distinct controls; at n = 28 the complex64 m_high plan's
    eleven walks and its ladder.  The plan stays the JAX package's; runs
    merge at launch."""
    run: list = []
    controls: set = set()
    for entry in plan[i:]:
        if not _strip_entry(planar, entry):
            break
        g = entry[1]
        if run and (_oracle_terms(g)[:2] != _oracle_terms(run[0])[:2] or controls & set(g.qubits)):
            break
        run.append(g)
        controls |= set(g.qubits)
    return run


def is_complex32(dtype) -> bool:
    """True for the bf16-storage dtype token ("complex32" / "c32")."""
    return isinstance(dtype, str) and dtype in (sv.COMPLEX32, "c32")


def resolve_backend(backend: str) -> str:
    if backend == "auto":
        return "cuda" if torch.cuda.is_available() else "torch"
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r} (auto, torch or cuda)")
    return backend


class _AdjointRun(torch.autograd.Function):
    """engine.run as a differentiable function of its input planes (the JAX
    engine's custom_vjp).  The forward runs the circuit on a copy of the
    input, the backward runs dagger_circuit on a copy of the cotangent, both
    through the engine's own path (plan, kernels, ladder ping-pong): a
    unitary's real-linear transpose on the planes is its adjoint, so nothing
    is saved and no kernel needs a derivative rule.  The gradient has the
    planes' dtype, bf16 included."""

    @staticmethod
    def forward(ctx, planar: torch.Tensor, engine: "StateVectorEngine", circuit: Circuit) -> torch.Tensor:
        ctx.engine, ctx.circuit = engine, circuit
        return engine._run(circuit, planar.detach().clone(), None)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        engine = ctx.engine
        adjoint = dagger_circuit(engine._prep(ctx.circuit), engine.m_eff)
        with profiling.span("engine.adjoint", engine.device, gates=len(adjoint)):
            grad = engine._run(adjoint, ct.clone(memory_format=torch.contiguous_format), None)
        return grad, None, None


class StateVectorEngine:
    """Executes circuits on a (2, 2^n) planar state resident on `device`.

    States are planar real tensors (plane 0 = Re, plane 1 = Im); float32
    planes for complex64, float64 for complex128, bfloat16 for "complex32"
    (cuda backend only; backend="auto" picks it, on the CPU when no CUDA
    device is present).  `fuse` (cuda backend):
    plan the circuit into fused segments and oracle ladders (True), or run
    it gate by gate, each gate through its kernel (False).  `oracle`:
    "gather", or "benes" for the standard layout's oracles inside the fused
    segments (cuda backend with fuse=True; the gather elsewhere).
    `strict_reference` needs the torch backend (which backend="auto" then
    resolves to) and the standard layout, and with no `device` runs on the
    CUDA device when one is present; `nan_checks` as in the module
    docstring."""

    def __init__(
        self,
        register: Register,
        dtype=torch.complex64,
        backend: str = "auto",
        device=None,
        layout: str = "standard",
        fuse: bool = True,
        oracle: str = "gather",
        nan_checks: bool = False,
        strict_reference: bool = False,
    ):
        if layout not in ("standard", "m_high"):
            raise ValueError(f"unknown layout {layout!r}")
        c32_off_card = False
        if is_complex32(dtype):
            # bf16 storage: no complex dtype exists at this width, so it runs
            # only on the planar kernel path (the JAX engine's pallas rule).
            # "auto" places it as it places complex64: on the card when there
            # is one, else on the CPU, where every kernel wrapper takes its
            # plain version (the JAX package's interpret mode off the TPU).
            if backend == "torch" or strict_reference:
                raise ValueError("dtype='complex32' requires backend='cuda' or 'auto'")
            c32_off_card = backend == "auto" and resolve_backend("auto") == "torch"
            backend = "cuda"
        self.backend = resolve_backend("torch" if strict_reference and backend == "auto" else backend)
        if strict_reference and (self.backend != "torch" or layout != "standard"):
            # Reference bug-compatibility (qc_shor.c:340-351, 654): the
            # modular multiplies run the warn-and-wrap scatter even when
            # 2^M < C; small exact comparison runs on the plain ops.
            raise ValueError("strict_reference mode requires backend='torch' and the standard layout")
        if oracle not in ("gather", "benes"):
            raise ValueError(f"unknown oracle backend {oracle!r}")
        self.oracle = oracle
        self.nan_checks = nan_checks
        self.strict_reference = strict_reference
        if device is None:
            # strict_reference picks the plain ops, not the host: like the
            # JAX package's forced xla, it runs on the card when there is one.
            on_card = (self.backend == "cuda" and not c32_off_card) or (strict_reference and torch.cuda.is_available())
            device = "cuda" if on_card else "cpu"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise ValueError("no CUDA device is available")
        if self.backend == "cuda" and self.device.type != "cuda" and not c32_off_card:
            raise ValueError(f"backend='cuda' runs on a CUDA device, not {self.device}")
        self.register = register
        self.real_dtype = sv.real_dtype_of(dtype)
        self.dtype = {torch.float32: torch.complex64, torch.float64: torch.complex128}.get(self.real_dtype, sv.COMPLEX32)
        self.layout = layout
        self.fuse = fuse
        # In the m_high layout the counting register is the low physical
        # bits, so the iQFT ladder boundary is physical bit 0 and the reset
        # |0..01> (work register = 1) is physical index 2^L.
        self.m_eff = 0 if layout == "m_high" else register.M
        self.reset_index = (1 << register.L) if layout == "m_high" else 1
        if not state_fits(register.n, self.real_dtype, self.device):
            raise ValueError(
                f"a 2^{register.n} state of {self.dtype} does not fit the "
                f"{device_memory_budget(self.device)} usable bytes of {self.device}"
            )
        self._plans: "OrderedDict[Circuit, list]" = OrderedDict()

    # -- state lifecycle ----------------------------------------------------

    def initial_state(self) -> torch.Tensor:
        """|00...01> (qc_shor.c:318-324), planar (layout-aware)."""
        return sv.initial_planar(self.register.n, self.real_dtype, self.reset_index, self.device)

    def zero_state(self) -> torch.Tensor:
        return sv.zero_planar(self.register.n, self.real_dtype, self.device)

    def logical_index(self, phys: int) -> int:
        """Map a measured physical basis index back to the logical
        (reference bit-convention) index."""
        if self.layout == "standard":
            return phys
        L, M = self.register.L, self.register.M
        return (phys >> L) | ((phys & ((1 << L) - 1)) << M)

    # -- execution ----------------------------------------------------------

    def _plan(self, circuit: Circuit):
        """The circuit's plan, from a cache of the PLAN_CACHE circuits used
        last (a variational loop plans new angles every step)."""
        plan = self._plans.get(circuit)
        if plan is None:
            with profiling.span("engine.plan", self.device):
                plan = plan_circuit(
                    circuit, self.m_eff, self.register.n, self.real_dtype, self.device, self.oracle == "benes"
                )
            self._plans[circuit] = plan
            if len(self._plans) > PLAN_CACHE:
                self._plans.popitem(last=False)
        else:
            self._plans.move_to_end(circuit)
        return plan

    def _prep(self, circuit: Circuit) -> Circuit:
        """The JAX engine's rewrite: in strict_reference mode every modular
        multiply becomes its warn-and-wrap scatter twin."""
        if not self.strict_reference:
            return circuit
        return tuple(
            Gate("camodc_strict", g.qubits, g.params, g.meta) if g.name == "camodc" else g for g in circuit
        )

    def _run(self, circuit: Circuit, state: Optional[torch.Tensor], norms: Optional[list]) -> torch.Tensor:
        with profiling.span("engine.run", self.device):
            fresh = state is None
            if fresh:
                with profiling.span("engine.reset", self.device):
                    state = self.initial_state()
            circuit, checks = self._prep(circuit), self.nan_checks
            if self.backend == "torch":
                return apply_circuit_plain_(state, circuit, self.m_eff, norms, checks)
            if not self.fuse:
                return apply_circuit_per_gate_(state, circuit, self.m_eff, norms, checks)
            out = apply_circuit_fused_(state, circuit, self.m_eff, self._plan(circuit), norms, nan_checks=checks)
            if out is not state and not fresh:
                state.copy_(out)
                return state
            return out

    def run(self, circuit: Circuit, state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply a circuit and return the planar state.  With no input state
        the run starts from the |0..01> reset.  A caller-supplied `state` is
        CONSUMED: it is updated in place (the counterpart of the JAX
        engine's buffer donation) and returned.

        Differentiable, as the JAX engine's run is: when grad mode is on and
        `state` requires grad, the run leaves `state` alone and returns a new
        tensor whose backward applies the dagger circuit to the cotangent
        through the same path (_AdjointRun).  strict_reference gates are not
        unitary, so that engine differentiates through its plain ops with
        autograd instead, as the JAX engine differentiates through XLA."""
        if state is not None and state.requires_grad and torch.is_grad_enabled():
            if self.strict_reference:
                z = circuit_plain(sv.to_complex(state), self._prep(circuit), self.m_eff, nan_checks=self.nan_checks)
                return sv.from_complex(z)
            return _AdjointRun.apply(state, self, circuit)
        return self._run(circuit, state, None)

    def run_with_norms(self, circuit: Circuit, state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """run(), also returning the norm trace (Report §IV.A / FIG. 2) on
        the execution path itself: one norm per fused segment and per single
        gate of the plan with fusion on the cuda backend, one per gate
        otherwise.  Each norm is sum re^2 + im^2 in the compute dtype
        (float32 for bf16 planes); they stay on the device until the run
        ends and come back as one 1-d CPU tensor.  CONSUMES a caller-supplied `state`, like run()."""
        norms: list = []
        out = self._run(circuit, state, norms)
        return out, (torch.stack(norms).cpu() if norms else torch.zeros(0, dtype=sv.compute_dtype(self.real_dtype)))

    def run_norm(self, circuit: Circuit) -> float:
        """Reset -> circuit -> norm (probability conservation check)."""
        return self.norm(self.run(circuit))

    def run_and_measure_index(self, circuit: Circuit, r: float) -> int:
        """Reset -> circuit -> inverse-CDF measured index for draw r."""
        return self._sample(self.run(circuit), r)

    def run_and_measure(self, circuit: Circuit, r: float) -> Tuple[int, torch.Tensor]:
        """Reset -> circuit -> (measured index, collapsed planar state)."""
        return self.measure(self.run(circuit), r)

    # -- measurement ----------------------------------------------------------

    def _sample(self, planar: torch.Tensor, r: float) -> int:
        with profiling.span("measure.sample", planar.device) as rec:
            if rec is not None:
                blocks, block = measure.sample_geometry(planar)
                rec.counts.update(blocks=blocks, block=block)
            return measure.sample_index(planar, r, plain=self.backend == "torch")

    def measure(self, state: torch.Tensor, r: float) -> Tuple[int, torch.Tensor]:
        """Inverse-CDF measurement with draw r, then collapse
        (qc_shor.c:272-306).  CONSUMES `state`: it is overwritten in place
        with the collapsed basis state, which is returned."""
        idx = self._sample(state, r)
        state.zero_()
        state[0, idx] = 1.0
        return idx, state

    def sample(self, state: torch.Tensor, rs) -> torch.Tensor:
        """One basis index per draw in `rs`, without collapsing the state, as
        an int64 CPU tensor: one pass over the state for all draws (one
        block-sum launch, or one flat cumulative sum), each index the one
        measure() would take for the same draw."""
        return measure.sample_indices(state, rs, plain=self.backend == "torch")

    def draws(self, shape, seed: int) -> torch.Tensor:
        """Uniform draws in [0, 1) of `shape` from a CPU torch.Generator
        seeded with `seed`, in the compute dtype (float32 for complex64 and
        complex32, float64 for complex128): the draws an algorithm makes
        when its caller passes none."""
        gen = torch.Generator().manual_seed(int(seed))
        return torch.rand(shape, generator=gen, dtype=sv.compute_dtype(self.real_dtype))

    def probabilities(self, state: torch.Tensor) -> torch.Tensor:
        return sv.probabilities(state)

    def norm(self, state: torch.Tensor) -> float:
        return float(sv.norm(state))

    def to_numpy(self, state: torch.Tensor) -> np.ndarray:
        """Host-side complex copy of a planar state (for inspection/tests)."""
        return sv.to_numpy_complex(state)
