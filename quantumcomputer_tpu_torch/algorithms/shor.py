"""Shor's algorithm: classical orchestration around the quantum core.

The counterpart of the JAX package's ``algorithms/shor.py`` for the
full-register circuit in the standard and m_high layouts: the same attempt
loop, the same validity ladder and the same ``-v`` / ``-V`` print lines.

Randomness is injected.  Each attempt's measurement draw is one uniform in
[0, 1): ``shors_algorithm(seed=...)`` takes it from a ``torch.Generator``
seeded with ``seed``, and ``find_period(..., r=...)`` accepts it directly, so
a test can feed one numpy draw to both packages.  A semiclassical attempt
(``semiclassical=True``, ``algorithms/semiclassical.py``) takes L uniforms,
in the compute dtype, from the same generator.

Eager PyTorch compiles nothing per circuit, so ``find_period`` always runs
the static circuit; the JAX package's slot-template form exists only to
save XLA recompiles and is not ported.  ``shors_algorithm(mesh=...)`` runs
the circuit on the sharded engine (``parallel/sharded.py``), or shards the
semiclassical work register.
"""

from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional, Tuple

import torch

from quantumcomputer_tpu_torch.algorithms import number_theory as nt
from quantumcomputer_tpu_torch.algorithms.semiclassical import find_period_semiclassical
from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
from quantumcomputer_tpu_torch.sim.checkpoint import run_with_checkpoints
from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine, is_complex32, resolve_backend
from quantumcomputer_tpu_torch.utils import profiling
from quantumcomputer_tpu_torch.utils.logging import get_logger, ui_active, verbosity

log = get_logger("shor")


class Outcome(Enum):
    OK = "ok"
    PERIOD_NOT_FOUND = "period_not_found"
    TRIVIAL_FACTORS = "trivial_factors"
    BAD_ARGUMENTS = "bad_arguments"


@dataclass
class AttemptRecord:
    """One period-finding attempt: measured index, omega, candidate period."""

    a: int
    measured_index: int
    omega: float
    period: Optional[int]
    valid: bool
    reason: str = ""
    elapsed_s: float = 0.0
    semiclassical: Optional[object] = None  # the SemiclassicalRecord of a semiclassical attempt


@dataclass
class ShorResult:
    outcome: Outcome
    C: int
    factors: Optional[Tuple[int, int]] = None
    period: Optional[int] = None
    a: Optional[int] = None
    attempts: List[AttemptRecord] = field(default_factory=list)
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.outcome is Outcome.OK


def read_omega(state_num: int, L: int, M: int) -> float:
    """Bit-reversed L-register readout: omega = x_tilde / 2^L
    (qc_shor.c:868-883)."""
    x_tilde = 0
    power = 0
    for i in range(L + M - 1, M - 1, -1):
        x_tilde += ((state_num >> i) & 1) << power
        power += 1
    return x_tilde / float(1 << L)


def issue_warnings(C: int, L: int, M: int) -> List[str]:
    """Register-size confidence warnings (qc_shor.c:340-351)."""
    warnings = []
    if (1 << M) < C:
        warnings.append(
            f"M register too small for reliable results: ensure 2^M >= C (minimum M = {nt.min_M_for(C)})"
        )
    if (1 << L) < C * C:
        warnings.append(
            f"L register too small for full period confidence: ensure 2^L >= C^2 (suggested L = {nt.recommended_L_for(C)})"
        )
    if C > 2 and C % 2 == 0:
        warnings.append(f"C = {C} is even: factor 2 directly; Shor needs an odd composite")
    elif C < (1 << 20) and nt.is_prime(C):
        warnings.append(f"C = {C} is prime: no nontrivial factors exist")
    return warnings


def find_period(
    engine: StateVectorEngine,
    C: int,
    a: int,
    r: float,
    num_fractions: int = nt.NUM_CONTINUED_FRACTIONS,
    trials_per_denominator: int = nt.TRIALS_PER_DENOMINATOR,
    checkpoint_dir: Optional[str] = None,
    checkpoint_segment_gates: int = 8,
) -> AttemptRecord:
    """One quantum period-finding attempt (find_period, qc_shor.c:912-964):
    reset -> circuit -> measure with draw r -> omega -> continued fractions
    -> period test.

    With -V the three circuit phases run one after another on the same
    state (updated in place, so one state buffer serves the whole attempt),
    each followed by a norm read that waits for the device, so the progress
    lines reflect real execution.  Both layouts' circuits are
    [H layer | L oracles | iQFT], L gates each; an m_high engine's measured
    index is mapped back to the logical index before it is read.

    checkpoint_dir: the circuit runs in segments of
    `checkpoint_segment_gates` gates with a snapshot after each
    (sim/checkpoint.run_with_checkpoints), in a subdirectory per (C, a),
    ``C{C}_a{a}``; a killed attempt resumes from its last valid snapshot
    when called again.  The measurement always runs fresh, never from a
    snapshot, and the subdirectory is removed once the attempt completes.
    Checkpointing wins over -V's per-phase progress."""
    # A sharded engine holds no single device: its attempt span takes no device time.
    with profiling.span("driver.attempt", getattr(engine, "device", None)):
        reg = engine.register
        build = shor_circuit_mhigh if engine.layout == "m_high" else shor_circuit
        circuit = build(C, a, reg.L, reg.M)
        _, very_verbose = verbosity()
        if very_verbose and checkpoint_dir is not None:
            print("      - (checkpointing enabled: per-phase -V progress is replaced by per-segment snapshots)")
            very_verbose = False
        if very_verbose:
            print("      - Performing quantum computation...")
            L = reg.L
            phases = (
                ("         - Applying Hadamard matrices.", circuit[:L]),
                ("         - Applying a^x mod (C) gates.", circuit[L : 2 * L]),
                ("         - Performing inverse quantum Fourier transform.", circuit[2 * L :]),
            )
            state = None
            for banner, phase in phases:
                print(banner)
                state = engine.run(tuple(phase), state)
                engine.norm(state)
            print("      - Measuring state...")
            idx, _ = engine.measure(state, r)
        elif checkpoint_dir is not None:
            attempt_dir = os.path.join(checkpoint_dir, f"C{C}_a{a}")
            state = run_with_checkpoints(engine, circuit, attempt_dir, segment_gates=checkpoint_segment_gates)
            idx, _ = engine.measure(state, r)  # fresh measurement, never replayed
            shutil.rmtree(attempt_dir, ignore_errors=True)  # attempt complete
        else:
            idx = engine.run_and_measure_index(circuit, r)
        with profiling.span("driver.period"):
            idx = engine.logical_index(idx)
            omega = read_omega(idx, reg.L, reg.M)
            if very_verbose:
                print("      - Using continued fractions to guess period...")
            period = nt.find_period_from_omega(omega, a, C, num_fractions, trials_per_denominator)
            log.debug("a=%d measured index=%d omega=%.6f period=%s", a, idx, omega, period)
            return AttemptRecord(a=a, measured_index=idx, omega=omega, period=period, valid=period is not None)


def _validate_and_factor(C: int, a: int, period: int) -> Tuple[bool, str, Optional[Tuple[int, int]]]:
    """Validity ladder (qc_shor.c:1030-1050): period even, a^(p/2) != -1 mod C;
    then factors = gcd(a^(p/2) +- 1, C), rejecting trivial ones."""
    if period % 2 != 0:
        return False, "period is odd", None
    half = nt.modpow(a, period // 2, C)
    if half == C - 1:
        return False, "a^(p/2) == -1 (mod C)", None
    f0 = nt.gcd(half + 1, C)
    f1 = nt.gcd(half - 1, C)
    if f0 == 1 or f1 == 1 or f0 == C or f1 == C:
        return False, "trivial factors", None
    return True, "", (max(f0, f1), min(f0, f1))


def shors_algorithm(
    C: int,
    L: int,
    M: int,
    forced_trial_int: int = 0,
    seed: Optional[int] = None,
    dtype=torch.complex64,
    backend: str = "auto",
    max_attempts_per_a: int = 1,
    engine: Optional[StateVectorEngine] = None,
    mesh=None,
    num_fractions: int = nt.NUM_CONTINUED_FRACTIONS,
    trials_per_denominator: int = nt.TRIALS_PER_DENOMINATOR,
    layout: str = "standard",
    oracle: str = "gather",
    strict_reference: bool = False,
    semiclassical: bool = False,
    checkpoint_dir: Optional[str] = None,
) -> ShorResult:
    """Full Shor algorithm (qc_shor.c:1003-1134).

    forced_trial_int != 0 -> that a only; otherwise loop a = 2 .. C-2 until
    non-trivial factors emerge.  Each attempt's draw comes from a CPU
    ``torch.Generator`` seeded with `seed` (wall clock when None), so the
    draws do not depend on the engine's device.

    dtype="dd64", the JAX package's double-float parity mode, runs
    complex128, which the card has natively.  dtype="complex32" (bf16
    planes, float32 draws) runs the full-register engine on the kernel path
    only: backend="torch" is overridden to "auto", as the JAX package
    overrides xla with pallas, and the engine runs on the card when there is
    one, else on the CPU through the kernels' plain versions (an explicit
    backend="cuda" with no CUDA device raises the engine's error).  oracle="benes" runs the
    oracles inside the fused segments on the cuda backend (complex32 on the
    CPU included); on the torch backend it logs the JAX package's warning
    and runs the gather.
    strict_reference=True builds a StateVectorEngine(strict_reference=True),
    on the CUDA device when one is present (and refuses an engine built
    without it).

    semiclassical=True runs each attempt on the one-control-qubit engine
    (``algorithms/semiclassical.py``): a 2^M state instead of 2^(L+M), the
    same outcome distribution, on the CUDA device when the backend is
    ``cuda`` and on the CPU otherwise.  Its dtype may also be given as the
    strings "complex64" and "complex128", which the JAX package's
    semiclassical mode refuses (it takes only "complex32", "c32" and
    "dd64" as strings, though its message names all four): a departure
    kept on purpose.

    checkpoint_dir: snapshots for preemption recovery, per segment of the
    full-register circuit (find_period) or every few semiclassical steps
    (run_semiclassical); a killed run called again with the same arguments
    and seed resumes where it stopped.

    mesh (parallel/mesh.build_mesh): the state is sharded over it, on the
    ShardedStateVectorEngine (dd64 as complex128; oracle="benes" logs the
    JAX package's warning and runs the gather oracle; strict_reference
    raises), or with semiclassical=True the work register is sharded
    (parallel/sharded_semiclassical.py; not at dd64)."""
    if C < 4 or L < 1 or M < 1:
        return ShorResult(outcome=Outcome.BAD_ARGUMENTS, C=C)
    dd64 = dtype == "dd64"
    if dd64:
        if layout != "standard":
            raise ValueError("dd64 parity mode uses the standard layout")
        dtype = torch.complex128
    if semiclassical:
        if engine is not None or layout != "standard" or strict_reference:
            raise ValueError("semiclassical mode is its own engine: no layout/strict_reference/engine arguments")
        if oracle != "gather":
            log.warning(
                "semiclassical mode ignores oracle=%r (its oracle is the blockwise on-device index generation)", oracle
            )
        if dd64 and mesh is not None:
            raise ValueError("dd64 semiclassical is single-chip (parity mode); use complex32/complex64 on a mesh")
        device = "cuda" if resolve_backend(backend) == "cuda" else "cpu"
        # The draws in the engine's compute dtype (dd64 is complex128 by now).
        draw_dtype = torch.float64 if dtype in (torch.complex128, "complex128") else torch.float32
    elif engine is not None:
        if strict_reference and not getattr(engine, "strict_reference", False):
            # A caller-supplied engine carries its own oracle semantics.
            raise ValueError(
                "strict_reference=True conflicts with the provided engine "
                "(construct it with StateVectorEngine(strict_reference=True))"
            )
    else:
        if strict_reference and backend == "auto":
            backend = "torch"
        if is_complex32(dtype) and backend == "torch":
            log.warning(
                "complex32 requires the planar kernel path (no 32-bit complex dtype exists); "
                "overriding backend='torch' -> 'auto' (the card when there is one, else the "
                "kernels' plain versions on the CPU)"
            )
            backend = "auto"
        if oracle == "benes" and (mesh is not None or (not is_complex32(dtype) and resolve_backend(backend) == "torch")):
            log.warning(
                "oracle='benes' requires the single-chip cuda backend; "
                "falling back to the gather oracle (mesh=%s, backend=%s)",
                "set" if mesh is not None else "none", resolve_backend(backend),
            )
            oracle = "gather"
        if mesh is not None:
            if strict_reference:
                raise ValueError("strict_reference mode is single-chip (no mesh support)")
            from quantumcomputer_tpu_torch.parallel.sharded import ShardedStateVectorEngine

            engine = ShardedStateVectorEngine(Register(L=L, M=M), dtype=dtype, mesh=mesh, backend=backend, layout=layout)
        else:
            engine = StateVectorEngine(
                Register(L=L, M=M), dtype=dtype, backend=backend, layout=layout,
                oracle=oracle, strict_reference=strict_reference,
            )
    if seed is None:
        seed = int(time.time_ns() % (1 << 31))
    gen = torch.Generator().manual_seed(seed)

    start = time.perf_counter()
    result = ShorResult(outcome=Outcome.PERIOD_NOT_FOUND, C=C)

    forced = bool(forced_trial_int)
    verbose, _ = verbosity()
    # Reference -v attempt surface (qc_shor.c:1019-1063, 1072-1120): the
    # trailing blank line is loop-path only, like the reference's "\n\n"s.
    tail = "" if forced else "\n"
    trial_ints = [forced_trial_int] if forced else list(range(2, C - 1))
    for a in trial_ints:
        if verbose:
            kind = "Forced trial integer" if forced else "Trial integer"
            print(f" --- {kind} a = {a}, finding period ...")
        g = nt.gcd(a, C)
        if g not in (1, C):
            # a shares a factor with C: the factorization is classical, and
            # the modular-multiply gate would not be unitary.
            log.info("gcd(%d, %d) = %d > 1: classical factor found", a, C, g)
            result.outcome = Outcome.OK
            result.factors = (max(g, C // g), min(g, C // g))
            result.a = a
            break
        found = False
        for _ in range(max_attempts_per_a):
            if semiclassical:
                rs = torch.rand((L,), generator=gen, dtype=draw_dtype)
                t_attempt = time.perf_counter()
                period, screc = find_period_semiclassical(
                    C, a, L, M, rs, dtype=dtype, num_fractions=num_fractions,
                    trials_per_denominator=trials_per_denominator, device=device,
                    mesh=mesh, checkpoint_dir=checkpoint_dir,
                )
                # measured_index records x~, the sequential bit readout: this
                # mode has no full-register basis index.
                attempt = AttemptRecord(
                    a=a, measured_index=screc.x_tilde, omega=screc.omega, period=period,
                    valid=period is not None, semiclassical=screc,
                )
            else:
                r = float(torch.rand((), generator=gen, dtype=torch.float64))
                t_attempt = time.perf_counter()
                attempt = find_period(
                    engine, C, a, r, num_fractions, trials_per_denominator, checkpoint_dir=checkpoint_dir
                )
            attempt.elapsed_s = time.perf_counter() - t_attempt
            log.info("attempt a=%d took %.6fs", a, attempt.elapsed_s)
            result.attempts.append(attempt)
            if attempt.period is None:
                if verbose and not forced:
                    print(f" --- A valid period could not be found for a = {a}.{tail}")
                log.debug("a=%d: no valid period from omega=%.4f", a, attempt.omega)
                continue
            ok, reason, factors = _validate_and_factor(C, a, attempt.period)
            attempt.valid = ok
            attempt.reason = reason
            if not ok:
                if reason == "trivial factors":
                    result.outcome = Outcome.TRIVIAL_FACTORS
                    if ui_active():
                        if forced:
                            print(" --- The factors found are trivial, consider trying a different trial integer.")
                        else:
                            print(" --- Factors found are trivial. Continuing to find non-trivial factors.")
                elif verbose:
                    print(f" --- Period was found to be {attempt.period}, but it did not pass the validity requirements.{tail}")
                log.debug("a=%d: period %d rejected (%s)", a, attempt.period, reason)
                continue
            if verbose:
                print(
                    f" --- A valid period = {attempt.period} has been found so the factors of "
                    f"C = {C} have been found quantum mechanically.\n"
                )
            result.outcome = Outcome.OK
            result.factors = factors
            result.period = attempt.period
            result.a = a
            found = True
            break
        if found:
            break

    result.elapsed_s = time.perf_counter() - start
    return result
