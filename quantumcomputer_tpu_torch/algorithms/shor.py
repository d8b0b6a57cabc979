"""Shor's algorithm: classical orchestration around the quantum core.

The counterpart of the JAX package's ``algorithms/shor.py`` for the
full-register circuit in the standard layout: the same attempt loop, the
same validity ladder and the same ``-v`` / ``-V`` print lines.

Randomness is injected.  Each attempt's measurement draw is one uniform in
[0, 1): ``shors_algorithm(seed=...)`` takes it from a ``torch.Generator``
seeded with ``seed``, and ``find_period(..., r=...)`` accepts it directly, so
a test can feed one numpy draw to both packages.

Eager PyTorch compiles nothing per circuit, so ``find_period`` always runs
the static circuit; the JAX package's slot-template form exists only to
save XLA recompiles and is not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional, Tuple

import torch

from quantumcomputer_tpu_torch.algorithms import number_theory as nt
from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit
from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
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
) -> AttemptRecord:
    """One quantum period-finding attempt (find_period, qc_shor.c:912-964):
    reset -> circuit -> measure with draw r -> omega -> continued fractions
    -> period test.

    With -V the three circuit phases run one after another on the same
    state (updated in place, so one state buffer serves the whole attempt),
    each followed by a norm read that waits for the device, so the progress
    lines reflect real execution."""
    reg = engine.register
    circuit = shor_circuit(C, a, reg.L, reg.M)
    _, very_verbose = verbosity()
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
    else:
        idx = engine.run_and_measure_index(circuit, r)
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
    num_fractions: int = nt.NUM_CONTINUED_FRACTIONS,
    trials_per_denominator: int = nt.TRIALS_PER_DENOMINATOR,
) -> ShorResult:
    """Full Shor algorithm (qc_shor.c:1003-1134).

    forced_trial_int != 0 -> that a only; otherwise loop a = 2 .. C-2 until
    non-trivial factors emerge.  Each attempt's draw comes from a CPU
    ``torch.Generator`` seeded with `seed` (wall clock when None), so the
    draws do not depend on the engine's device."""
    if C < 4 or L < 1 or M < 1:
        return ShorResult(outcome=Outcome.BAD_ARGUMENTS, C=C)
    if engine is None:
        engine = StateVectorEngine(Register(L=L, M=M), dtype=dtype, backend=backend)
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
            r = float(torch.rand((), generator=gen, dtype=torch.float64))
            t_attempt = time.perf_counter()
            attempt = find_period(engine, C, a, r, num_fractions, trials_per_denominator)
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
