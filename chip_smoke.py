#!/usr/bin/env python3
"""Smoke run of quantumcomputer_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py      # from the root of a checkout; needs one CUDA card and nvcc

Phases, each of which must pass:
  1. print the card's name and power limit; build the CUDA kernels from
     quantumcomputer_tpu_torch/ops/csrc (one nvcc per source, sm_90a) and
     print the build time;
  2. hold each kernel against its plain PyTorch version on the card: every
     fused-segment op kind on seeded n = 20 states in float32 (max abs <= 3e-5)
     and float64 (<= 1e-12), the block sums in float32 (<= 1e-6), and the
     three m_high oracle kernels (ladder, cycle, cycle_masked) in float32 and
     float64 at the shapes their call sites take, exactly (max abs == 0:
     they only move data);
  3. factor 15 through the CLI (-C 15 -L 3 -M 4 -a 7), through the fused
     kernel, then again with --layout m_high, through the cycle kernel;
  4. the flagship circuit shor_circuit(8191, 3, 15, 13) at n = 28 (a 2 GiB
     complex64 state) with backend="cuda": norm within 1e-4 of 1, final state
     within ||d||_2 <= 1e-4 of the backend="torch" run on the same card, both
     wall times; each fused segment of its plan and the block sums are held
     against their plain versions at that size and timed beside them.  Then
     the same circuit in the m_high layout (shor_circuit_mhigh): norm, the
     torch backend's m_high state and the standard-layout state mapped
     physical -> logical, each within ||d||_2 <= 1e-4; once more with the
     memory budget forced below two states, where it must pair oracles in
     place (cycle_masked) and launch no ladder; each fused segment of the
     m_high plan and each oracle kernel held against its plain version at
     n = 28, the oracle kernels timed beside theirs;
  5. the main paths: factor 8187 = 2729 x 3 end to end at n = 30 with
     shors_algorithm(backend="cuda"), in the standard layout and then in the
     m_high layout; every kernel's launch counter is reset just before each
     and read just after, and each kernel of that path must have launched.

Prints a JSON kernel report and, last, {"ok": true, "device": {...}}.  Any
failure exits non-zero without that line.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

DEVICE = "cuda"
KERNEL_BACKEND = "cuda"
KERNEL_N = 20
FLAGSHIP = (8191, 3, 15, 13)  # C, a, L, M: n = 28
FACTOR = (8187, 13, 17, 13)  # C, a, L, M: n = 30
TOL = {"float32": 3e-5, "float64": 1e-12}
# (kernel, call site, controls, n, M): each case sized so that its call
# site's eligibility predicate holds, as in the JAX package's dispatch.
ORACLE_CASES = [
    ("cycle", "cycle", (0,), 20, 6),
    ("cycle", "cycle", (3,), 20, 6),
    ("cycle", "cycle", (9,), 20, 6),
    ("cycle", "cycle", (13,), 20, 6),
    ("cycle", "cycle", (3,), 20, 13),
    ("cycle_masked", "perm", (13,), 20, 6),
    ("cycle_masked", "pair", (13, 14), 21, 6),
    ("ladder", "ladder", (11, 12), 21, 6),
    ("ladder", "ladder", tuple(range(11, 15)), 21, 6),
    ("ladder", "ladder", tuple(range(11, 19)), 25, 6),
]
BLOCK_SUMS_TOL = 1e-6
FLAGSHIP_TOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds per call of fn on the card: CUDA events around
    `reps` calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def random_unitary(rng, k: int):
    import numpy as np

    z = rng.standard_normal((k, k)) + 1j * rng.standard_normal((k, k))
    q, r = np.linalg.qr(z)
    return q * (np.diagonal(r) / np.abs(np.diagonal(r)))


def random_planar(rng, n: int, dtype, device):
    """Seeded normalized random planar state (numpy, then to the card)."""
    import numpy as np
    import torch

    psi = rng.standard_normal((2, 1 << n))
    psi /= np.sqrt(np.sum(psi * psi))
    return torch.from_numpy(psi).to(device=device, dtype=dtype)


def op_kind_cases(rng, n: int):
    """(name, gates, M) per fused op kind, qubits spread over the low,
    middle and exposed-axis bit classes of an n-qubit state."""
    from quantumcomputer_tpu_torch.models import circuit as cir

    h = n - 1
    return [
        ("u1q_low", (cir.U1Q(2, random_unitary(rng, 2)),), 0),
        ("u1q_mid", (cir.U1Q(9, random_unitary(rng, 2)),), 0),
        ("u1q_high", (cir.U1Q(h - 2, random_unitary(rng, 2)),), 0),
        ("diag1", (cir.RZ(h - 3, 0.7), cir.PHASE(3, 1.1)), 0),
        ("diag2", (cir.CPHASE(h, 4, 0.9), cir.CZ(12, h - 1)), 0),
        ("iqft_M0", (cir.IQFT_STAGE(h), cir.IQFT_STAGE(5)), 0),
        ("iqft_M7", (cir.IQFT_STAGE(h), cir.IQFT_STAGE(10)), 7),
        ("u2q_low", (cir.U2Q(5, 1, random_unitary(rng, 4)),), 0),
        ("u2q_mixed", (cir.U2Q(h - 4, 3, random_unitary(rng, 4)),), 0),
        ("u2q_high", (cir.U2Q(h, h - 7, random_unitary(rng, 4)), cir.CNOT(2, h - 1)), 0),
        (
            "segment_mix",
            tuple(cir.H(q) for q in range(n - 7, n)) + (cir.CPHASE(h, 0, 0.3), cir.IQFT_STAGE(h - 1)),
            4,
        ),
    ]


def compare_plan(planar, circuit, M: int):
    """Run a circuit's fused plan through the kernel (in place) and through
    plain_segment; returns the max abs difference of the final planes."""
    from quantumcomputer_tpu_torch.ops import fused
    from quantumcomputer_tpu_torch.sim import statevec as sv

    n = sv.num_qubits(planar)
    plan = fused.plan_circuit(circuit, n, M, fused.TILE_BITS[planar.dtype])
    check(all(s[0] == "fused" for s in plan), f"unexpected single gates in plan {plan}")
    want = planar.clone()
    got = planar.clone()
    for _, ops, axes in plan:
        want = fused.plain_segment(want, ops, M)
        fused.apply_fused(got, ops, axes, M)
    return float((got - want).abs().max())


def oracle_modulus(M: int) -> tuple:
    """(C, a) for a work register of M bits: the flagship's 8191 at M = 13,
    else the JAX suite's 33."""
    return (8191, 3) if M == 13 else (33, 7)


def run_oracle(site: str, planar, C: int, A_list, controls, M: int, plain: bool):
    """One oracle call site on `planar`: its kernel, or its plain version
    when `plain`.  Returns the tensor that holds the result."""
    import torch

    from quantumcomputer_tpu_torch.ops import gates as tops
    from quantumcomputer_tpu_torch.ops import oracle

    if site == "ladder":
        if plain:
            return tops.apply_camodc_ladder_high_planes_(planar.clone(), C, A_list, controls, M)
        return oracle.apply_camodc_ladder_high_planar(planar, torch.empty_like(planar), C, A_list, controls, M)
    if plain:
        if site == "pair":
            return tops.apply_camodc_ladder_high_planes_(planar, C, A_list, controls, M)
        return tops.apply_camodc_high_planes_(planar, C, A_list[0], controls[0], M)
    if site == "pair":
        return oracle.apply_camodc_pair_inplace_planar(planar, C, A_list, controls, M)
    if site == "perm":
        return oracle.apply_camodc_high_perm_planar(planar, C, A_list[0], controls[0], M)
    return oracle.apply_camodc_high_cycle_planar(planar, C, A_list[0], controls[0], M)


def oracle_err(site: str, planar, C: int, A_list, controls, M: int) -> float:
    """Max abs difference of the kernel and the plain version on copies of
    `planar` (synchronised, so a fault shows here)."""
    import torch

    want = run_oracle(site, planar.clone(), C, A_list, controls, M, plain=True)
    got = run_oracle(site, planar.clone(), C, A_list, controls, M, plain=False)
    torch.cuda.synchronize()
    return float((got - want).abs().max())


def phase_build() -> float:
    from quantumcomputer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    log(f"build: kernels ready in {seconds:.3f} s ({_build.library_path()})")
    with open(_build.build_log_path()) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    return seconds


def phase_kernels(report: dict, n: int = KERNEL_N) -> None:
    import numpy as np
    import torch

    from quantumcomputer_tpu_torch.ops import measure

    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).replace("torch.", "")
        rng = np.random.default_rng(20)
        for name, gates, M in op_kind_cases(rng, n):
            err = compare_plan(random_planar(rng, n, dtype, DEVICE), gates, M)
            log(f"kernel fused_segment {name:11s} {dname} n={n}: max abs {err:.3e} (tol {TOL[dname]:.0e})")
            check(err <= TOL[dname], f"fused_segment {name} {dname}: {err} > {TOL[dname]}")
            report["fused_segment"]["max_abs_err"] = max(report["fused_segment"]["max_abs_err"], err)
    rng = np.random.default_rng(21)
    planar = random_planar(rng, n, torch.float32, DEVICE)
    err = float((measure.block_sums(planar) - measure.block_sums_plain(planar)).abs().max())
    log(f"kernel block_sums float32 n={n}: max abs {err:.3e} (tol {BLOCK_SUMS_TOL:.0e})")
    check(err <= BLOCK_SUMS_TOL, f"block_sums float32: {err} > {BLOCK_SUMS_TOL}")
    report["block_sums"]["max_abs_err"] = max(report["block_sums"]["max_abs_err"], err)

    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).replace("torch.", "")
        rng = np.random.default_rng(22)
        for kernel, site, controls, n_case, M in ORACLE_CASES:
            C, a = oracle_modulus(M)
            A_list = tuple(pow(a, 1 << k, C) for k in range(len(controls)))
            err = oracle_err(site, random_planar(rng, n_case, dtype, DEVICE), C, A_list, controls, M)
            log(f"kernel {kernel} ({site}) controls {controls} {dname} n={n_case} M={M}: max abs {err:.3e} (tol 0)")
            check(err == 0.0, f"{kernel} {site} {controls} {dname}: {err} != 0")
            report[kernel]["max_abs_err"] = max(report[kernel]["max_abs_err"], err)


def phase_cli() -> None:
    from quantumcomputer_tpu_torch import cli
    from quantumcomputer_tpu_torch.ops import fused

    fused.LAUNCHES = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-C", "15", "-L", "3", "-M", "4", "-a", "7", "-v", "--seed", "0"])
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    check(rc == 0, f"cli.main returned {rc}")
    check(" --- Factors of 15 found: (5, 3)." in buf.getvalue(), "CLI did not factor 15 into (5, 3)")
    check(fused.LAUNCHES > 0, "the CLI run launched no fused-segment kernel")
    log(f"cli: factored 15 = 5 x 3, fused_segment launches {fused.LAUNCHES}")

    from quantumcomputer_tpu_torch.ops import oracle

    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-C", "15", "-L", "3", "-M", "4", "-a", "7", "--layout", "m_high", "-v", "--seed", "0"])
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    check(rc == 0, f"cli.main --layout m_high returned {rc}")
    check(" --- Factors of 15 found: (5, 3)." in buf.getvalue(), "the m_high CLI did not factor 15 into (5, 3)")
    check(oracle.LAUNCHES["cycle"] > 0, "the m_high CLI run launched no cycle kernel")
    log(f"cli --layout m_high: factored 15 = 5 x 3, launches {launches()}")


def reset_launches() -> None:
    from quantumcomputer_tpu_torch.ops import fused, measure, oracle

    fused.LAUNCHES = 0
    measure.LAUNCHES = 0
    for k in oracle.LAUNCHES:
        oracle.LAUNCHES[k] = 0


def launches() -> dict:
    from quantumcomputer_tpu_torch.ops import fused, measure, oracle

    return {"fused_segment": fused.LAUNCHES, "block_sums": measure.LAUNCHES, **oracle.LAUNCHES}


def phase_flagship(report: dict) -> None:
    import torch

    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit
    from quantumcomputer_tpu_torch.ops import fused, measure
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    C, a, L, M = FLAGSHIP
    n = L + M
    circuit = shor_circuit(C, a, L, M)
    reg = Register(L=L, M=M)

    eng = StateVectorEngine(reg, torch.complex64, backend=KERNEL_BACKEND, device=DEVICE)
    cuda_ms = time_ms(lambda: eng.run(circuit), reps=1)
    state = eng.run(circuit)
    norm = eng.norm(state)
    log(f"flagship n={n} C={C} a={a} backend={KERNEL_BACKEND}: {cuda_ms:.3f} ms, norm {norm:.9f}")
    check(abs(norm - 1.0) <= FLAGSHIP_TOL, f"flagship norm {norm}")

    plain_eng = StateVectorEngine(reg, torch.complex64, backend="torch", device=DEVICE)
    plain_ms = time_ms(lambda: plain_eng.run(circuit), reps=1)
    plain_state = plain_eng.run(circuit)
    dist = float(torch.linalg.vector_norm(state - plain_state))
    log(f"flagship n={n} backend=torch: {plain_ms:.3f} ms; ||cuda - torch||_2 = {dist:.3e} (tol {FLAGSHIP_TOL:.0e})")
    check(dist <= FLAGSHIP_TOL, f"flagship cuda vs torch distance {dist}")

    err = float((measure.block_sums(state) - measure.block_sums_plain(state)).abs().max())
    report["block_sums"]["max_abs_err"] = max(report["block_sums"]["max_abs_err"], err)
    check(err <= BLOCK_SUMS_TOL, f"block_sums on the flagship state: {err}")
    report["block_sums"]["ms"] = time_ms(lambda: measure.block_sums(state), reps=10)
    report["block_sums"]["plain_ms"] = time_ms(lambda: measure.block_sums_plain(state), reps=10)
    log(
        f"kernel block_sums n={n}: max abs {err:.3e}; kernel {report['block_sums']['ms']:.4f} ms, "
        f"plain {report['block_sums']['plain_ms']:.4f} ms"
    )
    del plain_state
    phase_flagship_mhigh(report, state)
    del state

    gen = torch.Generator(device=DEVICE).manual_seed(28)
    planar = torch.randn((2, 1 << n), generator=gen, device=DEVICE, dtype=torch.float32)
    planar /= torch.linalg.vector_norm(planar)
    plan = fused.plan_circuit(circuit, n, M, fused.TILE_BITS[torch.float32])
    segments = [s for s in plan if s[0] == "fused"]
    for i, (_, ops, axes) in enumerate(segments):
        want = fused.plain_segment(planar, ops, M)
        got = fused.apply_fused(planar.clone(), ops, axes, M)
        err = float((got - want).abs().max())
        del want, got
        log(f"kernel fused_segment flagship segment {i} ({len(ops)} ops, axes {axes}): max abs {err:.3e}")
        check(err <= TOL["float32"], f"flagship segment {i}: {err}")
        report["fused_segment"]["max_abs_err"] = max(report["fused_segment"]["max_abs_err"], err)
    _, ops, axes = segments[0]
    report["fused_segment"]["ms"] = time_ms(lambda: fused.apply_fused(planar, ops, axes, M), reps=10)
    report["fused_segment"]["plain_ms"] = time_ms(lambda: fused.plain_segment(planar, ops, M), reps=3)
    log(
        f"kernel fused_segment n={n} segment 0 ({len(ops)} ops): kernel {report['fused_segment']['ms']:.4f} ms, "
        f"plain {report['fused_segment']['plain_ms']:.4f} ms"
    )
    del planar
    torch.cuda.empty_cache()


def phase_flagship_mhigh(report: dict, standard_state) -> None:
    import torch

    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer_tpu_torch.ops import fused
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine, plan_circuit

    C, a, L, M = FLAGSHIP
    n = L + M
    circuit = shor_circuit_mhigh(C, a, L, M)
    reg = Register(L=L, M=M)

    eng = StateVectorEngine(reg, torch.complex64, backend=KERNEL_BACKEND, device=DEVICE, layout="m_high")
    cuda_ms = time_ms(lambda: eng.run(circuit), reps=1)
    reset_launches()
    state = eng.run(circuit)
    norm = eng.norm(state)
    counts = launches()
    log(f"flagship m_high n={n} backend={KERNEL_BACKEND}: {cuda_ms:.3f} ms, norm {norm:.9f}, launches {counts}")
    check(abs(norm - 1.0) <= FLAGSHIP_TOL, f"m_high flagship norm {norm}")
    check(counts["ladder"] > 0 and counts["cycle"] > 0, "the m_high flagship launched no ladder or no cycle kernel")

    plain_eng = StateVectorEngine(reg, torch.complex64, backend="torch", device=DEVICE, layout="m_high")
    plain_ms = time_ms(lambda: plain_eng.run(circuit), reps=1)
    dist = float(torch.linalg.vector_norm(state - plain_eng.run(circuit)))
    log(f"flagship m_high n={n} backend=torch: {plain_ms:.3f} ms; ||cuda - torch||_2 = {dist:.3e} (tol {FLAGSHIP_TOL:.0e})")
    check(dist <= FLAGSHIP_TOL, f"m_high flagship cuda vs torch distance {dist}")

    # Physical (2, 2^M, 2^L) transposed on its last two axes is logical (2, 2^L, 2^M).
    logical = state.view(2, 1 << M, 1 << L).transpose(1, 2).reshape(2, -1)
    dist = float(torch.linalg.vector_norm(logical - standard_state))
    del logical
    log(f"flagship m_high vs standard layout (physical -> logical): ||d||_2 = {dist:.3e} (tol {FLAGSHIP_TOL:.0e})")
    check(dist <= FLAGSHIP_TOL, f"m_high vs standard flagship distance {dist}")

    # The memory ceiling: a budget that holds one state and not two.
    state_bytes = state.numel() * state.element_size()
    os.environ["QC_TPU_HBM_BYTES"] = str(state_bytes * 3 // 2)
    try:
        ceiling = StateVectorEngine(reg, torch.complex64, backend=KERNEL_BACKEND, device=DEVICE, layout="m_high")
        ceiling_ms = time_ms(lambda: ceiling.run(circuit), reps=1)
        reset_launches()
        low = ceiling.run(circuit)
        counts = launches()
    finally:
        del os.environ["QC_TPU_HBM_BYTES"]
    dist = float(torch.linalg.vector_norm(low - state))
    del low
    log(
        f"flagship m_high below two states: {ceiling_ms:.3f} ms, launches {counts}; "
        f"||d||_2 = {dist:.3e} (tol {FLAGSHIP_TOL:.0e})"
    )
    check(counts["cycle_masked"] > 0, "the memory-ceiling run launched no cycle_masked kernel")
    check(counts["ladder"] == 0, "the memory-ceiling run launched the out-of-place ladder")
    check(dist <= FLAGSHIP_TOL, f"memory-ceiling flagship distance {dist}")
    report["cycle_masked"]["launches"] = counts["cycle_masked"]
    del state
    torch.cuda.empty_cache()

    # Each fused segment of the m_high plan (low physical bits, M = 0), then
    # each oracle kernel at n = 28 on the call sites of the flagship's plans.
    gen = torch.Generator(device=DEVICE).manual_seed(29)
    planar = torch.randn((2, 1 << n), generator=gen, device=DEVICE, dtype=torch.float32)
    planar /= torch.linalg.vector_norm(planar)
    plan = plan_circuit(circuit, 0, n, torch.float32, DEVICE)
    for i, (_, ops, axes) in enumerate(s for s in plan if s[0] == "fused"):
        want = fused.plain_segment(planar, ops, 0)
        err = float((fused.apply_fused(planar.clone(), ops, axes, 0) - want).abs().max())
        del want
        log(f"kernel fused_segment m_high segment {i} ({len(ops)} ops, axes {axes}): max abs {err:.3e}")
        check(err <= TOL["float32"], f"m_high flagship segment {i}: {err}")
        report["fused_segment"]["max_abs_err"] = max(report["fused_segment"]["max_abs_err"], err)
    for kernel, site, controls in (
        ("ladder", "ladder", tuple(range(11, 15))),
        ("cycle", "cycle", (3,)),
        ("cycle_masked", "pair", (13, 14)),
    ):
        A_list = tuple(pow(a, 1 << c, C) for c in controls)
        err = oracle_err(site, planar, C, A_list, controls, M)
        check(err == 0.0, f"{kernel} at n={n}: {err} != 0")
        report[kernel]["max_abs_err"] = max(report[kernel]["max_abs_err"], err)
        work = planar.clone()
        report[kernel]["ms"] = time_ms(lambda: run_oracle(site, work, C, A_list, controls, M, plain=False), reps=10)
        report[kernel]["plain_ms"] = time_ms(lambda: run_oracle(site, work, C, A_list, controls, M, plain=True), reps=3)
        del work
        log(
            f"kernel {kernel} ({site}) controls {controls} n={n}: max abs {err:.3e}; "
            f"kernel {report[kernel]['ms']:.4f} ms, plain {report[kernel]['plain_ms']:.4f} ms"
        )
    del planar
    torch.cuda.empty_cache()


def phase_factor(report: dict) -> None:
    import torch

    from quantumcomputer_tpu_torch.algorithms.shor import shors_algorithm
    from quantumcomputer_tpu_torch.ops import fused, measure

    C, a, L, M = FACTOR
    fused.LAUNCHES = 0
    measure.LAUNCHES = 0
    t0 = time.perf_counter()
    result = shors_algorithm(
        C, L, M, forced_trial_int=a, seed=0, dtype=torch.complex64,
        backend=KERNEL_BACKEND, max_attempts_per_a=4,
    )
    wall = time.perf_counter() - t0
    report["fused_segment"]["launches"] = fused.LAUNCHES
    report["block_sums"]["launches"] = measure.LAUNCHES
    log(
        f"factor n={L + M} C={C} a={a}: {result.outcome.value}, factors {result.factors}, "
        f"period {result.period}, {len(result.attempts)} attempt(s), {wall:.3f} s; "
        f"launches fused_segment {fused.LAUNCHES}, block_sums {measure.LAUNCHES}"
    )
    check(result.factors == (2729, 3), f"factors {result.factors} != (2729, 3)")
    check(fused.LAUNCHES > 0, "the main path launched no fused-segment kernel")
    check(measure.LAUNCHES > 0, "the main path launched no block-sums kernel")

    reset_launches()
    t0 = time.perf_counter()
    result = shors_algorithm(
        C, L, M, forced_trial_int=a, seed=0, dtype=torch.complex64,
        backend=KERNEL_BACKEND, max_attempts_per_a=4, layout="m_high",
    )
    wall = time.perf_counter() - t0
    counts = launches()
    for k in ("ladder", "cycle"):
        report[k]["launches"] = counts[k]
    log(
        f"factor m_high n={L + M} C={C} a={a}: {result.outcome.value}, factors {result.factors}, "
        f"period {result.period}, {len(result.attempts)} attempt(s), {wall:.3f} s; launches {counts}"
    )
    check(result.factors == (2729, 3), f"m_high factors {result.factors} != (2729, 3)")
    for k in ("fused_segment", "block_sums", "ladder", "cycle"):
        check(counts[k] > 0, f"the m_high main path launched no {k} kernel")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "quantumcomputer_tpu_torch")):
        print("chip_smoke: run it from a checkout that holds quantumcomputer_tpu_torch/", file=sys.stderr)
        return 1
    sys.path.insert(0, root)

    report = {
        "fused_segment": {
            "name": "fused_segment", "route": "cuda",
            "source": "quantumcomputer_tpu_torch/ops/csrc/fused_segment.cu",
            "replaces": "quantumcomputer_tpu/ops/pallas_fused.py:1002",
            "launches": 0, "max_abs_err": 0.0, "ms": None, "plain_ms": None,
        },
        "block_sums": {
            "name": "block_sums", "route": "cuda",
            "source": "quantumcomputer_tpu_torch/ops/csrc/block_sums.cu",
            "replaces": "quantumcomputer_tpu/ops/pallas_measure.py:66",
            "launches": 0, "max_abs_err": 0.0, "ms": None, "plain_ms": None,
        },
        "ladder": {
            "name": "ladder", "route": "cuda",
            "source": "quantumcomputer_tpu_torch/ops/csrc/oracle_ladder.cu",
            "replaces": "quantumcomputer_tpu/ops/pallas_oracle.py:101",
            "launches": 0, "max_abs_err": 0.0, "ms": None, "plain_ms": None,
        },
        "cycle": {
            "name": "cycle", "route": "cuda",
            "source": "quantumcomputer_tpu_torch/ops/csrc/oracle_cycle.cu",
            "replaces": "quantumcomputer_tpu/ops/pallas_oracle.py:274",
            "launches": 0, "max_abs_err": 0.0, "ms": None, "plain_ms": None,
        },
        "cycle_masked": {
            "name": "cycle_masked", "route": "cuda",
            "source": "quantumcomputer_tpu_torch/ops/csrc/oracle_cycle.cu",
            "replaces": "quantumcomputer_tpu/ops/pallas_oracle.py:531",
            "launches": 0, "max_abs_err": 0.0, "ms": None, "plain_ms": None,
        },
    }
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    phase_build()
    phase_kernels(report)
    phase_cli()
    phase_flagship(report)
    phase_factor(report)

    log(json.dumps({"kernels": list(report.values())}))
    log(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
