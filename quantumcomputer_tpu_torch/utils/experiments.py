"""Validation experiments mirroring the reference's methodology.

The counterpart of the JAX package's ``utils/experiments.py``.  The
reference validates statistically (SURVEY.md §4): Report §IV.B / TABLE I
runs factoring 15 (L=3, M=4, a=7) 100 times and compares the measured-omega
histogram against Candela's published counts; Report §IV.A / FIG. 2 tracks
norm conservation through every gate of factoring 39; Report §IV.C / FIG. 3
times the circuit against L and M.  These helpers reproduce all three on
the port's engine.  Draws are injected: ``omega_histogram`` takes them as
``rs``, or draws them from a CPU ``torch.Generator`` seeded with ``seed``
(the port's convention, ``algorithms/shor.py``).

    python -m quantumcomputer_tpu_torch.utils.experiments [--runs N] [--fig3] [--qv M]
"""

from __future__ import annotations

import math
import sys
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from quantumcomputer_tpu_torch.algorithms.shor import read_omega
from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh, shor_circuit_reference
from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
from quantumcomputer_tpu_torch.utils.profiling import NormTrace, norm_trace, time_circuit_folded


def omega_histogram(
    C: int,
    a: int,
    L: int,
    M: int,
    runs: int = 100,
    seed: int = 0,
    engine: Optional[StateVectorEngine] = None,
    rs: Optional[Sequence[float]] = None,
) -> Dict[float, int]:
    """TABLE I experiment: `runs` independent period-finding executions,
    each a fresh reset -> circuit -> single measurement (the no-remeasure
    semantic, qc_shor.c:299-301); returns the omega -> count histogram.

    Run k measures with draw rs[k] when `rs` is given (`runs` draws in
    [0, 1)); otherwise the draws come from a CPU torch.Generator seeded with
    `seed`, one float64 per run.  For (C=15, a=7, L=3, M=4) theory gives
    exactly uniform counts over {0, 1/4, 1/2, 3/4}."""
    if engine is None:
        engine = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex64)
    if rs is None:
        gen = torch.Generator().manual_seed(seed)
        rs = [float(torch.rand((), generator=gen, dtype=torch.float64)) for _ in range(runs)]
    elif len(rs) != runs:
        raise ValueError(f"{len(rs)} draws for {runs} runs")
    mhigh = getattr(engine, "layout", "standard") == "m_high"
    circuit = shor_circuit_mhigh(C, a, L, M) if mhigh else shor_circuit(C, a, L, M)
    hist: Counter = Counter()
    for r in rs:
        # The index-only form: the collapsed state is never used here.
        idx = int(engine.run_and_measure_index(circuit, float(r)))
        if mhigh:
            idx = engine.logical_index(idx)
        hist[read_omega(idx, L, M)] += 1
    return dict(hist)


def norm_deviation_trace(C: int, a: int, L: int, M: int, engine: Optional[StateVectorEngine] = None) -> NormTrace:
    """FIG. 2 experiment: norm deviations through the gate-for-gate circuit
    (Report §IV.A tracked factoring 39 at L=6, M=6; max deviation 2.4e-15 in
    double precision).  The default engine runs complex128."""
    if engine is None:
        engine = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128)
    return norm_trace(engine, shor_circuit_reference(C, a, L, M))


def chi2_p_value_dof3(chi2: float) -> float:
    """Upper tail of the chi-squared distribution with 3 degrees of freedom:
    the regularized Q(3/2, x) at x = chi2/2, in closed form,
    erfc(sqrt(x)) + 2 sqrt(x/pi) e^(-x)."""
    x = chi2 / 2.0
    return math.erfc(math.sqrt(x)) + 2.0 * math.sqrt(x / math.pi) * math.exp(-x)


@dataclass
class Table1Result:
    """Scripted TABLE I check: omega histogram + chi-squared uniformity."""

    counts: Dict[float, int]
    runs: int
    chi2: float
    p_value: float
    passed: bool

    def __str__(self) -> str:
        bins = ", ".join(f"w={w:.2f}: {c}" for w, c in sorted(self.counts.items()))
        return (
            f"TABLE I ({self.runs} runs): {bins} | chi2={self.chi2:.2f} "
            f"p={self.p_value:.4f} -> {'PASS' if self.passed else 'FAIL'}"
        )


def table1_experiment(
    runs: int = 400,
    seed: int = 0,
    engine: Optional[StateVectorEngine] = None,
    min_p: float = 0.001,
) -> Table1Result:
    """Repeatable TABLE I harness (Report §IV.B): factor 15 with L=3, M=4,
    a=7; theory predicts the measured omega exactly uniform over the four
    harmonics {0, 1/4, 1/2, 3/4}.  Runs `runs` independent shots, checks
    that every omega lands on a harmonic, and chi-squared-tests uniformity.

    The check passes when p >= min_p; min_p defaults to 0.001 so a correct
    simulator fails ~0.1% of the time by chance: tighten locally when
    investigating, don't loosen."""
    C, a, L, M = 15, 7, 3, 4
    hist = omega_histogram(C, a, L, M, runs=runs, seed=seed, engine=engine)
    harmonics = (0.0, 0.25, 0.5, 0.75)
    if any(w not in harmonics for w in hist):
        return Table1Result(counts=hist, runs=runs, chi2=float("inf"), p_value=0.0, passed=False)
    counts = [hist.get(w, 0) for w in harmonics]
    expected = runs / 4.0
    chi2 = sum((c - expected) ** 2 / expected for c in counts)
    p = chi2_p_value_dof3(chi2)
    return Table1Result(
        counts={w: hist.get(w, 0) for w in harmonics},
        runs=runs,
        chi2=float(chi2),
        p_value=p,
        passed=p >= min_p,
    )


def fig3_scaling(
    C: int = 21,
    a: int = 2,
    L_range=(3, 4, 5, 6, 7, 8),
    M_range=(5, 6, 7, 8, 9, 10),
    L_fixed: int = 3,
    M_fixed: int = 5,
    dtype=torch.complex64,
    backend: Optional[str] = None,
    iters: int = 3,
):
    """FIG. 3 experiment (Report §IV.C): execution time factoring C=21 with
    forced a=2, varying L at fixed M and varying M at fixed L.  The measured
    quantity is one reset -> circuit -> norm run
    (profiling.time_circuit_folded: CUDA events on a card, the host clock on
    the CPU), best of `iters`.

    Returns (rows_L, rows_M): lists of (L, M, n, seconds).  backend=None
    picks cuda when a CUDA device is present and torch otherwise."""
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "torch"

    def one(L, M):
        eng = StateVectorEngine(Register(L=L, M=M), dtype=dtype, backend=backend)
        return time_circuit_folded(eng, shor_circuit(C, a, L, M), iters=iters)

    rows_L = [(L, M_fixed, L + M_fixed, one(L, M_fixed)) for L in L_range]
    rows_M = [(L_fixed, M, L_fixed + M, one(L_fixed, M)) for M in M_range]
    return rows_L, rows_M


def main(argv=None) -> int:
    """CLI: `python -m quantumcomputer_tpu_torch.utils.experiments [--runs N]`
    runs the scripted TABLE I check on the default backend (cuda when a card
    is present) and exits nonzero on failure.  --dtype complex32 runs it on
    the complex32 engine (the cuda backend, on the CPU through the kernels'
    plain versions on a host with no CUDA device).  --qv M also runs the
    Quantum Volume protocol at width M (30 circuits, 100 shots, the draws
    and circuits from --seed) on a complex64 engine, and the exit code is
    nonzero when either check fails."""
    import argparse

    ap = argparse.ArgumentParser(description="Scripted TABLE I omega-distribution check")
    ap.add_argument("--runs", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-p", type=float, default=0.001)
    ap.add_argument(
        "--dtype",
        choices=["complex64", "complex32"],
        default="complex64",
        help="amplitude precision (complex32: bf16-storage throughput mode)",
    )
    ap.add_argument(
        "--fig3", action="store_true",
        help="also run the FIG. 3 scaling experiment (time vs L and vs M, C=21 a=2)",
    )
    ap.add_argument(
        "--qv", type=int, default=0, metavar="M",
        help="also run the Quantum Volume protocol at width M (pass/fail vs 2/3)",
    )
    args = ap.parse_args(argv)
    engine = None
    if args.dtype == "complex32":
        engine = StateVectorEngine(Register(L=3, M=4), dtype="complex32")
    res = table1_experiment(runs=args.runs, seed=args.seed, min_p=args.min_p, engine=engine)
    print(res)
    if args.fig3:
        rows_L, rows_M = fig3_scaling()
        print("FIG.3 time vs L (M=5):", ", ".join(f"L={L}: {s*1e3:.1f} ms" for L, _, _, s in rows_L))
        print("FIG.3 time vs M (L=3):", ", ".join(f"M={M}: {s*1e3:.1f} ms" for _, M, _, s in rows_M))
    qv_ok = True
    if args.qv:
        from quantumcomputer_tpu_torch.algorithms.quantum_volume import run_quantum_volume

        qv_eng = StateVectorEngine(Register(L=args.qv, M=0), dtype=torch.complex64)
        qv = run_quantum_volume(args.qv, qv_eng, num_circuits=30, shots=100, seed=args.seed)
        print(
            f"QV m={args.qv}: mean HOP {qv.mean_hop:.3f}, 2-sigma lower "
            f"{qv.lower_2sigma:.3f} -> {'PASS (QV=%d)' % qv.quantum_volume if qv.passed else 'FAIL'}"
        )
        qv_ok = qv.passed
    return 0 if (res.passed and qv_ok) else 1


if __name__ == "__main__":
    sys.exit(main())
