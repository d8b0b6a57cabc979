"""How far amplitude estimation's counting register drifts from its ideal
distribution, at complex64 and complex32, as the work register grows.

For each (n, t) of ``SIZES`` (or --sizes), with 2 marked items ({3, 4}) and
the draw 0.3: ``amplitude_estimate`` on the engine, the counting register's
distribution read from the state before the measurement
(``kernel_checks.counting_marginal``) and its total variation from
``kernel_checks.ae_counting_probabilities``, with the readout, the fused and
matrix-group launches and the host seconds.  --no-groups plans complex32
without matrix groups (``fused.GROUP_DTYPES`` emptied); --device cpu runs
the kernels' plain versions, which is how a card's drift is held against
them at a size the CPU can take.

    python quantumcomputer_tpu_torch/scripts/prof_ae_drift.py [--device cpu] [--sizes 12,10 18,10] [--no-groups]

Prints the card's name and power limit first on a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

SIZES = ((10, 10), (12, 10), (14, 10), (16, 10), (18, 8), (18, 10))
MARKED = (3, 4)
DRAW = 0.3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", nargs="*", default=[f"{n},{t}" for n, t in SIZES], help="n,t pairs")
    ap.add_argument("--dtypes", nargs="*", default=["complex64", "complex32"])
    ap.add_argument("--no-groups", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    import numpy as np
    import torch

    from quantumcomputer_tpu_torch.algorithms import amplitude_estimation as ae
    from quantumcomputer_tpu_torch.ops import fused
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
    from quantumcomputer_tpu_torch.utils import kernel_checks

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("prof_ae_drift: no CUDA device is available", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0], flush=True)
    if args.no_groups:
        fused.GROUP_DTYPES = ()
    backend = "cuda" if args.device == "cuda" else "auto"
    for size in args.sizes:
        n, t = (int(v) for v in size.split(","))
        for name in args.dtypes:
            eng = StateVectorEngine(Register(L=t, M=n), torch.complex64 if name == "complex64" else name,
                                    backend=backend, device=args.device)
            marginals = []
            run = eng.run

            def observed_run(circ, state=None, run=run, marginals=marginals, n=n):
                out = run(circ, state)
                marginals.append(kernel_checks.counting_marginal(out, n))  # before measure collapses it
                return out

            eng.run = observed_run
            launched = (fused.LAUNCHES, fused.MATMUL_LAUNCHES)
            t0 = time.perf_counter()
            res = ae.amplitude_estimate(n, MARKED, t, DRAW, engine=eng)
            seconds = time.perf_counter() - t0
            ideal = kernel_checks.ae_counting_probabilities(n, len(MARKED), t)
            tv = 0.5 * float(np.abs(marginals[0] - ideal).sum())
            print(f"n={n} t={t} {name}{' ungrouped' if args.no_groups else ''} ({args.device}): total variation "
                  f"{tv:.6e}, x {res.qpe.x}; fused launches {fused.LAUNCHES - launched[0]}, matrix groups "
                  f"{fused.MATMUL_LAUNCHES - launched[1]}; {seconds:.3f} s", flush=True)
            del eng, run
            if args.device == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
