"""Run one cell of the benchmark of quantumcomputer_tpu_torch once.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with the CUDA cards the cell asks
for.  Set-up (the kernel library, the engine, the warm-up) is timed from
process start; then attempts run in a closed loop for S seconds; with
``--trace 1`` a short slice after the window runs under torch.profiler for
the per-layer metrics.  What the window produced is then compared with the
plain reference (``portbench/reference.py``).  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, ``breakdown`` when traced, and ``checks`` last: each
number compared beside its limit); the same numbers end standard error.

Exit codes: 0 with a result; 2 bad arguments or an unknown cell; 3 no CUDA
card, or fewer than the cell asks for; 4 the program cannot be imported;
5 a forbidden module (``jax``, ``jaxlib``, ``flax``, the JAX package) is
loaded once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)

# One host thread for the CPU libraries: the card host shares its cores, and
# with a pool of eight threads the sweep cell's attempts stalled for seconds
# in 3 runs of 20, with one thread in 1 of 21 (NVIDIA H100 host, PyTorch 2.11).
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # The program's choices may not depend on the caller's environment.
    for var in ("QC_SC_STRUCTURED", "QC_TPU_HBM_BYTES", "QC_TPU_DISABLE_NATIVE"):
        os.environ.pop(var, None)
    sys.path.insert(0, CHECKOUT)
    from portbench import core

    try:
        cell = core.cell(args.workload)
    except KeyError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        import quantumcomputer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program cannot be imported: {e}", file=sys.stderr)
        return 4

    result = core.run(args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    found = core.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
