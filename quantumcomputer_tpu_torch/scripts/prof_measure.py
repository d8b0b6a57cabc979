"""Times of one engine.measure (one draw's sample, then the collapse) on the
card, with this package's sampler and with the sampler of other revisions,
for comparing them in one process.

At n = 28 and n = 31, complex64 and complex32, on a state of unit-variance
components, CUDA events (profiling.cuda_ms: the mean of --reps calls after
a warm-up): ``StateVectorEngine.measure`` as it stands, and with
``sim/engine.py``'s measure module swapped for each --sampler file (another
revision's ``ops/measure.py``, e.g. ``git show <rev>:quantumcomputer_tpu_torch/ops/measure.py``),
whose block sums launch this checkout's kernel.  The revisions are timed in
turns, first to last and back again, and both turns are printed.  Beside
them, ``sample`` of --shots draws with this package's sampler.

    python quantumcomputer_tpu_torch/scripts/prof_measure.py [--sampler NAME=FILE ...]

Prints the card's name and power limit first and last.  Exits 1 without a
CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

SIZES = (28, 31)


def load_sampler(name: str, path: str):
    """The measure module in `path`, imported under its own name."""
    spec = importlib.util.spec_from_file_location(f"qc_sampler_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sampler", action="append", default=[], metavar="NAME=FILE",
                    help="another revision's ops/measure.py, timed in engine.measure beside this package's")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shots", type=int, default=100)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    import torch

    if not torch.cuda.is_available():
        print("prof_measure: no CUDA device is available", file=sys.stderr)
        return 1
    from quantumcomputer_tpu_torch.ops import measure
    from quantumcomputer_tpu_torch.sim import engine as engine_mod
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
    from quantumcomputer_tpu_torch.utils.profiling import cuda_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    samplers = [("this", measure)] + [(s.split("=", 1)[0], load_sampler(*s.split("=", 1))) for s in args.sampler]
    turns = samplers + samplers[::-1]
    for n in SIZES:
        for dtype in (torch.complex64, "complex32"):
            eng = StateVectorEngine(Register(L=n, M=0), dtype, backend="cuda", device="cuda")
            gen = torch.Generator(device="cuda").manual_seed(n)
            state = torch.randn((2, 1 << n), generator=gen, device="cuda").to(eng.real_dtype)
            ms = {}
            for name, mod in turns:
                engine_mod.measure = mod
                # A measure collapses the state: each later call samples a
                # basis state, which costs the sampler what any state does.
                ms.setdefault(name, []).append(cuda_ms(lambda: eng.measure(state, 0.37), args.reps))
            engine_mod.measure = measure
            state = torch.randn((2, 1 << n), generator=gen, device="cuda").to(eng.real_dtype)
            rs = torch.rand(args.shots, generator=torch.Generator().manual_seed(n))
            before = measure.LAUNCHES
            eng.sample(state, rs)
            launches = measure.LAUNCHES - before
            sample_ms = cuda_ms(lambda: eng.sample(state, rs), 3)
            del state
            torch.cuda.empty_cache()
            name = "complex64" if dtype == torch.complex64 else "complex32"
            print(f"measure n={n} {name}: " + ", ".join(
                f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms" for k, v in ms.items())
                + f"; sample of {args.shots} shots {sample_ms:.4f} ms ({launches} block-sum launch)", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
