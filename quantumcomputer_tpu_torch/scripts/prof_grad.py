"""Times of the n = 28 flagship's engine.run without a gradient, and of its
forward with one and its backward (the dagger circuit through the same plan
and kernels), on the card, for comparing checkouts.

The flagship is C = 8191, a = 3, L = 15, M = 13 in four forms: complex64
with the gather oracle, with oracle="benes" and in the m_high layout, and
complex32 in the m_high layout.  CUDA events around 3 calls after a
warm-up call (utils/profiling.cuda_ms); the backward is
torch.autograd.grad of the output with a seeded unit cotangent.  A checkout
whose engine has no gradient (a parent commit) times the run alone.

    python quantumcomputer_tpu_torch/scripts/prof_grad.py [--root DIR]

--root times the package of another checkout (a parent commit unpacked
with ``git archive``) in this process, as prof_strip.py does, so a
comparison in turns calls the script once a turn.  Prints the card's name
and power limit first, then one line a form and one JSON line of all the
times.  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

FLAGSHIP = (8191, 3, 15, 13)  # C, a, L, M
# (name, dtype, layout, oracle)
FORMS = (("gather", "complex64", "standard", "gather"), ("benes", "complex64", "standard", "benes"),
         ("m_high", "complex64", "m_high", "gather"), ("m_high c32", "complex32", "m_high", "gather"))
REPS = 3
SEED = 14


def cotangent(n: int, real_dtype):
    """The seeded unit planar state (SEED) the backward is timed with, on the
    card, in the plane dtype."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    w = torch.randn((2, 1 << n), generator=gen, device="cuda")
    return (w / torch.linalg.vector_norm(w)).to(real_dtype)


def form_ms(form) -> dict:
    """{"run": ms, "forward": ms, "backward": ms} of one form; the last two
    only where the engine takes a gradient."""
    import torch

    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
    from quantumcomputer_tpu_torch.sim import engine as tengine
    from quantumcomputer_tpu_torch.utils.profiling import cuda_ms

    name, dtype, layout, oracle_kind = form
    C, a, L, M = FLAGSHIP
    circuit = (shor_circuit_mhigh if layout == "m_high" else shor_circuit)(C, a, L, M)
    eng = tengine.StateVectorEngine(tengine.Register(L=L, M=M), torch.complex64 if dtype == "complex64" else dtype,
                                    backend="cuda", device="cuda", layout=layout, oracle=oracle_kind)
    out = {"run": cuda_ms(lambda: eng.run(circuit), REPS)}
    if hasattr(tengine, "_AdjointRun"):
        w = cotangent(L + M, eng.real_dtype)
        p = eng.initial_state().requires_grad_()
        y = eng.run(circuit, p)
        out["forward"] = cuda_ms(lambda: eng.run(circuit, p), REPS)
        out["backward"] = cuda_ms(lambda: torch.autograd.grad(y, p, w, retain_graph=True), REPS)
        del y, p, w
    del eng
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    help="the checkout whose quantumcomputer_tpu_torch is timed (default: this one)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("prof_grad: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    times = {}
    for form in FORMS:
        times[form[0]] = form_ms(form)
        print(f"flagship n={sum(FLAGSHIP[2:])} {form[0]} ({root}): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in times[form[0]].items()), flush=True)
    print(json.dumps({"root": root, "card": card, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
