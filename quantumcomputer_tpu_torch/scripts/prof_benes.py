"""Times of the --oracle benes path on the card, for comparing checkouts.

At n = 28 (C = 8191, a = 3, L = 15, M = 13), at complex64 and complex32:
the flagship circuit in its three forms (the gather oracle, --oracle benes
and the m_high layout), two rounds in turns, each the mean of three runs;
then, on a state of unit-variance components, every fused segment of the
three plans, CUDA events over ten launches each, the benes plan's oracle
segments first held exactly against their plain Benes version.

    python quantumcomputer_tpu_torch/scripts/prof_benes.py [--root DIR] [--segments-only]

--root times the package of another checkout (a parent commit unpacked
with ``git archive``, or a copy with a kernel variant) in this process;
--segments-only times the benes plan's oracle segments alone, which needs
no kernel but the one they launch.  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys

FLAGSHIP = (8191, 3, 15, 13)  # C, a, L, M


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    help="the checkout whose quantumcomputer_tpu_torch is timed (default: this one)")
    ap.add_argument("--segments-only", action="store_true", help="time only the benes plan's oracle segments")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("prof_benes: no CUDA device is available", file=sys.stderr)
        return 1
    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
    from quantumcomputer_tpu_torch.ops import _build, fused
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
    from quantumcomputer_tpu_torch.utils.profiling import cuda_ms

    if not fused.__file__.startswith(root + os.sep):
        print(f"prof_benes: quantumcomputer_tpu_torch was already imported from {fused.__file__}", file=sys.stderr)
        return 1
    _build.load()
    C, a, L, M = FLAGSHIP
    n = L + M
    reg = Register(L=L, M=M)
    print(f"prof_benes {root} on {torch.cuda.get_device_name(0)}", flush=True)
    for dtype in (torch.complex64, "complex32"):
        forms = {
            "gather": (StateVectorEngine(reg, dtype, backend="cuda", device="cuda"), shor_circuit(C, a, L, M), M),
            "benes": (StateVectorEngine(reg, dtype, backend="cuda", device="cuda", oracle="benes"),
                      shor_circuit(C, a, L, M), M),
            "m_high": (StateVectorEngine(reg, dtype, backend="cuda", device="cuda", layout="m_high"),
                       shor_circuit_mhigh(C, a, L, M), 0),
        }
        if args.segments_only:
            forms = {"benes": forms["benes"]}
        else:
            times = {name: [] for name in forms}
            for _ in range(2):
                for name, (eng, circuit, _) in forms.items():
                    times[name].append(cuda_ms(lambda: eng.run(circuit), 3))
            print(f"{dtype} flagship ms, turns: " + "; ".join(
                f"{name} {' / '.join(f'{t:.3f}' for t in ts)}" for name, ts in times.items()), flush=True)
        planes = torch.float32 if dtype == torch.complex64 else torch.bfloat16
        gen = torch.Generator(device="cuda").manual_seed(28)
        x = torch.randn((2, 1 << n), generator=gen, device="cuda").to(planes)
        for name, (eng, circuit, m) in forms.items():
            segments = [s for s in eng._plan(circuit) if s[0] == "fused"]
            if name == "benes":
                segments = [s for s in segments if any(op[0] == "camodc" for op in s[1])]
                for _, ops, axes in segments:
                    want = fused.plain_segment(x, ops, m)
                    if not torch.equal(fused.apply_fused(x.clone(), ops, axes, m), want):
                        print(f"prof_benes: oracle segment {ops} differs from its plain version", file=sys.stderr)
                        return 1
                    del want
            ms = [cuda_ms(lambda: fused.apply_fused(x, ops, axes, m), 10) for _, ops, axes in segments]
            label = "oracle segments" if name == "benes" else "segments"
            print(f"{dtype} {name} {label} ms (sum {sum(ms):.4f}): " + " ".join(f"{t:.4f}" for t in ms), flush=True)
        del x, forms
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
