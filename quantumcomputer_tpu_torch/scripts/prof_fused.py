"""Times of the fused-segment kernel's instances and of the mxuroll probe on
the card, for comparing checkouts.

At n = 28 (C = 8191, a = 3, L = 15, M = 13), on states of unit-variance
components, CUDA events over ten launches each: every fused segment of the
complex32 engine's standard, m_high and benes plans at bf16 (the m_high
plan's grouped segments through the matrix instance), each segment without
matrix groups also through the float32 instance with the same ops and axes;
the standard plan's segment 0 at float64; and a segment that mixes H gates
with two camodc ops (the fused kernel's camodc instances) at float32 and
bf16; and the shapes that separate a segment's costs, H gates on the
exposed axes 13-17 with the tile cut as each line says (``SHAPES``: the
tile's low bits t set by the axes passed, the register groups by the
distinct targets), at bf16 and float32.  Then the chunk probes roll2 and mxuroll on a 2^28-float plane
(W = 16384, arbitrary starts), each held exactly against its plain
version, beside torch.roll of the same bytes.

    python quantumcomputer_tpu_torch/scripts/prof_fused.py [--root DIR]

--root times the package of another checkout (a parent commit unpacked
with ``git archive``) in this process, as prof_benes.py does; a comparison
in turns calls the script once a turn.  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys

FLAGSHIP = (8191, 3, 15, 13)  # C, a, L, M
PROBE_M, PROBE_W = 28, 16384
# (label, H targets, exposed axes): t = 12 - len(axes) at bf16 and float32;
# the register groups take the distinct targets two to a group at float32,
# three at bf16 (2^5 amplitudes a thread).
SHAPES = (
    ("t=10, 2 ops on 2 targets", (13, 14), (13, 14)),
    ("t=7, 2 ops on 2 targets", (13, 14), (13, 14, 15, 16, 17)),
    ("t=7, 3 ops on 3 targets", (13, 15, 17), (13, 14, 15, 16, 17)),
    ("t=7, 5 ops on 5 targets", (13, 14, 15, 16, 17), (13, 14, 15, 16, 17)),
    ("t=10, 5 ops on 2 targets", (13, 14, 13, 14, 13), (13, 14)),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    help="the checkout whose quantumcomputer_tpu_torch is timed (default: this one)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("prof_fused: no CUDA device is available", file=sys.stderr)
        return 1
    from quantumcomputer_tpu_torch.models import circuit as cir
    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
    from quantumcomputer_tpu_torch.ops import _build, fused, probes
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
    from quantumcomputer_tpu_torch.utils.profiling import cuda_ms

    if not fused.__file__.startswith(root + os.sep):
        print(f"prof_fused: quantumcomputer_tpu_torch was already imported from {fused.__file__}", file=sys.stderr)
        return 1
    _build.load()
    C, a, L, M = FLAGSHIP
    n = L + M
    reg = Register(L=L, M=M)
    print(f"prof_fused {root} on {torch.cuda.get_device_name(0)}", flush=True)
    plans = {}
    for name, layout, oracle_kind in (("standard", "standard", "gather"), ("m_high", "m_high", "gather"),
                                      ("benes", "standard", "benes")):
        eng = StateVectorEngine(reg, "complex32", device="cuda", layout=layout, oracle=oracle_kind)
        circuit = (shor_circuit_mhigh if layout == "m_high" else shor_circuit)(C, a, L, M)
        m = 0 if layout == "m_high" else M
        segments = [s for s in eng._plan(circuit) if s[0] == "fused" and not any(op[0] == "camodc" for op in s[1])]
        plans[name] = (segments, m)
    mixed = fused.plan_circuit((cir.H(3), cir.CAMODC(C, a, 14), cir.CAMODC(C, 9, 15), cir.H(10), cir.H(5)), n, M,
                               fused.TILE_BITS[torch.float32], fuse_oracle=True)
    gen = torch.Generator(device="cuda").manual_seed(28)
    x32 = torch.randn((2, 1 << n), generator=gen, device="cuda")
    x16 = x32.to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(PROBE_M)
    plane = torch.randn(1 << PROBE_M, generator=gen, device="cuda")
    nc = (1 << PROBE_M) // PROBE_W
    starts = torch.from_numpy(np.random.default_rng(0).integers(0, (1 << PROBE_M) - PROBE_W - 1024, nc)
                              .astype(np.int32)).to("cuda")
    for probe in (probes.chunk_roll2, probes.chunk_mxuroll):
        if not torch.equal(probe(plane, starts, PROBE_W), probes.chunk_gather_plain(plane, starts, PROBE_W)):
            print(f"prof_fused: {probe.__name__} differs from its plain version", file=sys.stderr)
            return 1

    def line(label, ms):
        print(f"{label} ms (sum {sum(ms):.4f}): " + " ".join(f"{t:.4f}" for t in ms), flush=True)

    for name, (segments, m) in plans.items():
        grouped = [any(op[0] in fused.MATRIX_KINDS for op in fused.segment_ops(ops, m, torch.bfloat16, n)[0])
                   for _, ops, _ in segments]
        line(f"bf16 {name} segments", [cuda_ms(lambda: fused.apply_fused(x16, ops, axes, m), 10)
                                       for _, ops, axes in segments])
        line(f"f32 {name} segments without matrix groups",
             [cuda_ms(lambda: fused.apply_fused(x32, ops, axes, m), 10)
              for (_, ops, axes), g in zip(segments, grouped) if not g])
        if any(grouped):
            line(f"bf16 {name} grouped segments", [cuda_ms(lambda: fused.apply_fused(x16, ops, axes, m), 10)
                                                   for (_, ops, axes), g in zip(segments, grouped) if g])
    for planes in (torch.float32, torch.bfloat16):
        x = x32 if planes == torch.float32 else x16
        line(f"{'f32' if planes == torch.float32 else 'bf16'} mixed camodc segment",
             [cuda_ms(lambda: fused.apply_fused(x, ops, axes, M), 10) for _, ops, axes in mixed])
    for label, targets, axes in SHAPES:
        ops = tuple(fused.gate_to_op(cir.H(q)) for q in targets)
        line(f"shape {label}: bf16 / f32", [cuda_ms(lambda: fused.apply_segment(x, ops, axes, M), 10)
                                             for x in (x16, x32)])
    _, ops, axes = plans["standard"][0][0]
    x64 = x32.double()
    line("f64 standard segment 0", [cuda_ms(lambda: fused.apply_fused(x64, ops, axes, M), 10)])
    del x64
    torch.cuda.empty_cache()
    line("probes roll2 / mxuroll / torch.roll",
         [cuda_ms(lambda: probes.chunk_roll2(plane, starts, PROBE_W), 10),
          cuda_ms(lambda: probes.chunk_mxuroll(plane, starts, PROBE_W), 10),
          cuda_ms(lambda: torch.roll(plane, 12345), 10)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
