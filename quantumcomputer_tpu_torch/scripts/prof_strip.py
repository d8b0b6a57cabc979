"""Times of the strip pass (csrc/oracle_strip.cu) on the card, beside the
cycle walks it replaces, and of the complex32 m_high flagship that merges
them, for comparing checkouts.

At n = 28, on states of unit-variance components, CUDA events: a run of
adjacent single oracles through the strip pass, held exactly against its
plain version; beside it the same gates one by one through the cycle walk
(each control, and their sum), and for the ``CASES`` the plain version, one
PyTorch call computing the same function (``library_row_gather``) and the
bound (the moved bytes read once and written once over 3.35 TB/s).
``CASES``: the complex32 plan's walks (controls 0-11 at C = 8191, M = 13,
16-byte strips), the same run at M = 12 (C = 4093, where 32-byte strips
fit), the complex64 plan's walks (controls 0-10) through the float32
instance, and lone gates at controls 0 and 3 (K = 1) at bf16.
``CROSSOVER``: short runs at low, middle and high controls, the pass beside
the sum of its walks, which the engine's merge rule (``oracle.strip_pays``)
is read from.

    python quantumcomputer_tpu_torch/scripts/prof_strip.py [--flagship] [--root DIR]

--flagship times only the complex32 m_high flagship (C = 8191, a = 3,
L = 15, M = 13) through the engine, with two states' memory and below it
(``QC_TPU_HBM_BYTES``), and counts its launches; --root times the package
of another checkout (a parent commit unpacked with ``git archive``) in this
process, as prof_fused.py does, so a comparison in turns calls the script
once a turn.  Prints the card's name and power limit first and last.
Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
N = 28
FLAGSHIP = (8191, 3, 15, 13)  # C, a, L, M
# (label, plane dtype name, C, a, M, controls)
CASES = (
    ("complex32 m_high plan walks", "bfloat16", 8191, 3, 13, tuple(range(12))),
    ("M=12 run, 32-byte strips", "bfloat16", 4093, 2, 12, tuple(range(12))),
    ("complex64 m_high plan walks, float32 instance", "float32", 8191, 3, 13, tuple(range(11))),
    ("lone gate at control 0", "bfloat16", 8191, 3, 13, (0,)),
    ("lone gate at control 3", "bfloat16", 8191, 3, 13, (3,)),
)
# (C, a, M, controls) at bf16: short runs, the pass beside its walks.
CROSSOVER = (
    *((8191, 3, 13, r) for r in ((0, 1), (0, 1, 2), (2, 3), (3, 4), (4, 5), (4, 5, 6), (6, 7), (6, 7, 8),
                                 (8, 9), (8, 9, 10), (8, 9, 10, 11), (11, 12), (11, 12, 13), (12, 13))),
    *((4093, 2, 12, r) for r in ((0, 1), (3, 4), (4, 5), (6, 7), (8, 9), (8, 9, 10), (8, 9, 10, 11), (11, 12))),
)


def moved_bytes(planar, C: int, M: int, K: int) -> float:
    """Bytes a run moves, each read once and written once: rows 1..C-1 of
    the columns with a control bit set (1 - 2^-K of them)."""
    state_bytes = planar.numel() * planar.element_size()
    return 2.0 * state_bytes * (1.0 - 2.0 ** -K) * (C - 1) / (1 << M)


def library_row_gather(planar, C: int, A_list, controls, M: int):
    """(fn, description): one advanced-indexing call, out of place, that
    computes a run whose controls are the contiguous column bits
    lo .. lo + K - 1 in order: over the (2, 2^M, H, 2^K, 2^lo) view,
    out[p, f, h, m, l] = x[p, T[f, m], h, m, l], T the (2^M, 2^K) source
    rows of each control combination m (built beforehand; the index
    tensors broadcast, none is state-sized).  The port never calls it."""
    import torch

    from quantumcomputer_tpu_torch.ops import gates as tops

    K, lo = len(controls), min(controls)
    log_rest = planar.shape[1].bit_length() - 1 - M
    if tuple(controls) != tuple(range(lo, lo + K)):
        raise ValueError(f"controls {controls} are not contiguous column bits in order")
    combos = torch.from_numpy(tops.modexp_combo_multipliers(C, list(A_list))).to(planar.device)
    f = torch.arange(1 << M, device=planar.device)[:, None]
    rows = torch.where(f < C, (combos[None, :] * f) % C, f)[:, None, :]
    high = torch.arange(1 << (log_rest - lo - K), device=planar.device)[None, :, None]
    lanes = torch.arange(1 << K, device=planar.device)[None, None, :]
    view = planar.view(2, 1 << M, 1 << (log_rest - lo - K), 1 << K, 1 << lo)
    return (
        lambda: view[:, rows, high, lanes].reshape(2, -1),
        "one advanced-indexing call x.view(2, 2^M, H, 2^K, 2^lo)[:, T, arange(H), arange(2^K)] (out of place)",
    )


def strip_case(planar, C: int, a: int, M: int, controls, full: bool = True, reps: int = 10) -> dict:
    """One run at `controls` (A_k = a^(2^control) mod C, the Shor ladder's
    multipliers) on `planar`: the strip pass held exactly against the plain
    version and timed, beside the walks one by one; with `full`, also the
    plain version, the library call (held exactly too) and the bound.
    Returns the numbers (ms)."""
    import torch

    from quantumcomputer_tpu_torch.ops import gates as tops
    from quantumcomputer_tpu_torch.ops import oracle
    from quantumcomputer_tpu_torch.scripts import exact_err
    from quantumcomputer_tpu_torch.utils.profiling import cuda_ms

    A_list = tuple(pow(a, 1 << c, C) for c in controls)
    want = tops.apply_camodc_ladder_high_planes_(planar.clone(), C, A_list, controls, M)
    out = {"controls": list(controls), "dtype": str(planar.dtype).replace("torch.", "")}
    out["strip_bytes"] = oracle.strip_bytes(C, oracle.strip_room(planar.device))
    work = planar.clone()
    oracle.apply_camodc_run_inplace_planar(work, C, A_list, controls, M)
    err = exact_err(work, want)
    if err != 0.0:
        raise AssertionError(f"the strip pass at controls {controls} differs by {err}")
    out["ms"] = cuda_ms(lambda: oracle.apply_camodc_run_inplace_planar(work, C, A_list, controls, M), reps)
    out["walk_ms"] = [
        cuda_ms(lambda: oracle.apply_camodc_high_cycle_planar(work, C, A, c, M), 5) for c, A in zip(controls, A_list)
    ]
    out["walks_sum_ms"] = sum(out["walk_ms"])
    if full:
        out["plain_ms"] = cuda_ms(lambda: tops.apply_camodc_ladder_high_planes_(work, C, A_list, controls, M), 2)
        call, out["library"] = library_row_gather(planar, C, A_list, controls, M)
        err = exact_err(call(), want)
        if err != 0.0:
            raise AssertionError(f"the library call at controls {controls} differs by {err}")
        out["library_ms"] = cuda_ms(call, 3)
        out["bound_ms"] = 1e3 * moved_bytes(planar, C, M, len(controls)) / HBM_BYTES_PER_S
        out["share"] = out["bound_ms"] / out["ms"]
    del work, want
    torch.cuda.empty_cache()
    return out


def flagship_ms(reps: int = 3) -> dict:
    """The complex32 m_high flagship through the engine: ms a run with two
    states' memory and below it, and the launch counts of one run of each."""
    import torch

    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer_tpu_torch.ops import oracle
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
    from quantumcomputer_tpu_torch.utils.profiling import cuda_ms

    C, a, L, M = FLAGSHIP
    circuit = shor_circuit_mhigh(C, a, L, M)
    out = {}
    for form, budget in (("two states", None), ("below two states", 3 * (2 * (1 << (L + M)) * 2) // 2)):
        if budget is not None:
            os.environ["QC_TPU_HBM_BYTES"] = str(budget)
        try:
            eng = StateVectorEngine(Register(L=L, M=M), "complex32", device="cuda", layout="m_high")
            out[form] = cuda_ms(lambda: eng.run(circuit), reps)
            for k in oracle.LAUNCHES:
                oracle.LAUNCHES[k] = 0
            eng.run(circuit)
            torch.cuda.synchronize()
            out[form + " launches"] = dict(oracle.LAUNCHES)
        finally:
            os.environ.pop("QC_TPU_HBM_BYTES", None)
        del eng
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    help="the checkout whose quantumcomputer_tpu_torch is timed (default: this one)")
    ap.add_argument("--flagship", action="store_true", help="time only the complex32 m_high flagship")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("prof_strip: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.flagship:
        r = flagship_ms()
        print(f"flagship complex32 m_high n={sum(FLAGSHIP[2:])} ({os.path.abspath(args.root)}): "
              f"{r['two states']:.3f} ms, below two states {r['below two states']:.3f} ms; oracle launches "
              f"{r['two states launches']}, below two states {r['below two states launches']}", flush=True)
    else:
        from quantumcomputer_tpu_torch.ops import oracle

        for label, dtype, C, a, M, controls in CASES:
            gen = torch.Generator(device="cuda").manual_seed(M)
            planar = torch.randn((2, 1 << N), generator=gen, device="cuda").to(getattr(torch, dtype))
            r = strip_case(planar, C, a, M, controls)
            del planar
            torch.cuda.empty_cache()
            print(f"strip n={N} {label} ({dtype}, C={C}, M={M}, K={len(controls)}, {r['strip_bytes']}-byte strips): "
                  f"{r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms, {r['share']:.1%} of bound; plain "
                  f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms; walks "
                  f"{[round(w, 4) for w in r['walk_ms']]}, sum {r['walks_sum_ms']:.4f} ms", flush=True)
        planar = torch.randn((2, 1 << N), generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
        planar = planar.to(torch.bfloat16)
        for C, a, M, controls in CROSSOVER:
            r = strip_case(planar, C, a, M, controls, full=False)
            print(f"crossover n={N} bfloat16 C={C} M={M} controls {controls}: strip {r['ms']:.4f} ms, walks "
                  f"{[round(w, 4) for w in r['walk_ms']]}, sum {r['walks_sum_ms']:.4f} ms; merge rule "
                  f"{oracle.strip_pays(controls, C, 2, oracle.strip_room(planar.device))}", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
