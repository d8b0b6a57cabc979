"""Times of the strip pass (csrc/oracle_strip.cu) on the card, beside the
plan entries it replaces (cycle walks and out-of-place ladders), and of the
complex32 m_high flagship that merges them, for comparing checkouts.

On states of unit-variance components, CUDA events: a run of adjacent plan
entries through the strip pass, at n = 28 held exactly against its plain
version; beside it the same entries one by one (each walk through the cycle
walk, each ladder out of place into a second state), and for the ``CASES``
the plain version, one PyTorch call computing the same function
(``library_row_gather``) and the bound (the moved bytes read once and
written once over 3.35 TB/s).  ``CASES`` (n = 28): the complex32 plan's
walks (controls 0-11 at C = 8191, M = 13, 16-byte strips), the same run at
M = 12 (C = 4093, where 32-byte strips fit), the complex64 plan's oracle
stage (walks 0-10 and the ladder 11-14) through the float32 instance, and
lone gates at controls 0 and 3 (K = 1) at bf16.  ``CROSSOVER``: short runs
at low, middle and high controls, walks and ladders, at bf16 and float32,
n = 28 and n = 32 (a 32 GiB complex64 state: timed in place, unchecked),
the pass beside the sum of its entries, which the engine's merge rule
(``oracle.strip_pays``) is read from.

    python quantumcomputer_tpu_torch/scripts/prof_strip.py [--flagship] [--root DIR] [--n 28,32]

--flagship times only the complex32 m_high flagship (C = 8191, a = 3,
L = 15, M = 13) through the engine, with two states' memory and below it
(``QC_TPU_HBM_BYTES``), and counts its launches; --root times the package
of another checkout (a parent commit unpacked with ``git archive``) in this
process, as prof_fused.py does, so a comparison in turns calls the script
once a turn; --n the register sizes of the crossover runs.  Prints the
card's name and power limit first and last.  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
N = 28
FLAGSHIP = (8191, 3, 15, 13)  # C, a, L, M
LADDER64 = (11, 12, 13, 14)  # the complex64 plan's ladder at n = 28
# (label, plane dtype name, C, a, M, entries: a control is a walk, a tuple a ladder)
CASES = (
    ("complex32 m_high plan walks", "bfloat16", 8191, 3, 13, tuple(range(12))),
    ("M=12 run, 32-byte strips", "bfloat16", 4093, 2, 12, tuple(range(12))),
    ("complex64 m_high plan oracle stage, float32 instance", "float32", 8191, 3, 13, (*range(11), LADDER64)),
    ("lone gate at control 0", "bfloat16", 8191, 3, 13, (0,)),
    ("lone gate at control 3", "bfloat16", 8191, 3, 13, (3,)),
)
_BF16_28 = ((0, 1), (0, 1, 2), (2, 3), (3, 4), (4, 5), (4, 5, 6), (6, 7), (6, 7, 8), (8, 9), (8, 9, 10), (8, 9, 10, 11),
            (11, 12), (11, 12, 13), (12, 13))
_F32 = ((0, 1), (0, 1, 2), (2, 3), (3, 4), (4, 5), (4, 5, 6), (6, 7), (8, 9), (8, 9, 10), (9, 10, LADDER64),
        (10, LADDER64), (*range(11), LADDER64))
# (plane dtype name, n, C, a, M, entries): short runs, the pass beside its entries.
CROSSOVER = (
    *(("bfloat16", 28, 8191, 3, 13, r) for r in _BF16_28),
    *(("bfloat16", 28, 4093, 2, 12, r) for r in ((0, 1), (3, 4), (4, 5), (6, 7), (8, 9), (8, 9, 10), (8, 9, 10, 11),
                                                  (11, 12))),
    *(("float32", 28, 8191, 3, 13, r) for r in _F32),
    *(("float32", 28, 4093, 2, 12, r) for r in ((0, 1), (3, 4), (8, 9), (8, 9, 10), tuple(range(12)))),
    *(("float32", 32, 8191, 3, 13, r) for r in (*_F32[:-1], (*range(11), tuple(range(11, 19))))),
    *(("float32", 32, 4093, 2, 12, r) for r in ((0, 1), (8, 9), tuple(range(12)))),
    *(("bfloat16", 32, 8191, 3, 13, r) for r in ((0, 1), (4, 5), (8, 9), (8, 9, 10, 11), (*range(12), tuple(range(12, 19))))),
    *(("bfloat16", 32, 4093, 2, 12, r) for r in ((0, 1), (8, 9), tuple(range(12)))),
)


def _entries(entries) -> tuple:
    """Entries as tuples of controls: a bare control is a walk."""
    return tuple((e,) if isinstance(e, int) else tuple(e) for e in entries)


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


def strip_case(planar, C: int, a: int, M: int, entries, full: bool = True, reps: int = 10, check: bool = True) -> dict:
    """One run of plan `entries` (a control is a walk, a tuple of controls
    a ladder; A_k = a^(2^control) mod C, the Shor ladder's multipliers) on
    `planar`: the strip pass, with `check` held exactly against the plain
    version on a copy (else timed in place on `planar`, for states too large
    for a copy), timed beside the entries one by one (a ladder out of place
    into a second state); with `full`, also the plain version, the library
    call where the run's controls are contiguous (held exactly too) and the
    bound.  Returns the numbers (ms)."""
    import torch

    from quantumcomputer_tpu_torch.ops import gates as tops
    from quantumcomputer_tpu_torch.ops import oracle
    from quantumcomputer_tpu_torch.scripts import exact_err
    from quantumcomputer_tpu_torch.utils.profiling import cuda_ms

    entries = _entries(entries)
    controls = tuple(c for e in entries for c in e)
    A_list = tuple(pow(a, 1 << c, C) for c in controls)
    n = planar.shape[1].bit_length() - 1
    out = {"entries": [list(e) for e in entries], "dtype": str(planar.dtype).replace("torch.", ""), "n": n}
    out["strip_bytes"] = oracle.strip_bytes(C, oracle.strip_room(planar.device))
    work = planar
    if check:
        want = tops.apply_camodc_ladder_high_planes_(planar.clone(), C, A_list, controls, M)
        work = planar.clone()
        oracle.apply_camodc_run_inplace_planar(work, C, A_list, controls, M)
        err = exact_err(work, want)
        if err != 0.0:
            raise AssertionError(f"the strip pass at {entries} differs by {err}")
    out["ms"] = cuda_ms(lambda: oracle.apply_camodc_run_inplace_planar(work, C, A_list, controls, M), reps)
    spare = torch.empty_like(work) if any(len(e) > 1 for e in entries) else None
    out["entry_ms"] = []
    for e in entries:
        A_e = tuple(pow(a, 1 << c, C) for c in e)
        if len(e) == 1:
            fn = lambda: oracle.apply_camodc_high_cycle_planar(work, C, A_e[0], e[0], M)  # noqa: E731
        else:
            fn = lambda: oracle.apply_camodc_ladder_high_planar(work, spare, C, A_e, e, M)  # noqa: E731
        out["entry_ms"].append(cuda_ms(fn, 5))
    out["entries_sum_ms"] = sum(out["entry_ms"])
    del spare
    if full:
        out["plain_ms"] = cuda_ms(lambda: tops.apply_camodc_ladder_high_planes_(work, C, A_list, controls, M), 2)
        if controls == tuple(range(min(controls), min(controls) + len(controls))):
            call, out["library"] = library_row_gather(planar, C, A_list, controls, M)
            err = exact_err(call(), want)
            if err != 0.0:
                raise AssertionError(f"the library call at controls {controls} differs by {err}")
            out["library_ms"] = cuda_ms(call, 3)
        out["bound_ms"] = 1e3 * moved_bytes(planar, C, M, len(controls)) / HBM_BYTES_PER_S
        out["share"] = out["bound_ms"] / out["ms"]
    if check:
        del want
    del work
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
    ap.add_argument("--n", default="28,32", help="register sizes of the crossover runs (comma-separated)")
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

        for label, dtype, C, a, M, entries in CASES:
            gen = torch.Generator(device="cuda").manual_seed(M)
            planar = torch.randn((2, 1 << N), generator=gen, device="cuda").to(getattr(torch, dtype))
            r = strip_case(planar, C, a, M, entries)
            del planar
            torch.cuda.empty_cache()
            library = f", library {r['library_ms']:.4f} ms" if "library_ms" in r else ""
            print(f"strip n={N} {label} ({dtype}, C={C}, M={M}, K={sum(map(len, _entries(entries)))}, "
                  f"{r['strip_bytes']}-byte strips): {r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms, "
                  f"{r['share']:.1%} of bound; plain {r['plain_ms']:.4f} ms{library}; entries "
                  f"{[round(w, 4) for w in r['entry_ms']]}, sum {r['entries_sum_ms']:.4f} ms", flush=True)
        sizes = {int(v) for v in args.n.split(",")}
        planes = {}
        for dtype, n, C, a, M, entries in CROSSOVER:
            if n not in sizes:
                continue
            if (dtype, n) not in planes:
                planes.clear()
                torch.cuda.empty_cache()
                planar = torch.empty((2, 1 << n), dtype=getattr(torch, dtype), device="cuda")
                planar.normal_(generator=torch.Generator(device="cuda").manual_seed(0))
                planes[dtype, n] = planar
            planar = planes[dtype, n]
            itemsize = planar.element_size()
            r = strip_case(planar, C, a, M, entries, full=False, check=n <= N)
            print(f"crossover n={n} {dtype} C={C} M={M} entries {r['entries']}: strip {r['ms']:.4f} ms, entries "
                  f"{[round(w, 4) for w in r['entry_ms']]}, sum {r['entries_sum_ms']:.4f} ms; merge rule "
                  f"{oracle.strip_pays(_entries(entries), C, itemsize, oracle.strip_room(planar.device), n)}",
                  flush=True)
        planes.clear()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
