"""The control below bf16 storage, for the complex32 cells: the cell's own
path with every plan entry's output rounded to nearest, ties to even, at
BF16_MANTISSA - drop explicit mantissa bits (4 at the default drop of 3:
bf16's exponent range, 8x its rounding step).  A complex32 cell has no
lower precision in the program (``control.py`` runs complex32, the
complex64 cells' control), and torch's float8 types cannot stand in: an
amplitude of a 2^31 state lies near 2^-15.5, below e4m3's smallest normal.
It has to come out not correct.  The benchmark's own runs never run it.

    python3 portbench/control_sub_bf16.py --workload NAME --seeds 1,2,3 --seconds S [--drop 3]

While it runs, the three calls through which ``engine.apply_circuit_fused_``
writes each plan entry's output (``fused.apply_fused``,
``oracle.apply_camodc_run_inplace_planar`` and ``engine.apply_gate_planes_``)
are wrapped, and then ``control.readings`` reads the cell at complex32.
Nothing of the program is edited.  Prints one JSON line a run and, last,
a JSON summary with the smallest and largest reading of each number.
Needs a CUDA card (exit 3 without one).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Explicit mantissa bits of bf16, and those the control rounds away.
BF16_MANTISSA = 7
DROP = 3
#: Elements rounded at a time: the rounding's int16 temporary stays 128 MiB.
CHUNK = 1 << 26


def round_mantissa_(planes, drop: int = DROP):
    """Round every element of bf16 `planes` in place to nearest, ties to
    even, at BF16_MANTISSA - drop explicit mantissa bits: on the bit
    pattern, add half a step less one plus the kept part's lowest bit, then
    clear the dropped bits (a carry into the exponent is the rounding up to
    the next power of two).  Returns `planes`."""
    import torch

    if planes.dtype != torch.bfloat16:
        raise TypeError(f"the control rounds bf16 planes, not {planes.dtype}")
    if not 1 <= drop < BF16_MANTISSA:
        raise ValueError(f"drop must lie in 1..{BF16_MANTISSA - 1}, got {drop}")
    bits = planes.view(torch.int16).view(-1)
    for lo in range(0, bits.numel(), CHUNK):
        b = bits[lo : lo + CHUNK]
        b.add_(((b >> drop) & 1) + ((1 << (drop - 1)) - 1))
        b.bitwise_and_(-(1 << drop))
    return planes


@contextlib.contextmanager
def below_bf16(drop: int = DROP):
    """Inside: each plan entry that engine.apply_circuit_fused_ applies
    leaves its planes rounded by round_mantissa_."""
    from quantumcomputer_tpu_torch.ops import fused, oracle
    from quantumcomputer_tpu_torch.sim import engine

    sites = [(fused, "apply_fused"), (oracle, "apply_camodc_run_inplace_planar"), (engine, "apply_gate_planes_")]
    saved = [getattr(mod, name) for mod, name in sites]

    def rounded(fn):
        def call(planar, *args, **kwargs):
            return round_mantissa_(fn(planar, *args, **kwargs), drop)

        return call

    for (mod, name), fn in zip(sites, saved):
        setattr(mod, name, rounded(fn))
    try:
        yield
    finally:
        for (mod, name), fn in zip(sites, saved):
            setattr(mod, name, fn)


def readings(workload: str, seeds, seconds: float, drop: int = DROP, device: str = "cuda", config=None) -> list:
    """control.readings of the cell at complex32 below_bf16(drop)."""
    from portbench import control

    with below_bf16(drop):
        return control.readings(workload, seeds, seconds, ["complex32"], device=device, config=config)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--drop", type=int, default=DROP, help="mantissa bits of bf16 rounded away")
    args = ap.parse_args(argv)
    sys.path.insert(0, CHECKOUT)
    import torch

    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA card", file=sys.stderr)
        return 3
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds, args.drop)
    summary = {"runs": len(rows), "correct": sum(bool(r["correct"]) for r in rows), "max": {}, "min": {}}
    for row in rows:
        for k, v in row["checks"].items():
            summary["max"][k] = max(summary["max"].get(k, v), v)
            summary["min"][k] = min(summary["min"].get(k, v), v)
    mantissa = BF16_MANTISSA - args.drop
    print(json.dumps({"summary": summary, "mantissa_bits": mantissa, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
