"""The control's readings for a cell's limits: the numbers the comparison
gives for the program with its lower-precision path on (complex32: bf16
planes and work states, the nearest precision below the configurations'
complex64), at the cell's own size, on several seeds, in one process.  It
has to come out not correct.  The benchmark's own runs never run it.

    python3 portbench/control.py --workload NAME --seeds 1,2,3 --seconds S

Prints one JSON line a run ({"precision", "seed", "correct", "checks"})
and, last, a JSON summary with the smallest and largest reading of each
number.  The program's own readings come from its runs (run.py prints
them).  Needs a CUDA card (exit 3 without one).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The program's lower-precision path: bf16 planes and work states.
CONTROL = "complex32"


def readings(workload: str, seeds, seconds: float, precisions, device: str = "cuda", config=None) -> list:
    """One core.run a (precision, seed), untraced; returns the result lines."""
    from portbench import core

    out = []
    for prec in precisions:
        for seed in seeds:
            cfg = dict(config or {}, precision=prec)
            r = core.run(workload, seed, seconds, False, time.perf_counter(), device=device, overrides={"config": cfg})
            row = {"precision": prec, "seed": seed, "correct": r["correct"], "attempted": r["attempted"],
                   "checks": {k: v["value"] for k, v in r["checks"].items()}}
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, CHECKOUT)
    import torch

    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA card", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = readings(args.workload, seeds, args.seconds, [CONTROL])
    summary = {}
    for row in rows:
        s = summary.setdefault(row["precision"], {"runs": 0, "correct": 0, "max": {}, "min": {}})
        s["runs"] += 1
        s["correct"] += bool(row["correct"])
        for k, v in row["checks"].items():
            s["max"][k] = max(s["max"].get(k, v), v)
            s["min"][k] = min(s["min"].get(k, v), v)
    print(json.dumps({"summary": summary, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
