"""Times of the QAOA MaxCut step (variational.qaoa_step) on the card: the
whole step, its spans, its heaviest kernels and its peak, for comparing
checkouts and for finding what holds the step.

    python quantumcomputer_tpu_torch/scripts/prof_qaoa.py [--n 30] [--p 4] [--dtype complex64] [--check]

A seeded 3-regular graph on n vertices (variational.random_regular_graph,
seed 2021), seeded angles; CUDA events around 3 steps after one warm-up
step; then one step with the program's spans on (device ms by span name)
and one under torch.profiler (device ms by kernel).  --check first runs the
card-only QAOA checks (utils/kernel_checks.qaoa_kernels, qaoa_adjoint).
Prints the card's name and power limit, one line a part and a JSON line of
every number.  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=30)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--dtype", default="complex64", choices=("complex64", "complex128", "complex32"))
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    import torch

    if not torch.cuda.is_available():
        print("prof_qaoa: needs a CUDA card", file=sys.stderr)
        return 1
    from quantumcomputer_tpu_torch.algorithms import variational
    from quantumcomputer_tpu_torch.ops import qaoa
    from quantumcomputer_tpu_torch.utils import kernel_checks, profiling

    print(card(), flush=True)
    out = {"card": card(), "n": args.n, "p": args.p, "dtype": args.dtype}
    if args.check:
        for fn in (kernel_checks.qaoa_kernels, kernel_checks.qaoa_adjoint):
            t0 = time.perf_counter()
            for line in fn(torch.device("cuda")):
                print(line, flush=True)
            print(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    dtype = {"complex64": torch.complex64, "complex128": torch.complex128}.get(args.dtype, args.dtype)
    t0 = time.perf_counter()
    eng = variational.qaoa_engine(args.n, dtype=dtype, device="cuda")
    table = qaoa.CostTable(args.n, variational.random_regular_graph(args.n, 3, 2021), "cuda")
    torch.cuda.synchronize()
    out["table_s"] = time.perf_counter() - t0
    angles = variational.qaoa_initial_parameters(args.p, 7).numpy()
    variational.qaoa_step(eng, table, angles)
    torch.cuda.reset_peak_memory_stats()
    out["step_ms"] = profiling.cuda_ms(lambda: variational.qaoa_step(eng, table, angles), reps=3)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"step {out['step_ms']:.2f} ms, peak {out['peak_gib']:.3f} GiB, table {out['table_s']:.2f} s", flush=True)

    profiling.record_spans(True)
    profiling.span_records(clear=True)
    t0 = time.perf_counter()
    variational.qaoa_step(eng, table, angles)
    host = 1e3 * (time.perf_counter() - t0)
    recs = profiling.span_records(clear=True)
    profiling.record_spans(False)
    spans = {}
    for r in recs:
        s = spans.setdefault(r.name, {"count": 0, "device_ms": 0.0, "host_ms": 0.0})
        s["count"] += 1
        s["device_ms"] += r.device_ms or 0.0
        s["host_ms"] += r.host_ms
    out["spans"], out["spans_step_host_ms"] = spans, host
    for name, s in sorted(spans.items(), key=lambda kv: -kv[1]["device_ms"]):
        print(f"span {name}: {s['count']} x, device {s['device_ms']:.2f} ms, host {s['host_ms']:.2f} ms", flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        variational.qaoa_step(eng, table, angles)
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0.0)
        if dev > 0 and e.count > 0 and not e.key.startswith(("aten::", "qc.", "cuda")):
            kernels.append((e.key[:90], e.count, dev / 1e3))
    kernels.sort(key=lambda k: -k[2])
    out["kernels"] = kernels[:15]
    for k in kernels[:15]:
        print(f"kernel {k[0]}: {k[1]} x, {k[2]:.2f} ms", flush=True)
    out["launches"] = dict(qaoa.LAUNCHES)
    print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
