"""The n = 28 flagship on the sharded engine against the single card, on
the card: times in turns and where a sharded run's time goes.

The flagship is C = 8191, a = 3, L = 15, M = 13 in four forms (standard and
m_high layouts, complex64 and complex32).  The sharded engine runs SHARDS
shards on cuda:0 (parallel/mesh.build_mesh with the card repeated).  For
each form: the single-card run and the sharded run timed in turns (single,
sharded, sharded, single; CUDA events around REPS calls after a warm-up,
utils/profiling.cuda_ms); then torch.profiler over one sharded run: the
device's busy share (the union of its kernels' intervals over the wall
time), the device time of the heaviest kernels by name, the host time of
the heaviest host-side calls (self CPU time, runtime API calls included)
and the caching allocator's device allocations and frees in that run.

    python quantumcomputer_tpu_torch/scripts/prof_sharded.py [--top N]

Prints the card's name and power limit first, then one line a form and one
JSON line of all the numbers.  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

FLAGSHIP = (8191, 3, 15, 13)  # C, a, L, M
FORMS = (("standard", "complex64"), ("m_high", "complex64"), ("standard", "complex32"), ("m_high", "complex32"))
SHARDS = 4
REPS = 3


def profile_run(fn, top: int) -> dict:
    """torch.profiler over one call of fn: busy share and the `top` kernels
    by device time (ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    device_us, end = 0.0, float("-inf")
    for a, b in spans:
        device_us += max(0.0, b - max(a, end))
        end = max(end, b)
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    heaviest = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(prof.key_averages(), key=lambda ev: -ev.self_cpu_time_total)[:top]
    after = torch.cuda.memory_stats()
    allocator = {k: after.get(k, 0) - before.get(k, 0) for k in ("num_device_alloc", "num_device_free", "num_alloc_retries")}
    return {"wall_ms": wall_us / 1e3, "busy_share": device_us / wall_us if spans else None,
            "kernels_ms": {name[:80]: ms for name, ms in heaviest},
            "host_ms": {ev.key[:60]: ev.self_cpu_time_total / 1e3 for ev in host}, "allocator": allocator}


def form_numbers(layout: str, dtype: str, top: int) -> dict:
    import torch

    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
    from quantumcomputer_tpu_torch.parallel.mesh import build_mesh
    from quantumcomputer_tpu_torch.parallel.sharded import ShardedStateVectorEngine
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
    from quantumcomputer_tpu_torch.utils.profiling import cuda_ms

    C, a, L, M = FLAGSHIP
    circuit = (shor_circuit_mhigh if layout == "m_high" else shor_circuit)(C, a, L, M)
    cdtype = torch.complex64 if dtype == "complex64" else dtype
    single = StateVectorEngine(Register(L=L, M=M), cdtype, backend="cuda", layout=layout)
    mesh = build_mesh(devices=[torch.device("cuda", 0)] * SHARDS)
    sharded = ShardedStateVectorEngine(Register(L=L, M=M), cdtype, mesh=mesh, backend="cuda", layout=layout)
    turns = {"single": [], "sharded": []}
    for name in ("single", "sharded", "sharded", "single"):
        eng = single if name == "single" else sharded
        turns[name].append(cuda_ms(lambda: eng.run(circuit), REPS))
    out = {"ms": turns, "profile": profile_run(lambda: sharded.run(circuit), top)}
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--top", type=int, default=8, help="kernels listed by device time")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("prof_sharded: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    numbers = {}
    for layout, dtype in FORMS:
        key = f"{layout} {dtype}"
        numbers[key] = form_numbers(layout, dtype, args.top)
        prof = numbers[key]["profile"]
        print(f"flagship n={sum(FLAGSHIP[2:])} {key} on {SHARDS} shards: turns {numbers[key]['ms']}; one run traced "
              f"{prof['wall_ms']:.3f} ms wall, busy {prof['busy_share']}; heaviest kernels {prof['kernels_ms']}; "
              f"host {prof['host_ms']}; allocator {prof['allocator']}", flush=True)
    print(json.dumps({"card": card, "shards": SHARDS, "forms": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
