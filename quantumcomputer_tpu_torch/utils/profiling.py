"""Profiling and observability: cost model, timing, phase profile, traces
and the norm trace.

The counterpart of the JAX package's ``utils/profiling.py``.  The analytic
cost model (bytes moved per gate pass, roofline bound) is carried over as
it is.  Timing differs: PyTorch returns before the card finishes, so a CUDA
engine is timed with CUDA events on the current stream, and a CPU engine
with the host clock.  ``trace`` wraps ``torch.profiler``.  The JAX
package reads a mesh program's collectives from its lowered StableHLO;
here the sharded engine's transport counts them as they run
(``mesh_collective_report``).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from quantumcomputer_tpu_torch.models.circuit import Circuit
from quantumcomputer_tpu_torch.sim import statevec as sv
from quantumcomputer_tpu_torch.utils.logging import get_logger


@dataclass
class GateCost:
    gate: str
    qubits: Tuple[int, ...]
    bytes_moved: int  # device-memory traffic of one pass (read + write)


def bytes_per_state(n: int, real_dtype_bytes: int = 4) -> int:
    """Planar state footprint: 2 planes x 2^n x itemsize."""
    return 2 * (1 << n) * real_dtype_bytes


def circuit_cost(circuit: Circuit, n: int, real_dtype_bytes: int = 4) -> List[GateCost]:
    """Analytic traffic per gate: every dense/diagonal/permutation pass reads
    and writes the full state once (the fused-kernel design goal)."""
    sb = bytes_per_state(n, real_dtype_bytes)
    return [GateCost(g.name, g.qubits, 2 * sb) for g in circuit]


def roofline_seconds(circuit: Circuit, n: int, hbm_gbps: float, real_dtype_bytes: int = 4) -> float:
    """Lower bound on circuit wall-clock from memory bandwidth alone."""
    total = sum(c.bytes_moved for c in circuit_cost(circuit, n, real_dtype_bytes))
    return total / (hbm_gbps * 1e9)


def force_completion(state: torch.Tensor) -> float:
    """Wait for the state's device, then return its norm (a sanity check
    that also consumes the result)."""
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)
    return float(sv.norm(state))


def device_seconds(device, fn) -> float:
    """Seconds that fn() takes: CUDA events on the current stream around it
    for a CUDA device (the end event waits for the work fn enqueued), the
    host clock otherwise (CPU ops finish before they return)."""
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds per call of fn() on the current CUDA stream: CUDA
    events around `reps` calls, after one warm-up call that has finished."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_circuit(engine, circuit: Circuit, iters: int = 3, state: Optional[torch.Tensor] = None) -> float:
    """Best of `iters` timed runs of the circuit on the engine, after one
    warm-up run.  A caller-supplied `state` is consumed, as engine.run
    consumes it."""
    if state is None:
        state = engine.initial_state()
    state = engine.run(circuit, state)
    force_completion(state)  # warm-up
    best = float("inf")
    for _ in range(iters):
        best = min(best, device_seconds(engine.device, lambda: engine.run(circuit, state)))
    return best


def time_circuit_folded(engine, circuit: Circuit, iters: int = 3) -> float:
    """Best of `iters` timed reset -> circuit -> norm runs
    (engine.run_norm), after one warm-up run: no state crosses the call."""
    engine.run_norm(circuit)  # warm-up
    best = float("inf")
    for _ in range(iters):
        best = min(best, device_seconds(engine.device, lambda: engine.run_norm(circuit)))
    return best


@dataclass
class PhaseTiming:
    label: str
    n_gates: int
    seconds: float


def phase_profile(engine, phases, iters: int = 3) -> List[PhaseTiming]:
    """Time breakdown of a circuit by named phase (e.g. H layer / oracle
    ladder / iQFT).  `phases` is a sequence of (label, gates).  Cumulative
    prefixes are timed and differenced, so fixed overheads cancel and each
    number is the MARGINAL cost of its phase on the engine's real execution
    path (fusion across phase boundaries is preserved)."""
    base = time_circuit(engine, (), iters=iters)
    out: List[PhaseTiming] = []
    prefix: list = []
    prev = base
    for label, gates in phases:
        gates = tuple(gates)  # before extend: a one-shot iterable would be spent
        prefix.extend(gates)
        t = time_circuit(engine, tuple(prefix), iters=iters)
        out.append(PhaseTiming(label, len(gates), max(t - prev, 0.0)))
        prev = t
    return out


@contextlib.contextmanager
def trace(path: str):
    """torch.profiler around the body (CPU, and the card when one is
    present); the trace is written to `path` as a Chrome trace.

    A profiler that cannot start (one is already active: a nested session
    would end the outer one and crash the process when it stops) degrades
    to running the body untraced, LOUDLY, through a logged warning: a
    silently missing trace is worse than no wrapper."""
    from torch.profiler import ProfilerActivity, profile

    log = get_logger("profiling")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=activities)
    started = False
    if torch.autograd._profiler_enabled():
        log.warning("a torch profiler is already active; the body runs untraced (no trace at %r)", path)
    else:
        try:
            prof.start()
            started = True
        except RuntimeError as e:
            log.warning("torch.profiler failed to start: %s; the body runs untraced", e)
    try:
        yield
    finally:
        if started:
            prof.stop()
            prof.export_chrome_trace(path)


@dataclass
class NormTrace:
    """Probability-conservation regression (Report §IV.A / FIG. 2): norm
    deviations from 1.0 after each step."""

    deviations: List[float]

    @property
    def max_deviation(self) -> float:
        return max((abs(d) for d in self.deviations), default=0.0)

    def to_dict(self) -> dict:
        return {"max_deviation": self.max_deviation, "deviations": self.deviations}


def norm_trace(engine, circuit: Circuit) -> NormTrace:
    """Run with norm tracking (the FIG. 2 experiment)."""
    _, norms = engine.run_with_norms(circuit)
    return NormTrace(deviations=[float(v) - 1.0 for v in norms.tolist()])


def mesh_collective_report(engine, circuit: Circuit) -> dict:
    """The exchanges of one ``engine.run(circuit)`` from the reset on a
    sharded engine (parallel/sharded.py), read from its transport's
    counters (parallel/comm.py) in place of the JAX package's StableHLO
    parse: ``{kind: {"count", "bytes"}, "total_bytes": N, "shards": D}``,
    bytes per shard (what a shard sends to other shards, averaged over the
    shards), as the JAX report counts each device's operands.  Unlike the
    JAX report it runs the circuit once.  complex32 moves half the bytes of
    complex64.  On a mesh over several processes every process calls it
    and gets the same report: the bytes are summed over the processes
    (the transport's world_stats)."""
    comm = getattr(engine, "comm", None)
    if comm is None:
        raise ValueError("mesh_collective_report needs a sharded engine (no mesh found)")
    comm.reset()
    engine.run(circuit)
    D = comm.size
    stats = comm.world_stats()
    report: dict = {kind: {"count": v["count"], "bytes": v["bytes"] // D} for kind, v in stats.items() if v["count"]}
    report["total_bytes"] = sum(v["bytes"] for v in stats.values()) // D
    report["shards"] = D
    return report
