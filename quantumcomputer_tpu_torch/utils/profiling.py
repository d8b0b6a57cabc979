"""Profiling and observability: spans, timing, traces and the norm trace.

The counterpart of the JAX package's ``utils/profiling.py``.  Timing
differs: PyTorch returns before the card finishes, so a CUDA engine is
timed with CUDA events on the current stream, and a CPU engine with the
host clock.  ``trace`` wraps ``torch.profiler``.  The JAX package reads a
mesh program's collectives from its lowered StableHLO; here the sharded
engine's transport counts them as they run (``mesh_collective_report``).

Spans (``span``) mark the layer boundaries of the single-card paths: the
Shor attempt, the engine's run and plan, each fused segment and oracle
gate, the oracle tables, the measurement and the semiclassical step's
parts.  They are off by default, and then cost one check a span.  They
record while torch.profiler records (so ``trace`` shows each as
a ``qc.<name>`` range beside the kernels it launched, on the same clock)
and after ``record_spans(True)``; ``span_records`` and ``span_summary``
read what they recorded.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch.autograd import _profiler_enabled

from quantumcomputer_tpu_torch.models.circuit import Circuit
from quantumcomputer_tpu_torch.sim import statevec as sv
from quantumcomputer_tpu_torch.utils.logging import get_logger

# -- spans ---------------------------------------------------------------------------

#: Span records kept in memory; later spans are dropped and counted.
MAX_SPANS = 1 << 16

_NO_SPAN = contextlib.nullcontext()
_recording = False
_records: List["SpanRecord"] = []
_dropped = 0
_ids = itertools.count()
_local = threading.local()  # per thread: the stack of open spans
_events: Dict[torch.device, list] = {}  # CUDA events to reuse, per device


class SpanRecord:
    """One closed span: its `name` (without the ``qc.`` prefix), `id`,
    `parent` id (None for a root) and `root` id (its own for a root), its
    host start and end (``time.perf_counter_ns``), `device_ms` (between two
    CUDA events on the device's current stream; None for work off the
    card) and its integer `counts`."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns", "device_ms", "counts", "_events")

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class _Span:
    """An open span: the host clock, a profiler range ``qc.<name>`` while a
    profiler records and, on a CUDA device, two events on the stream current
    at its start (looked up once: the lookup costs as much as a record)."""

    __slots__ = ("rec", "device", "range", "stream")

    def __init__(self, name: str, device, counts: dict):
        rec = SpanRecord()
        rec.name, rec.counts, rec.device_ms, rec._events = name, counts, None, None
        self.rec = rec
        self.device = device
        self.range = None

    def __enter__(self):
        rec = self.rec
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec.id = next(_ids)
        rec.parent = stack[-1].id if stack else None
        rec.root = stack[0].id if stack else rec.id
        stack.append(rec)
        if _profiler_enabled():
            self.range = torch.profiler.record_function("qc." + rec.name)
            self.range.__enter__()
        if self.device is not None:
            pool = _events.setdefault(self.device, [])
            start, end = (pool.pop() if pool else torch.cuda.Event(enable_timing=True) for _ in range(2))
            self.stream = torch.cuda.current_stream(self.device)
            start.record(self.stream)
            rec._events = (self.device, start, end)
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        global _dropped
        rec = self.rec
        rec.end_ns = time.perf_counter_ns()
        if rec._events is not None:
            rec._events[2].record(self.stream)
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        if len(_records) < MAX_SPANS:
            _records.append(rec)
        else:
            _dropped += 1
            if rec._events is not None:
                _events[self.device].extend(rec._events[1:])
                rec._events = None
        return False


def span(name: str, device=None, **counts):
    """A context manager around one layer's work, recorded while spans are
    on (torch.profiler records, or ``record_spans(True)``): its
    host clock, a ``qc.<name>`` range in the profiler's trace while one
    records, and its parent span; otherwise one shared no-op context, after
    one check.  `device`: the device the work runs on; on a CUDA device the
    span also times the work on the device's current stream.  `counts`:
    integers the span carries (gates applied, bytes copied, ...).  Entered,
    a recording span gives its SpanRecord, whose `counts` the body may add
    to (a count known only at the end); the no-op gives None."""
    if not (_recording or _profiler_enabled()):
        return _NO_SPAN
    device = torch.device(device) if device is not None else None
    return _Span(name, device if device is not None and device.type == "cuda" else None, counts)


def record_spans(on: bool) -> None:
    """Record spans without a profiler (on) or only while one records (off)."""
    global _recording
    _recording = bool(on)


def span_records(clear: bool = False) -> List[SpanRecord]:
    """The closed spans recorded so far, in the order they closed, with
    their device times resolved (one wait for each device they ran on).
    With `clear` the buffer and the dropped count start again."""
    global _dropped
    recs = list(_records)
    pending = [r for r in recs if r._events is not None]
    for dev in {r._events[0] for r in pending}:
        torch.cuda.synchronize(dev)
    for r in pending:
        dev, start, end = r._events
        r.device_ms = start.elapsed_time(end)
        r._events = None
        _events[dev].extend((start, end))
    if clear:
        _records.clear()
        _dropped = 0
    return recs


def dropped_spans() -> int:
    """Spans closed while the buffer held MAX_SPANS records (not kept)."""
    return _dropped


def span_summary(records) -> Dict[str, dict]:
    """Per span name: ``count``, total ``host_ms`` and total ``device_ms``
    (None where no span of the name ran on the card), in order of first
    appearance."""
    out: Dict[str, dict] = {}
    for r in records:
        s = out.setdefault(r.name, {"count": 0, "host_ms": 0.0, "device_ms": None})
        s["count"] += 1
        s["host_ms"] += r.host_ms
        if r.device_ms is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + r.device_ms
    return out


# -- timing ---------------------------------------------------------------------------


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
    if _profiler_enabled():
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
