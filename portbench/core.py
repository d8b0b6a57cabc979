"""The harness: finds a cell's files by name, runs its set-up, its measured
window and its traced slice, compares what the window produced with the
plain reference, and builds the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by name:

    configs/<config>.json        sizes, precision, source
    workloads/<cell>.json        configuration, traffic mix, run parameters, limits, why
    traffic/<mix>.json           the mix's generator and its parameters (data alone)
    generators/<generator>.py    setup(cell, seed) -> a runner (see full_register.py)
    metrics/<metric>.py          UNIT, MOVES, read(obs) -> value or None

A cell's parameters are its mix's, updated by its workload file's.  A later
cell, traffic mix, generator or metric is a new file; nothing here lists
names.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Modules the process that prints a result may not hold (whole top-level names).
FORBIDDEN = ("jax", "jaxlib", "flax", "quantumcomputer_tpu")


# -- files found by name ----------------------------------------------------------------


def names(sub: str, ext: str, root: str = ROOT) -> List[str]:
    d = os.path.join(root, sub)
    return sorted(f[: -len(ext)] for f in os.listdir(d) if f.endswith(ext) and not f.startswith("_"))


def load_json(sub: str, name: str, root: str = ROOT) -> dict:
    path = os.path.join(root, sub, name + ".json")
    if not os.path.isfile(path):
        raise KeyError(f"no {name!r} under {sub}/ (no {path})")
    with open(path) as f:
        return json.load(f)


def load_module(sub: str, name: str, root: str = ROOT):
    path = os.path.join(root, sub, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {sub[:-1]} module named {name!r} (no {path})")
    key = f"portbench_{sub}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def cell(workload: str, root: str = ROOT) -> dict:
    """A cell's workload file with its configuration merged in under
    "config" and its traffic mix's generator and parameters."""
    w = load_json("workloads", workload, root)
    w["name"] = workload
    w["config_name"] = w["config"]
    w["config"] = load_json("configs", w["config"], root)
    mix = load_json("traffic", w["traffic"], root)
    w["generator"] = mix["generator"]
    w["params"] = {**mix.get("params", {}), **w.get("params", {})}
    return w


def metric_modules(root: str = ROOT) -> Dict[str, object]:
    return {n: load_module("metrics", n, root) for n in names("metrics", ".py", root)}


def peaks(root: str = ROOT) -> dict:
    return load_json(".", "peaks", root)


# -- spans -------------------------------------------------------------------------------


class Spans:
    """Host-clock spans the benchmark records around its calls into the
    program's layers; with `annotate` each span is also a profiler range
    (named ``pb.<name>``) so the trace can tell which layer launched a kernel."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        if self.annotate:
            with torch.profiler.record_function("pb." + name):
                yield
        else:
            yield
        self.seconds[name].append(time.perf_counter() - t)


class NoSpans(Spans):
    @contextlib.contextmanager
    def span(self, name: str):
        yield


# -- the window --------------------------------------------------------------------------


class Attempt:
    __slots__ = ("i", "t0", "t1", "dev_ms", "out", "error", "whole")

    def __init__(self, i, t0, t1, dev_ms, out, error, whole):
        self.i, self.t0, self.t1, self.dev_ms, self.out, self.error, self.whole = i, t0, t1, dev_ms, out, error, whole


def run_attempts(runner, seconds: float, start: int, spans: Spans, on_cuda: bool, min_attempts: int = 0) -> tuple:
    """Closed loop: attempts start one after another until `seconds` have
    passed (and at least `min_attempts` ran); the last may end after the
    close.  Returns (attempts, window start).  An attempt's device-clock
    time comes from CUDA events recorded at its start and end."""
    attempts, events = [], []
    t_start = time.perf_counter()
    i = start
    while True:
        t0 = time.perf_counter()
        if t0 - t_start >= seconds and len(attempts) >= min_attempts:
            break
        e0 = e1 = None
        if on_cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        out, err = None, None
        try:
            with spans.span("attempt"):
                out = runner.attempt(i)
            err = runner.invalid(out)
        except Exception as e:  # an attempt that raises counts as failed; the loop goes on
            err = f"{type(e).__name__}: {e}"
        if on_cuda:
            e1.record()
        t1 = time.perf_counter()
        attempts.append(Attempt(i, t0, t1, None, out, err, t1 - t_start <= seconds))
        events.append((e0, e1))
        i += 1
    if on_cuda:
        torch.cuda.synchronize()
        for a, (e0, e1) in zip(attempts, events):
            a.dev_ms = e0.elapsed_time(e1)
    return attempts, t_start


def whole(attempts: List[Attempt]) -> List[Attempt]:
    return [a for a in attempts if a.whole and a.error is None]


def window_ms(attempts: List[Attempt], t_start: float, per: int = 1) -> Optional[float]:
    """Window start to the end of its last whole attempt, over the whole
    attempts (times `per` steps an attempt)."""
    w = whole(attempts)
    if not w:
        return None
    return 1e3 * (w[-1].t1 - t_start) / (len(w) * per)


def p95_ms(attempts: List[Attempt]) -> Optional[float]:
    """95th percentile (linear interpolation) of every whole attempt's time
    on the device clock."""
    xs = sorted(a.dev_ms for a in whole(attempts) if a.dev_ms is not None)
    if len(xs) < 20:
        return None
    pos = 0.95 * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_summary(attempts: List[Attempt]) -> dict:
    """Host-clock times of the whole attempts (median, slowest, and which),
    for reading a run that lies far off; no metric is taken from it."""
    w = whole(attempts)
    if not w:
        return {"whole": 0}
    ms = sorted((1e3 * (a.t1 - a.t0), a.i) for a in w)
    return {"whole": len(w), "median_ms": ms[len(ms) // 2][0], "max_ms": ms[-1][0], "max_at": ms[-1][1]}


# -- the trace ---------------------------------------------------------------------------


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Trace:
    """Device activity of a profiled slice, read from torch.profiler's
    chrome trace.  `ops`: (name, start_us, dur_us, span) for every kernel,
    copy and memset in the slice, `span` the innermost ``pb.*`` range whose
    host interval holds the launch (None outside any)."""

    def __init__(self, events: list):
        ann = [e for e in events if e.get("cat") == "user_annotation" and e.get("name", "").startswith("pb.")]
        box = [e for e in ann if e["name"] == "pb.slice"]
        if not box:
            raise ValueError("the trace has no pb.slice range")
        self.t0 = float(box[0]["ts"])
        self.t1 = self.t0 + float(box[0]["dur"])
        self.tid = box[0].get("tid")
        launches = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = float(e["ts"])
        spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][3:]) for e in ann if e.get("tid") == self.tid and e["name"] != "pb.slice"))
        self.ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if ts + dur < self.t0 or ts > self.t1 + 1e6:
                continue
            at = launches.get(e.get("args", {}).get("correlation"))
            self.ops.append((e["name"], ts, dur, None if at is None else innermost(spans, at)))
        self.ops.sort(key=lambda o: o[1])
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
            for e in events
            if e.get("cat") in HOST_CATS and e.get("tid") == self.tid and e.get("ph") == "X"
        )

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def intervals(self) -> List[tuple]:
        """Union of device activity, clipped to the slice, as (start, end) us."""
        out = []
        for _, ts, dur, _ in self.ops:
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) * 1e-6

    def device_seconds(self, pick: Callable[[str, Optional[str]], bool]) -> float:
        """Summed device time of the ops for which pick(name, span) holds."""
        return sum(dur for name, _, dur, span in self.ops if pick(name, span)) * 1e-6

    def top_ops(self, k: int = 10) -> list:
        tot = defaultdict(float)
        for name, _, dur, _ in self.ops:
            tot[short_name(name)] += dur * 1e-6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device time in the slice, summed by what the host was doing
        when the device went idle (its innermost range or op then)."""
        gaps, prev = [], self.t0
        for a, b in self.intervals():
            if a > prev:
                gaps.append((prev, a))
            prev = b
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        tot = defaultdict(float)
        for (a, b), name in zip(gaps, innermost_many(self.host, [g[0] for g in gaps])):
            tot[name or "host (no op)"] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def innermost(spans: List[tuple], t: float) -> Optional[str]:
    """Name of the innermost (latest-starting) interval that holds t."""
    best = None
    for a, b, name in spans:
        if a > t:
            break
        if a <= t < b:
            best = name
    return best


def innermost_many(intervals: List[tuple], times: List[float]) -> List[Optional[str]]:
    """innermost() for increasing `times` over nested intervals sorted by
    start, in one sweep."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(intervals) and intervals[j][0] <= t:
            stack.append(intervals[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        # Nested intervals: once the top holds t, every one below it does.
        out.append(stack[-1][2] if stack else None)
    return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list, `void ` and anonymous
    namespaces (``(anonymous namespace)::``), at most 100 characters."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            s = s[:i]
            break
    return s.strip()[:100]


def profile_slice(body: Callable[[], None]) -> Trace:
    """Run body() under torch.profiler (host and CUDA) inside a pb.slice
    range and read the trace back; the trace file lives in the temporary
    directory only while it is read."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("pb.slice"):
            body()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)


# -- observations for the per-layer metrics ---------------------------------------------


class Obs:
    """What a per-layer metric reads: the cell, the spans of the traced
    run's window, and the traced slice (its trace, the program's counters
    over it, and the runner's records of its attempts)."""

    def __init__(self, cell, spans, trace, counters, slice_records, peaks):
        self.cell = cell
        self.spans = spans
        self.trace = trace
        self.counters = counters
        self.records = slice_records
        self.peaks = peaks

    @property
    def reports(self) -> tuple:
        return tuple(self.cell["reports"])


def layer_metrics(obs: Obs, modules: Dict[str, object]) -> dict:
    out = {}
    for name, mod in modules.items():
        value = mod.read(obs)
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out


# -- one run -----------------------------------------------------------------------------


def forbidden_modules() -> List[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def device_info(on_cuda: bool, chips: int, peak: int) -> dict:
    if on_cuda:
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def run(workload: str, seed: int, seconds: float, trace: bool, t_process: float, root: str = ROOT,
        device: str = "cuda", overrides: Optional[dict] = None) -> dict:
    """One run of one cell: set-up, the window, the traced slice (with
    `trace`), the comparison.  Returns the result object.  `overrides`
    replaces keys of the cell's params and config (a CPU test's small
    register); `device` "cpu" runs the plain path without the card."""
    c = cell(workload, root)
    for k, v in (overrides or {}).get("config", {}).items():
        c["config"][k] = v
    for k, v in (overrides or {}).get("params", {}).items():
        c["params"][k] = v
    c["device"] = device
    generator = load_module("generators", c["generator"], root)
    c["reports"] = ("setup_s", "peak_gib") + tuple(generator.E2E)
    on_cuda = device == "cuda"
    runner = generator.setup(c, seed)
    runner.warm()
    if on_cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process

    spans = Spans() if trace else NoSpans()
    runner.instrument(spans)
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    attempts, t_start = run_attempts(runner, seconds, 0, spans, on_cuda)
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0

    result = {"correct": False, "attempted": len(attempts), "failed": sum(a.error is not None for a in attempts)}
    layer, breakdown, extra = {}, None, {}
    if trace:
        slice_spans = Spans(annotate=True)
        runner.instrument(slice_spans)
        before = runner.counters()
        box = {}

        def body():
            t = time.perf_counter()
            box["attempts"], _ = run_attempts(runner, float(c["params"].get("trace_seconds", 2.0)), len(attempts), slice_spans, on_cuda, min_attempts=1)
            box["s"] = time.perf_counter() - t

        if on_cuda:
            tr = profile_slice(body)
        else:
            body()
            tr = None
        after = runner.counters()
        sl = box["attempts"]
        counters = {k: after[k] - before[k] for k in after}
        counters["attempts"] = len(sl)
        obs = Obs(c, spans.seconds, tr, counters, [a.out for a in sl if a.error is None], peaks(root))
        layer = layer_metrics(obs, metric_modules(root))
        if tr is not None:
            extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
            breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        result["failed"] += sum(a.error is not None for a in sl)
        attempts = attempts + sl

    # The comparison with the plain reference, after the window and the peak.
    checks = runner.check([a for a in attempts if a.error is None], seed)
    limits = c["limits"]
    result["correct"] = (
        result["failed"] == 0 and len(attempts) > 0 and all(checks[k] <= limits[k] for k in limits)
    )
    if trace:
        metrics = layer
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}, "peak_gib": {"value": peak / 2**30, "unit": "GiB"}}
        for name, fn in generator.E2E.items():
            value = fn(attempts, t_start, c)
            if value is not None:
                metrics[name] = {"value": value, "unit": "ms"}
    dev = device_info(on_cuda, int(c.get("chips", 1)), peak)
    dev.update(extra)
    result["metrics"] = metrics
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["window"] = window_summary(attempts)
    errors = sorted({a.error for a in attempts if a.error is not None})
    if errors:
        result["errors"] = errors[:5]
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    return result

