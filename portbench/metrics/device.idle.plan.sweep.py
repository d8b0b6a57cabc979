"""device.idle.plan.sweep: the share of the traced slice in which the card
is idle while the host plans, in %: device idle time (no kernel, copy or
memset; Trace.intervals) that overlaps the host intervals of the program's
qc.engine.plan and qc.oracle.table ranges on the trace, over the slice.
The overlap is weighed by time, wherever the gap began.
Layer: engine + planner.  Source: the device trace.  Moves: sweep_attempt_ms."""

from portbench import program_spans

UNIT = "%"
MOVES = "sweep_attempt_ms"
RANGES = ("qc.engine.plan", "qc.oracle.table")


def union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def idle(trace):
    """The slice's idle intervals: its complement of Trace.intervals()."""
    gaps, prev = [], trace.t0
    for a, b in trace.intervals():
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if trace.t1 > prev:
        gaps.append((prev, trace.t1))
    return gaps


def overlap_us(xs, ys):
    """Total length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] <= ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(obs):
    if MOVES not in obs.reports or program_spans.roots(obs, "driver.attempt") is None:
        return None
    tr = obs.trace
    plan = union((max(a, tr.t0), min(b, tr.t1)) for a, b, name in tr.host if name in RANGES)
    return 100.0 * overlap_us(idle(tr), plan) * 1e-6 / tr.window_s
