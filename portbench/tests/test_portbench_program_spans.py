"""The per-layer metrics that read the program's own spans
(portbench/program_spans.py and its metric files), against hand counts on
synthetic span records and a synthetic profiler trace, with every case in
which they give nothing."""

import pytest

from portbench import core, program_spans
from portbench.tests.test_portbench_metrics import FakeObs, ev, full_cell, synthetic_trace

SWEEP = {"config": {"L": 3, "M": 4, "precision": "complex64"}, "reports": ("setup_s", "peak_gib", "sweep_attempt_ms")}
SC = {"config": {"L": 2, "M": 4, "precision": "complex64"}, "reports": ("setup_s", "peak_gib", "sc_step_ms")}


class Rec:
    """A span record as the program's span_records gives it."""

    def __init__(self, name, id, parent, host_ms, device_ms=None, **counts):
        self.name, self.id, self.parent = name, id, parent
        self.host_ms, self.device_ms, self.counts = host_ms, device_ms, counts


def attempt(base, host_ms, plan=0.0):
    """One full-register attempt's spans, ids from `base`: 10 ms of device
    time a fused segment (2), 4 ms an oracle gate (2, each with its table),
    1 ms the measurement; `plan` > 0 adds a plan of that host time."""
    a = base
    recs = [Rec("engine.run", a + 1, a, host_ms - 3.0, 29.0)]
    if plan:
        recs.append(Rec("engine.plan", a + 2, a + 1, plan))
    for k in range(2):
        recs.append(Rec("fused.segment", a + 3 + k, a + 1, 0.1, 10.0))
        recs.append(Rec("oracle.gate", a + 5 + k, a + 1, 0.5, 4.0, gates=1))
        recs.append(Rec("oracle.table", a + 7 + k, a + 5 + k, 0.25, 0.3, bytes=128))
    recs += [
        Rec("measure.sample", a + 9, a, 1.5, 1.0),
        Rec("driver.period", a + 10, a, 0.5),
        Rec("driver.attempt", a, None, host_ms, host_ms),
    ]
    return recs


def program(monkeypatch, recs, dropped=0):
    """The program's span_records / dropped_spans give these."""
    from quantumcomputer_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "span_records", lambda clear=False: list(recs))
    monkeypatch.setattr(profiling, "dropped_spans", lambda: dropped)


def read(name, obs):
    return core.metric_modules()[name].read(obs)


def test_full_register_metrics_by_hand(monkeypatch):
    program(monkeypatch, attempt(0, 40.0, plan=2.0) + attempt(100, 30.0))
    obs = FakeObs(full_cell(), synthetic_trace(), {"attempts": 2})
    # Self: 40 - (37 + 1.5 + 0.5) and 30 - (27 + 1.5 + 0.5), over 2 attempts.
    assert read("driver.self_ms", obs) == pytest.approx(1.0)
    # Plan 2 ms once, tables 4 x 0.25 ms, over 2 attempts.
    assert read("engine.plan_ms", obs) == pytest.approx((2.0 + 1.0) / 2)
    assert read("fused.ms", obs) == pytest.approx(20.0)
    assert read("oracle.ms", obs) == pytest.approx(8.0)
    assert read("measure.ms", obs) == pytest.approx(1.0)
    for name in ("engine.plan_ms.sweep", "oracle.ms.sweep", "device.idle.plan.sweep", "sc.plan_ms", "sc.oracle_ms"):
        assert read(name, obs) is None  # the cell does not report what they move


def test_sweep_twins_read_as_their_bases(monkeypatch):
    program(monkeypatch, attempt(0, 40.0, plan=6.0) + attempt(100, 30.0, plan=8.0))
    obs = FakeObs(SWEEP, synthetic_trace(), {"attempts": 2})
    assert read("engine.plan_ms.sweep", obs) == pytest.approx((6.0 + 8.0 + 1.0) / 2)
    assert read("oracle.ms.sweep", obs) == pytest.approx(8.0)
    for name in ("engine.plan_ms", "oracle.ms", "fused.ms", "measure.ms", "driver.self_ms"):
        assert read(name, obs) is None


def test_semiclassical_metrics_by_hand(monkeypatch):
    recs = [
        Rec("sc.plan", 1, 0, 0.4, planned=1),
        Rec("sc.permute", 3, 2, 0.1, 6.0), Rec("sc.rotate", 4, 2, 0.1, 2.0),
        Rec("sc.branch_sums", 5, 2, 0.1, 3.0), Rec("sc.collapse", 6, 2, 0.1, 1.5), Rec("sc.step", 2, 0, 1.0, 13.0),
        Rec("sc.gather_pass", 8, 7, 0.1, 9.0), Rec("sc.collapse", 9, 7, 0.1, 2.5), Rec("sc.step", 7, 0, 1.0, 12.0),
        Rec("sc.attempt", 0, None, 3.0, 26.0),
    ]
    program(monkeypatch, recs)
    obs = FakeObs(SC, core.Trace([ev("user_annotation", "pb.slice", 0, 100)]), {"attempts": 1})
    # L = 2 steps of one attempt.
    assert read("sc.plan_ms", obs) == pytest.approx(0.2)
    assert read("sc.oracle_ms", obs) == pytest.approx((6.0 + 2.0 + 9.0) / 2)
    assert read("sc.branch_ms", obs) == pytest.approx(1.5)
    assert read("sc.collapse_ms", obs) == pytest.approx(2.0)
    assert read("oracle.ms", obs) is None and read("device.idle.plan.sweep", obs) is None


def test_idle_while_planning_is_the_time_weighted_overlap(monkeypatch):
    """A 100 us slice, busy [10, 30) and [60, 70): idle [0, 10), [30, 60),
    [70, 100).  The host plans over [5, 40) and builds a table over
    [65, 80) (nested in an oracle range): 5 + 10 + 0 + 10 us of idle
    overlap, a quarter of the slice, though the gap at 30 began before the
    plan's end and the one at 70 inside another range."""
    events = [
        ev("user_annotation", "pb.slice", 0, 100),
        ev("user_annotation", "qc.driver.attempt", 0, 95),
        ev("user_annotation", "qc.engine.plan", 5, 35),
        ev("user_annotation", "qc.oracle.gate", 60, 25),
        ev("user_annotation", "qc.oracle.table", 65, 15),
        ev("user_annotation", "qc.engine.plan", 0, 100, tid=2),  # another thread: not the slice's
        ev("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=2),
        ev("kernel", "void fused_segment_kernel<float>(float*)", 10, 20, corr=1, tid=7),
        ev("kernel", "void indexSelect<float>(float*)", 60, 10, corr=2, tid=7),
    ]
    tr = core.Trace(events)
    program(monkeypatch, attempt(0, 40.0, plan=6.0))
    obs = FakeObs(SWEEP, tr, {"attempts": 1})
    assert read("device.idle.plan.sweep", obs) == pytest.approx(25.0)
    assert read("device.idle.sweep", obs) == pytest.approx(70.0)  # the share it is part of


def test_nothing_read_where_nothing_can_be(monkeypatch):
    recs = attempt(0, 40.0) + attempt(100, 30.0)
    names = ("driver.self_ms", "engine.plan_ms", "fused.ms", "oracle.ms", "measure.ms")
    # No trace: the metrics read nothing, never 0.
    program(monkeypatch, recs)
    assert all(read(n, FakeObs(full_cell(), None, {"attempts": 2})) is None for n in names)
    # The root spans do not match the slice's attempts.
    assert all(read(n, FakeObs(full_cell(), synthetic_trace(), {"attempts": 3})) is None for n in names)
    # Spans were dropped.
    program(monkeypatch, recs, dropped=4)
    assert all(read(n, FakeObs(full_cell(), synthetic_trace(), {"attempts": 2})) is None for n in names)
    # Work off the card has no device times.
    program(monkeypatch, [Rec(r.name, r.id, r.parent, r.host_ms, None, **r.counts) for r in recs])
    obs = FakeObs(full_cell(), synthetic_trace(), {"attempts": 2})
    assert read("fused.ms", obs) is None and read("oracle.ms", obs) is None
    assert read("engine.plan_ms", obs) == pytest.approx(0.5)  # host times still read: 4 x 0.25 ms tables
    # A program that records no spans (one before them): nothing, and no error.
    from quantumcomputer_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "span_records")
    obs = FakeObs(SWEEP, synthetic_trace(), {"attempts": 2})
    assert read("device.idle.plan.sweep", obs) is None and read("oracle.ms.sweep", obs) is None
    assert program_spans.records(obs) is None


def test_the_records_are_read_once_a_run(monkeypatch):
    calls = []
    from quantumcomputer_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "span_records", lambda clear=False: calls.append(clear) or attempt(0, 40.0))
    monkeypatch.setattr(profiling, "dropped_spans", lambda: 0)
    obs = FakeObs(full_cell(), synthetic_trace(), {"attempts": 1})
    for name in ("driver.self_ms", "engine.plan_ms", "fused.ms", "oracle.ms", "measure.ms"):
        assert read(name, obs) is not None
    assert calls == [False]


def test_the_program_records_what_the_readers_read():
    """One attempt of the program on the CPU with recording on: the readers
    find one root an attempt and the host times; device times are the
    card's alone."""
    from quantumcomputer_tpu_torch.algorithms import shor
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
    from quantumcomputer_tpu_torch.utils import profiling

    eng = StateVectorEngine(Register(6, 5), dtype="complex32")
    profiling.span_records(clear=True)
    profiling.record_spans(True)
    try:
        shor.find_period(eng, 21, 2, 0.4)
    finally:
        profiling.record_spans(False)
    try:
        obs = FakeObs(full_cell(), synthetic_trace(), {"attempts": 1})
        assert read("engine.plan_ms", obs) > 0.0 and read("driver.self_ms", obs) > 0.0
        assert read("oracle.ms", obs) is None  # CPU: no device times
    finally:
        profiling.span_records(clear=True)
