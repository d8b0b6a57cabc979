"""The per-layer metrics' byte counts and trace arithmetic, against hand
counts, on a synthetic profiler trace."""

import pytest

from portbench import core, layers


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def synthetic_trace():
    """A 100 us slice: a pb.attempt range holding a pb.run range; four
    device ops launched inside them and one outside."""
    events = [
        ev("user_annotation", "pb.slice", 0, 100),
        ev("user_annotation", "pb.attempt", 0, 90),
        ev("user_annotation", "pb.run", 5, 40),
        ev("cpu_op", "aten::index_select", 10, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=4),
        ev("cpu_op", "aten::item", 60, 30),
        ev("kernel", "void at::native::indexSelectLargeIndex<float, long>(float*)", 12, 10, corr=1, tid=7),
        ev("kernel", "void at::native::elementwise_kernel<128, direct_copy_kernel_cuda>(int)", 22, 10, corr=2, tid=7),
        ev("kernel", "void (anonymous namespace)::fused_segment_kernel<float, float, false, false>(float*, float*)", 32, 20, corr=3, tid=7),
        ev("kernel", "void block_sums_kernel<float, float>(float const*)", 55, 5, corr=4, tid=7),
    ]
    return core.Trace(events)


class FakeObs(core.Obs):
    def __init__(self, cell, trace, counters, records=(), spans=None):
        super().__init__(cell, spans or {}, trace, counters, list(records), {})


def full_cell(L=3, M=4, precision="complex64"):
    return {"config": {"L": L, "M": M, "precision": precision}, "reports": ("setup_s", "peak_gib", "attempt_ms", "attempt_p95_ms")}


def test_trace_attribution_busy_and_idle():
    tr = synthetic_trace()
    assert tr.window_s == pytest.approx(100e-6)
    spans = {core.short_name(n): s for n, _, _, s in tr.ops}
    assert spans["at::native::indexSelectLargeIndex<float, long>"] == "run"
    assert spans["fused_segment_kernel<float, float, false, false>"] == "run"
    assert spans["block_sums_kernel<float, float>"] == "attempt"
    # Busy: [12, 22) + [22, 32) + [32, 52) + [55, 60) = 45 us.
    assert tr.busy_s() == pytest.approx(45e-6)
    gaps = dict(tr.idle_gaps())
    # Idle: [0, 12) while pb.run launches (its innermost op at 0 is pb.attempt),
    # [52, 55) inside pb.attempt, [60, 100) in aten::item until 90, then pb.slice.
    assert sum(gaps.values()) == pytest.approx(55e-6)
    assert gaps["aten::item"] == pytest.approx(40e-6)
    assert tr.top_ops(1)[0][0] == "fused_segment_kernel<float, float, false, false>"


def test_kernel_identifiers():
    assert layers.ident("void fused_segment_kernel<float, float, false, false>(float*, int)") == "fused_segment_kernel"
    assert layers.ident("transpose_kernel(float const*, float*, long)") == "transpose_kernel"
    assert layers.ident("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >(int)").startswith("at::native::")


def test_state_bytes_by_hand():
    assert layers.planes_bytes(3, "complex64") == 2 * 8 * 4
    assert layers.planes_bytes(28, "complex64") == 2 * 2**30
    assert layers.planes_bytes(30, "complex32") == 2 * 2**30 * 2
    # n = 28, complex64: the oracle stage's least bytes over 3.35 TB/s is 1.28 ms.
    least = 2 * layers.planes_bytes(28, "complex64") * (1 - 2.0**-15)
    assert least / 3.35e12 == pytest.approx(1.282e-3, rel=1e-3)


def test_roofline_metrics_by_hand(monkeypatch):
    monkeypatch.setattr(layers, "hbm_bytes_per_s", lambda obs: 1e9)  # 1 GB/s: bytes / 1e9 seconds
    tr = synthetic_trace()
    mods = core.metric_modules()
    cell = full_cell(L=3, M=4)
    obs = FakeObs(cell, tr, {"fused": 3, "permute": 1, "attempts": 2})
    state = 2 * 2**7 * 4  # (2, 2^7) float32 planes
    # fused: 2 launches x 2 x state bytes over 20 us of fused_segment_kernel.
    assert mods["fused.roofline"].read(obs) == pytest.approx(100 * (2 * 2 * state / 1e9) / 20e-6)
    # oracle: 2 attempts x 2 x state x (1 - 2^-3) over the gather (10 us) and copy (10 us) in pb.run.
    assert mods["oracle.roofline"].read(obs) == pytest.approx(100 * (2 * 2 * state * (1 - 1 / 8) / 1e9) / 20e-6)
    assert mods["device.idle.attempt"].read(obs) == pytest.approx(55.0)
    assert mods["device.idle.sc"].read(obs) is None
    assert mods["sc.glue_ms"].read(obs) is None
    assert mods["driver.host_ms"].read(obs) is None  # no spans recorded


def test_semiclassical_metrics_by_hand(monkeypatch):
    monkeypatch.setattr(layers, "hbm_bytes_per_s", lambda obs: 1e9)
    events = [
        ev("user_annotation", "pb.slice", 0, 100),
        ev("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 3, 1, corr=3),
        ev("kernel", "void transpose_kernel<float>(float const*)", 10, 8, corr=1, tid=7),
        ev("kernel", "void chunk_gather_kernel<float>(float const*)", 20, 12, corr=2, tid=7),
        ev("kernel", "void at::native::reduce_kernel<512, 1>(int)", 40, 30, corr=3, tid=7),
    ]
    tr = core.Trace(events)
    cell = {"config": {"L": 2, "M": 4, "precision": "complex64"}, "reports": ("setup_s", "peak_gib", "sc_step_ms")}
    obs = FakeObs(cell, tr, {"attempts": 1}, records=[{"oracles": ["structured", "gather"]}])
    mods = core.metric_modules()
    # One planned step: both planes of a (2, 2^4) float32 state read and written once.
    assert mods["modperm.roofline"].read(obs) == pytest.approx(100 * (2 * 2 * 16 * 4 / 1e9) / 20e-6)
    # Glue: the 30 us reduce over L = 2 steps of one attempt.
    assert mods["sc.glue_ms"].read(obs) == pytest.approx(30e-3 / 2)
    assert mods["device.idle.sc"].read(obs) == pytest.approx(50.0)
    assert mods["fused.roofline"].read(obs) is None
    assert mods["oracle.roofline"].read(obs) is None


def test_span_metrics_by_hand():
    mods = core.metric_modules()
    obs = FakeObs(full_cell(), None, {}, spans={"attempt": [0.010, 0.012], "engine": [0.009, 0.011]})
    assert mods["driver.host_ms"].read(obs) == pytest.approx(1.0)
    assert mods["engine.ms"].read(obs) == pytest.approx(10.0)
    assert mods["fused.roofline"].read(obs) is None  # no trace: nothing read, never 0
