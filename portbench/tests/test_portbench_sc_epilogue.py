"""sc.epilogue.roofline against a hand count on a synthetic profiler trace,
and its silence where the step's kernels did not run."""

import pytest

from portbench import core, layers


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def obs_of(kernels, reports=("setup_s", "peak_gib", "sc_step_ms")):
    events = [ev("user_annotation", "pb.slice", 0, 100)]
    for i, (name, ts, dur) in enumerate(kernels):
        events.append(ev("cuda_runtime", "cudaLaunchKernel", ts - 1, 1, corr=i))
        events.append(ev("kernel", name, ts, dur, corr=i, tid=7))
    cell = {"config": {"L": 2, "M": 4, "precision": "complex64"}, "reports": reports}
    return core.Obs(cell, {}, core.Trace(events), {"attempts": 1}, [], {})


def test_epilogue_roofline_by_hand(monkeypatch):
    monkeypatch.setattr(layers, "hbm_bytes_per_s", lambda obs: 1e9)
    obs = obs_of([
        ("void (anonymous namespace)::sc_branch_sums_kernel<float>(float const*, double*, long)", 10, 4),
        ("void (anonymous namespace)::sc_collapse_kernel<float>(float*, float*, long)", 20, 6),
        ("void (anonymous namespace)::sc_branch_sums_kernel<float>(float const*, double*, long)", 40, 4),
        ("void transpose_kernel<float>(float const*)", 50, 30),
    ])
    state = 2 * 16 * 4  # (2, 2^4) float32 planes
    want = 100 * ((2 + 3 + 2) * state / 1e9) / 14e-6
    assert core.metric_modules()["sc.epilogue.roofline"].read(obs) == pytest.approx(want)


@pytest.mark.parametrize("kernels,reports", [
    ([("void transpose_kernel<float>(float const*)", 10, 8)], ("setup_s", "peak_gib", "sc_step_ms")),
    ([("void (anonymous namespace)::sc_collapse_kernel<float>(float*)", 10, 8)], ("setup_s", "peak_gib", "attempt_ms")),
])
def test_epilogue_roofline_reads_nothing_without_its_kernels(kernels, reports, monkeypatch):
    monkeypatch.setattr(layers, "hbm_bytes_per_s", lambda obs: 1e9)
    assert core.metric_modules()["sc.epilogue.roofline"].read(obs_of(kernels, reports)) is None
