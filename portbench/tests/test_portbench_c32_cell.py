"""The complex32 m_high cell (shor8189-n31-c32.mhigh) on the CPU: its files
through the harness, the tensor-core segments' two metrics by hand on
synthetic span records (and every case in which they give nothing), the
control below bf16 storage (portbench/control_sub_bf16.py) against an
independent rounding, and a CPU-sized copy of the cell."""

import math

import numpy as np
import pytest
import torch

from portbench import control_sub_bf16, core, layers, reference
from portbench.testing import run_small
from portbench.tests.test_portbench_cells import benchmark
from portbench.tests.test_portbench_metrics import FakeObs
from portbench.tests.test_portbench_program_spans import Rec, program

CELL = "shor8189-n31-c32.mhigh"
METRICS = ("fused.mm.ms", "fused.mm.roofline")

#: A CPU-sized copy of the cell: a composite C at n = 16, where bf16
#: segments run matrix groups (fused.groups: n >= 13), as at n = 31.
SMALL_C32 = {"C": 221, "a": 2, "L": 8, "M": 8}
#: index_gap at SMALL_C32.  The cell's limit (1.5e-5) is set at n = 31,
#: whose distribution spreads over about 10^6 indices (sum of p^2 1.1e-6);
#: at n = 16 about 10^3 weigh most (1.2e-3), so a bf16 state's CDF error
#: reads some ten times higher there.  The bound follows the cell's rule at
#: this size: the program reads 1.5e-5-1.4e-4 (ten seeds of run_small, 64
#: seeded draws 7.3e-5), the control 1.1e-3.
SMALL_C32_INDEX_GAP = 3e-4


def test_the_cell_loads_through_the_harness():
    c = core.cell(CELL)
    cfg = c["config"]
    assert (c["config_name"], c["traffic"], c["chips"], c["generator"]) == ("shor8189-n31-c32", "fixed_base.mhigh", 1, "fixed_base_mhigh")
    assert (cfg["kind"], cfg["precision"], cfg["C"], cfg["a"], cfg["L"], cfg["M"]) == ("full_register", "complex32", 8189, 2, 18, 13)
    assert cfg["n"] == cfg["L"] + cfg["M"] == 31 and cfg["reduced"] == []
    assert cfg["state_bytes"] == layers.planes_bytes(31, "complex32") == 8 << 30
    assert c["params"] == {"layout": "m_high", "oracle": "gather", "warm_attempts": 2, "trace_seconds": 2.5}
    assert set(c["limits"]) == {"state_gap", "index_gap", "driver_mismatches"} and c["limits"]["driver_mismatches"] == 0
    mods = core.metric_modules()
    for name in METRICS:
        assert mods[name].MOVES == "attempt_ms"
        (entry,) = [m for m in benchmark()["per_layer"] if m["name"] == name]
        assert (entry["unit"], entry["layer"], entry["workloads"]) == (mods[name].UNIT, "fused segments", [CELL])


def test_the_configurations_number_theory():
    """ord_8189(2) = 774 and 2^387 splits C = 19 x 431, as the file says."""
    assert reference.factorize(8189) == {19: 1, 431: 1}
    assert reference.multiplicative_order(2, 8189) == 774
    half = pow(2, 774 // 2, 8189)
    assert half == 5604 and {math.gcd(half - 1, 8189), math.gcd(half + 1, 8189)} == {431, 19}


def c32_cell(L=4, M=4):
    return {"config": {"C": 15, "a": 2, "L": L, "M": M, "precision": "complex32"}, "params": {"layout": "m_high"},
            "reports": ("setup_s", "peak_gib", "attempt_ms", "attempt_p95_ms")}


def c32_attempt(base, groups=(2, 0, 0, 3), device_ms=(3.0, 1.0, 1.0, 4.0)):
    """One attempt's spans: four fused segments (None: no `groups` count,
    as the parent program records them), an oracle pass, the measurement."""
    recs = [Rec("fused.segment", base + 2 + k, base + 1, 0.1, ms, **({} if g is None else {"groups": g}))
            for k, (g, ms) in enumerate(zip(groups, device_ms))]
    recs += [Rec("oracle.gate", base + 7, base + 1, 0.1, 2.0, gates=4), Rec("engine.run", base + 1, base, 12.0, 12.0),
             Rec("measure.sample", base + 8, base, 1.0, 1.0), Rec("driver.attempt", base, None, 14.0, 14.0)]
    return recs


def read(name, obs):
    return core.metric_modules()[name].read(obs)


def test_matrix_segment_metrics_by_hand(monkeypatch):
    monkeypatch.setattr(layers, "hbm_bytes_per_s", lambda obs: 1e9)
    program(monkeypatch, c32_attempt(0) + c32_attempt(100, device_ms=(5.0, 1.0, 1.0, 6.0)))
    obs = FakeObs(c32_cell(), object(), {"attempts": 2})
    # The segments with groups > 0: 3 + 4 and 5 + 6 ms over two attempts.
    assert read("fused.mm.ms", obs) == pytest.approx(9.0)
    # Four such spans, each one read and one write of 2 planes of 2^8 bf16 amplitudes.
    nbytes = 4 * 2 * 2 * 2 * 256
    assert read("fused.mm.roofline", obs) == pytest.approx(100.0 * nbytes / 1e9 / 18e-3)
    assert read("fused.ms", obs) == pytest.approx(11.0)  # every segment, as before


def test_matrix_segment_metrics_give_nothing_elsewhere(monkeypatch):
    monkeypatch.setattr(layers, "hbm_bytes_per_s", lambda obs: 1e9)
    cases = [
        (c32_attempt(0, groups=(None,) * 4) + c32_attempt(100, groups=(None,) * 4), c32_cell(), {"attempts": 2}),  # parent
        (c32_attempt(0, groups=(0,) * 4) + c32_attempt(100, groups=(0,) * 4), c32_cell(), {"attempts": 2}),  # butterflies
        (c32_attempt(0) + c32_attempt(100), c32_cell(), {"attempts": 3}),  # roots != attempts
        ([], c32_cell(), {"attempts": 2}),  # no spans
        (c32_attempt(0) + c32_attempt(100), dict(c32_cell(), reports=("setup_s", "peak_gib", "sweep_attempt_ms")), {"attempts": 2}),
    ]
    for recs, cell, counters in cases:
        program(monkeypatch, recs)
        for name in METRICS:
            assert read(name, FakeObs(cell, object(), counters)) is None, name
    program(monkeypatch, c32_attempt(0) + c32_attempt(100))
    for name in METRICS:
        assert read(name, FakeObs(c32_cell(), None, {"attempts": 2})) is None  # untraced
    dropped = c32_attempt(0, device_ms=(None, 1.0, 1.0, 4.0)) + c32_attempt(100)
    program(monkeypatch, dropped)
    assert read("fused.mm.ms", FakeObs(c32_cell(), object(), {"attempts": 2})) is None  # work off the card


def nearest_even(x: float, bits: int) -> float:
    """x rounded to `bits` explicit mantissa bits, ties to even, by
    arithmetic on the value (a normal x)."""
    m, e = math.frexp(x)  # x = m 2^e, 0.5 <= |m| < 1: bits + 1 significant bits
    step = math.ldexp(1.0, e - bits - 1)
    return round(x / step) * step  # round() takes ties to even


@pytest.mark.parametrize("drop", [3, 4])
def test_the_control_rounds_to_nearest_even(drop):
    """Every normal bf16 value, rounded in place by round_mantissa_, equals
    the value rounded to 7 - drop mantissa bits by arithmetic; a carry into
    the exponent rounds up to the next power of two."""
    pattern = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16)
    values = pattern.view(torch.bfloat16)
    exponent = (pattern.to(torch.int32) >> 7) & 0xFF
    normal = (exponent > 0) & (exponent < 0xFE)  # the top binade may round past the largest finite value
    x = values[normal].clone()
    got = control_sub_bf16.round_mantissa_(x.view(2, -1), drop).view(-1).double().numpy()
    src = values[normal].double().numpy()
    want = np.array([nearest_even(float(v), 7 - drop) for v in src])
    assert np.array_equal(got, want)
    low = x.view(torch.int16).to(torch.int32) & ((1 << drop) - 1)
    assert not low.any()
    ties = torch.tensor([1.0 + 2.0**-5, 1.0 + 3 * 2.0**-5, -(1.0 + 2.0**-5)], dtype=torch.bfloat16)
    if drop == 3:  # halfway between 4-bit neighbours: to the even one
        assert control_sub_bf16.round_mantissa_(ties.clone()).tolist() == [1.0, 1.0 + 2 * 2.0**-4, -1.0]
    top = torch.tensor([2.0 - 2.0**-7], dtype=torch.bfloat16)
    assert control_sub_bf16.round_mantissa_(top, drop).item() == 2.0


def test_the_control_takes_bf16_and_a_width_below_it():
    with pytest.raises(TypeError):
        control_sub_bf16.round_mantissa_(torch.zeros(2, 4))
    for drop in (0, 7):
        with pytest.raises(ValueError):
            control_sub_bf16.round_mantissa_(torch.zeros(2, 4, dtype=torch.bfloat16), drop)


def test_the_control_wraps_the_plan_entries_and_restores_them():
    """Inside below_bf16 every plan entry leaves its planes on the 4-bit
    grid; outside, the program's own calls are back."""
    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer_tpu_torch.ops import fused, oracle
    from quantumcomputer_tpu_torch.sim import engine
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    sites = [(fused, "apply_fused"), (oracle, "apply_camodc_run_inplace_planar"), (engine, "apply_gate_planes_")]
    before = [getattr(m, n) for m, n in sites]
    eng = StateVectorEngine(Register(8, 5), dtype="complex32", layout="m_high")
    circuit = shor_circuit_mhigh(21, 2, 8, 5)
    plain = eng.run(circuit)
    assert (plain.view(torch.int16) & 7).any()
    with control_sub_bf16.below_bf16():
        assert all(getattr(m, n) is not f for (m, n), f in zip(sites, before))
        low = eng.run(circuit)
    assert [getattr(m, n) for m, n in sites] == before
    assert not (low.view(torch.int16) & 7).any()
    assert torch.equal(eng.run(circuit), plain)


def test_a_cpu_sized_copy_of_the_cell():
    """The cell at SMALL_C32 through the kernels' plain versions: nothing
    fails, the state and the driver within the cell's own limits, index_gap
    within the bound for this size (SMALL_C32_INDEX_GAP)."""
    r = run_small(CELL, seconds=0.3, config=SMALL_C32)
    limits = core.cell(CELL)["limits"]
    checks = {k: v["value"] for k, v in r["checks"].items()}
    assert r["failed"] == 0 and r["attempted"] > 0
    assert checks["state_gap"] <= limits["state_gap"] and checks["driver_mismatches"] == 0
    assert checks["index_gap"] <= SMALL_C32_INDEX_GAP
    assert set(r["metrics"]) >= {"setup_s", "peak_gib"}


@pytest.mark.parametrize("drop", [3, 4])
def test_the_control_fails_a_cpu_sized_copy(drop):
    """control_sub_bf16.readings at SMALL_C32: not correct, its state over
    the cell's state_gap limit and its index_gap over this size's bound."""
    (row,) = control_sub_bf16.readings(CELL, [5], 0.3, drop=drop, device="cpu", config=SMALL_C32)
    assert row["correct"] is False and row["precision"] == "complex32"
    assert row["checks"]["state_gap"] > core.cell(CELL)["limits"]["state_gap"]
    assert row["checks"]["index_gap"] > SMALL_C32_INDEX_GAP
