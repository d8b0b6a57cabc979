"""The m_high cells (portbench/mhigh.py, generators/fixed_base_mhigh.py and
their four metrics) on the CPU: the closed form in physical order against
the circuit's definition and the port's m_high engine, the oracle's byte
count against the program's own, the metrics by hand, and both cells'
result lines."""

import numpy as np
import pytest
import torch

from portbench import core, layers, mhigh, reference
from portbench.testing import run_small
from portbench.tests.test_portbench_metrics import FakeObs, ev
from portbench.tests.test_portbench_program_spans import Rec, program

CASES = [(21, 2, 6, 5), (15, 7, 4, 4), (33, 5, 5, 6), (35, 3, 4, 6)]
CELLS = ["shor8191-n28.mhigh", "shor8191-n32.mhigh"]


def physical(psi, L, M):
    """A logical-order state (z * 2^M + w) in the m_high physical order (w * 2^L + z)."""
    return psi.reshape(1 << L, 1 << M).T.reshape(-1)


def planar(psi, dtype=torch.float64):
    return torch.stack([torch.from_numpy(psi.real.copy()), torch.from_numpy(psi.imag.copy())]).to(dtype)


@pytest.mark.parametrize("C,a,L,M", CASES)
def test_physical_order_closed_form_against_the_circuit(C, a, L, M):
    d = mhigh.MhighDistribution(C, a, L, M)
    psi = reference.plain_state(C, a, L, M)
    phys = physical(psi, L, M)
    cum = np.cumsum(np.abs(phys) ** 2)
    for index in range(1 << (L + M)):
        p = d.physical(index)
        assert d.cdf(index) == pytest.approx(cum[p], abs=1e-12)
        assert d.prob(index) == pytest.approx(abs(psi[index]) ** 2, abs=1e-12)
    assert d.state_gap(planar(phys), rows_per_block=3) < 1e-12
    assert d.state_gap(planar(psi)) > 0.1  # the logical order is another state here
    for r in np.random.default_rng(C).random(64):
        i = d.exact_index(float(r))
        assert d.index_gap(i, float(r)) == 0.0


@pytest.mark.parametrize("C,a,L,M", CASES)
@pytest.mark.parametrize("dtype", [torch.complex64, "complex32"])
def test_mhigh_engine_against_the_closed_form(C, a, L, M, dtype):
    """The port's m_high engine (the plain path at complex64, the kernels'
    plain versions at complex32): its state equals the circuit's definition
    in physical order, and every clear draw measures the exact physical-order
    inverse CDF's index, through find_period."""
    from quantumcomputer_tpu_torch.algorithms import shor
    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    eng = StateVectorEngine(Register(L, M), dtype=dtype, layout="m_high")
    d = mhigh.MhighDistribution(C, a, L, M)
    state = eng.run(shor_circuit_mhigh(C, a, L, M))
    tol = 1e-5 if dtype == torch.complex64 else 2e-2
    assert d.state_gap(state) < tol
    ref = physical(reference.plain_state(C, a, L, M), L, M)
    assert np.abs(eng.to_numpy(state) - ref).max() < tol
    checked = 0
    for r in np.random.default_rng(L * M).random(40):
        got = shor.find_period(eng, C, a, float(r)).measured_index
        if dtype != torch.complex64:
            assert d.index_gap(got, float(r)) < 1e-2  # bf16 planes: a CDF within their rounding
            continue
        want = d.exact_index(float(r))
        hi = d.cdf(want)
        if min(r - (hi - d.prob(want)), hi - r) < 1e-6:
            continue  # knife edge at float32
        assert got == want
        checked += 1
    assert checked >= 20 or dtype != torch.complex64


@pytest.mark.parametrize("budget_states,dtype", [(None, torch.float32), (1.5, torch.float32), (None, torch.bfloat16)])
def test_oracle_bytes_equal_the_programs_counts(monkeypatch, budget_states, dtype):
    """mhigh.oracle_bytes, from the circuit and the passes' gate counts,
    equals the bytes counts of the program's oracle.gate spans, pass by pass:
    ladders (two states fit), in-place pairs (1.5 states) and strip runs
    (bf16)."""
    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer_tpu_torch.sim import engine as eng_mod
    from quantumcomputer_tpu_torch.sim import statevec as sv
    from quantumcomputer_tpu_torch.utils import profiling

    C, a, L, M = 21, 2, 15, 5
    n = L + M
    if budget_states is not None:
        monkeypatch.setenv("QC_TPU_HBM_BYTES", str(int(budget_states * (8 << n))))
    circuit = shor_circuit_mhigh(C, a, L, M)
    plan = eng_mod.plan_circuit(circuit, 0, n, dtype, "cpu")
    itemsize = torch.empty((), dtype=dtype).element_size()
    profiling.span_records(clear=True)
    profiling.record_spans(True)
    try:
        for _ in range(2):
            eng_mod.apply_circuit_fused_(sv.initial_planar(n, dtype, 1 << L, "cpu"), circuit, 0, plan)
    finally:
        profiling.record_spans(False)
    gates = [r for r in profiling.span_records(clear=True) if r.name == "oracle.gate"]
    passes = [(r.counts["gates"], r.counts["inplace"]) for r in gates]
    assert len({p[1] for p in passes}) == (1 if budget_states else 2)
    assert mhigh.oracle_bytes(passes, C, a, L, M, itemsize) == sum(r.counts["bytes"] for r in gates)
    j = 0
    for r in gates:
        K = r.counts["gates"]
        mult = [pow(a, 1 << (j + k), C) for k in range(K)]
        assert mhigh.pass_bytes(C, mult, n, M, itemsize, bool(r.counts["inplace"])) == r.counts["bytes"]
        j = (j + K) % L
    assert mhigh.oracle_bytes(passes[:-1], C, a, L, M, itemsize) is None  # not whole attempts


def test_pass_bytes_by_hand():
    # C = 7, multiplier 2: rows 1..6 move (gcd(1, 7) = 1), half of 2^3 columns.
    assert mhigh.pass_bytes(7, [2], 6, 3, 4, True) == 2 * 2 * 4 * 6 * 4
    # Multiplier 1 moves nothing; a pair with 2 and 4 (= 2^-1 * ... ): masks 2, 4, 8 = 1 mod 7.
    assert mhigh.pass_bytes(7, [1], 6, 3, 4, True) == 0
    assert mhigh.pass_bytes(7, [2, 4], 6, 3, 4, True) == 2 * 2 * 4 * (6 + 6 + 0) * 2
    # C = 15, multiplier 4: 4 j = j mod 15 where 3 j = 0, gcd(3, 15) = 3 rows stay.
    assert mhigh.pass_bytes(15, [4], 6, 4, 4, True) == 2 * 2 * 4 * 12 * 2
    assert mhigh.pass_bytes(15, [4, 2], 6, 4, 2, False) == 2 * 2 * 2 * 64


def mhigh_cell(L=4, M=4, a=2, C=15):
    return {"config": {"C": C, "a": a, "L": L, "M": M, "precision": "complex64"}, "params": {"layout": "m_high"},
            "reports": ("setup_s", "peak_gib", "attempt_ms", "attempt_p95_ms")}


def mhigh_trace():
    """A 100 us slice with two m_high oracle kernels (10 and 30 us), a
    fused segment and the block sums."""
    events = [
        ev("user_annotation", "pb.slice", 0, 100),
        ev("kernel", "void (anonymous namespace)::cycle_walk_kernel<float, 4>(float*)", 10, 10),
        ev("kernel", "void (anonymous namespace)::ladder_kernel<float>(float const*)", 30, 30),
        ev("kernel", "void (anonymous namespace)::fused_segment_kernel<float, float, 2, 4, false, false>(float*)", 60, 20),
        ev("kernel", "void block_sums_kernel<float, float>(float const*)", 85, 5),
    ]
    return core.Trace(events)


def mhigh_attempt(base, reset=True, counts=True):
    """One m_high attempt's spans at L = 4: a walk of control 0, a ladder of
    controls 1-3; 2 ms an oracle gate, 0.5 the reset, 1 the measurement."""
    kw = [dict(gates=1, inplace=1, bytes=0), dict(gates=3, inplace=0, bytes=0)]
    recs = [Rec("engine.reset", base + 2, base + 1, 0.1, 0.5)] if reset else []
    recs += [Rec("oracle.gate", base + 3 + k, base + 1, 0.1, 2.0, **(kw[k] if counts else {"gates": kw[k]["gates"]}))
             for k in range(2)]
    recs += [Rec("engine.run", base + 1, base, 5.0, 5.0), Rec("measure.sample", base + 6, base, 1.0, 1.0),
             Rec("driver.attempt", base, None, 8.0, 8.0)]
    return recs


def read(name, obs):
    return core.metric_modules()[name].read(obs)


def test_mhigh_metrics_by_hand(monkeypatch):
    monkeypatch.setattr(layers, "hbm_bytes_per_s", lambda obs: 1e9)
    program(monkeypatch, mhigh_attempt(0) + mhigh_attempt(100))
    obs = FakeObs(mhigh_cell(), mhigh_trace(), {"attempts": 2})
    assert read("oracle.ms.mhigh", obs) == pytest.approx(4.0)
    assert read("measure.ms.mhigh", obs) == pytest.approx(1.0)
    assert read("engine.reset_ms", obs) == pytest.approx(0.5)
    # Control 0, multiplier 2 mod 15: gcd(1, 15) = 1, 14 rows of 8 columns;
    # the ladder every element of 2^8: per attempt 4 * 4 * (14 * 8 + 256) bytes.
    nbytes = 2 * 4 * 4 * (14 * 8 + 256)
    assert read("walk.roofline", obs) == pytest.approx(100.0 * nbytes / 1e9 / 40e-6)


def test_mhigh_metrics_give_nothing_elsewhere(monkeypatch):
    monkeypatch.setattr(layers, "hbm_bytes_per_s", lambda obs: 1e9)
    program(monkeypatch, mhigh_attempt(0, reset=False, counts=False) + mhigh_attempt(100, reset=False, counts=False))
    obs = FakeObs(mhigh_cell(), mhigh_trace(), {"attempts": 2})
    # A program without the reset span or the passes' counts (the parent).
    assert read("engine.reset_ms", obs) is None and read("walk.roofline", obs) is None
    assert read("oracle.ms.mhigh", obs) == pytest.approx(4.0)
    standard = dict(mhigh_cell(), params={"layout": "standard"})
    program(monkeypatch, mhigh_attempt(0) + mhigh_attempt(100))
    for name in ("oracle.ms.mhigh", "measure.ms.mhigh", "engine.reset_ms", "walk.roofline"):
        assert read(name, FakeObs(standard, mhigh_trace(), {"attempts": 2})) is None
        assert read(name, FakeObs(mhigh_cell(), None, {"attempts": 2})) is None  # untraced
        assert read(name, FakeObs(mhigh_cell(), mhigh_trace(), {"attempts": 3})) is None  # roots != attempts


@pytest.mark.parametrize("workload", CELLS)
def test_mhigh_result_line_keys(workload):
    r = run_small(workload, seconds=0.2)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) >= {"setup_s", "peak_gib", "attempt_ms"}
    assert set(r["checks"]) == {"state_gap", "index_gap", "driver_mismatches"}


def test_the_n32_cell_asks_the_sampler_first(monkeypatch):
    """The m_high generator asks the program's sampler for the state's
    block geometry first, so a program whose sampler stops at 2^31
    amplitudes fails the n = 32 cell's set-up at once, before any kernel
    builds."""
    from quantumcomputer_tpu_torch.ops import measure

    def refuse(dim):
        raise ValueError("exceeds the 2^31 index budget")

    monkeypatch.setattr(measure, "block_geom", refuse)
    c = dict(core.cell("shor8191-n32.mhigh"), device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        core.load_module("generators", "fixed_base_mhigh").setup(c, 1)
