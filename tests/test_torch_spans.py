"""The port's spans (quantumcomputer_tpu_torch/utils/profiling.py: span,
record_spans, span_records, span_summary) on the CPU: off by default and
then a shared no-op, results bit for bit the same with recording on, the
span tree of a Shor attempt and of a semiclassical attempt, the counts the
spans carry, the ``qc.*`` ranges in a profiler's Chrome trace, and the
bounded buffer.

complex32 off the card runs the cuda backend's planned path
(apply_circuit_fused_) through the kernels' plain versions, so these
engines reach every full-register span a card run has."""

import json
import math

import numpy as np
import pytest
import torch

from quantumcomputer_tpu_torch.algorithms import semiclassical as sc
from quantumcomputer_tpu_torch.algorithms import shor
from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
from quantumcomputer_tpu_torch.ops import fused
from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
from quantumcomputer_tpu_torch.utils import profiling as prof

C, A, L, M = 21, 2, 6, 5
SC_C, SC_L, SC_M = (1 << 18) - 3, 6, 18


@pytest.fixture(autouse=True)
def _fresh_spans():
    prof.record_spans(False)
    prof.span_records(clear=True)
    yield
    prof.record_spans(False)
    prof.span_records(clear=True)


def engine(**kw):
    return StateVectorEngine(Register(L, M), dtype="complex32", **kw)


def recorded(fn):
    """fn() with recording on; returns (its result, the records)."""
    prof.record_spans(True)
    try:
        out = fn()
    finally:
        prof.record_spans(False)
    return out, prof.span_records(clear=True)


def children(recs, parent):
    return [r for r in recs if r.parent == parent.id]


def names(recs):
    return [r.name for r in recs]


def sc_base(need=2):
    """A base whose SC_L-step ladder plans at least `need` structured steps."""
    for a in range(2, 400):
        if math.gcd(a, SC_C) != 1:
            continue
        a_invs = [pow(pow(a, 1 << (SC_L - 1 - s), SC_C), -1, SC_C) for s in range(SC_L)]
        if sum(p is not None for p in sc._structured_plans(SC_C, a_invs, SC_M)) >= need:
            return a
    raise AssertionError("no base with enough planned steps")


def test_off_by_default_a_shared_noop_that_records_nothing():
    eng = engine()
    a, b = prof.span("engine.run"), prof.span("oracle.gate", eng.device, gates=1)
    assert a is b
    with a as rec:
        assert rec is None
    shor.find_period(eng, C, A, 0.3)
    assert prof.span_records() == [] and prof.dropped_spans() == 0


@pytest.mark.parametrize("layout,oracle", [("standard", "gather"), ("standard", "benes"), ("m_high", "gather")])
def test_fused_path_bit_identical_with_recording(layout, oracle):
    circuit = (shor_circuit_mhigh if layout == "m_high" else shor_circuit)(C, A, L, M)
    eng = engine(layout=layout, oracle=oracle)
    assert eng.backend == "cuda" and eng.device.type == "cpu"
    off = eng.run(circuit)
    on, recs = recorded(lambda: eng.run(circuit))
    assert torch.equal(on, off)
    assert {"engine.run", "fused.segment", "oracle.gate"} <= set(names(recs))
    assert all(r.device_ms is None for r in recs)  # no CUDA events off the card


def test_semiclassical_bit_identical_with_recording():
    a = sc_base()
    rs = np.random.default_rng(3).random(SC_L).astype(np.float32)
    off = sc.run_semiclassical(SC_C, a, SC_L, SC_M, rs, structured=True)
    on, _ = recorded(lambda: sc.run_semiclassical(SC_C, a, SC_L, SC_M, rs, structured=True))
    assert on.bits == off.bits and on.branch_probs == off.branch_probs and on.oracles == off.oracles


def oracle_multipliers(eng):
    """(C, A mod C) of each lone oracle gate of the attempt's plan, in order."""
    plan = eng._plan(shor_circuit(C, A, L, M))
    return [(s[1].meta[0], s[1].meta[1] % s[1].meta[0]) for s in plan if s[0] == "single"]


def test_shor_attempt_span_tree():
    """An oracle.gate holds an oracle.table only where its case table is
    built: on a miss of the cache, the first gate of each multiplier."""
    eng = engine()
    fused._case_tables.cache_clear()
    rec, recs = recorded(lambda: shor.find_period(eng, C, A, 0.3))
    (attempt,) = [r for r in recs if r.parent is None]
    assert attempt.name == "driver.attempt" and all(r.root == attempt.id for r in recs)
    assert names(children(recs, attempt)) == ["engine.run", "measure.sample", "driver.period"]
    run = children(recs, attempt)[0]
    inner = children(recs, run)
    assert names(inner[:2]) == ["engine.reset", "engine.plan"]
    assert set(names(inner[2:])) == {"fused.segment", "oracle.gate"}
    assert names(inner).count("oracle.gate") == L
    multipliers = oracle_multipliers(eng)
    assert len(multipliers) == L > len(set(multipliers))
    gates = [r for r in inner if r.name == "oracle.gate"]
    for i, (gate, key) in enumerate(zip(gates, multipliers)):
        built = key not in multipliers[:i]
        assert names(children(recs, gate)) == (["oracle.table"] if built else [])
    # Children close inside their parent, on the host clock.
    for r in recs:
        if r.parent is not None:
            (p,) = [q for q in recs if q.id == r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    assert recs[-1] is attempt and rec.measured_index >= 0


def test_gather_attempt_counts_its_oracle_gates_and_tables():
    """One oracle.table a case table built (a miss), with its int16 bytes,
    on the CPU as on the card; the next attempt builds none."""
    eng = engine()
    fused._case_tables.cache_clear()
    _, recs = recorded(lambda: shor.find_period(eng, C, A, 0.7))
    gates = [r for r in recs if r.name == "oracle.gate"]
    tables = [r for r in recs if r.name == "oracle.table"]
    assert len(gates) == L and sum(r.counts["gates"] for r in gates) == L
    misses = fused._case_tables.cache_info().misses
    assert len(tables) == misses == len(set(oracle_multipliers(eng))) < L
    assert all(r.counts == {"bytes": 2 << M} for r in tables)
    _, again = recorded(lambda: shor.find_period(eng, C, A, 0.7))
    assert "oracle.table" not in names(again) and names(again).count("oracle.gate") == L


def test_benes_attempt_spans_its_permutation_segments_as_oracle_gates():
    """A segment of camodc ops alone is an oracle.gate (the permutation
    kernel's segment on the card); a segment mixing them with other ops
    stays a fused.segment.  Its case tables record an oracle.table inside
    the oracle.gate on a miss only."""
    eng = engine(oracle="benes")
    fused._case_tables.cache_clear()
    _, recs = recorded(lambda: shor.find_period(eng, C, A, 0.7))
    plan = eng._plan(shor_circuit(C, A, L, M))
    pure = [ops for _, ops, _ in plan if all(op[0] == "camodc" for op in ops)]
    assert all(entry[0] == "fused" for entry in plan) and 0 < len(pure) < len(plan)
    gates = [r for r in recs if r.name == "oracle.gate"]
    assert len(gates) == len(pure) and [r.counts["gates"] for r in gates] == [len(ops) for ops in pure]
    assert names(recs).count("fused.segment") == len(plan) - len(pure)
    tables = [r for r in recs if r.name == "oracle.table"]
    assert 0 < len(tables) == fused._case_tables.cache_info().misses <= len(pure)
    assert all(names([p for p in gates if p.id == r.parent]) == ["oracle.gate"] for r in tables)
    assert all(r.counts["bytes"] in (2 << M, 6 << M) for r in tables)
    _, again = recorded(lambda: shor.find_period(eng, C, A, 0.7))
    assert "oracle.table" not in names(again)


def test_engine_plan_only_on_a_plan_cache_miss():
    eng = engine()
    _, first = recorded(lambda: shor.find_period(eng, C, A, 0.5))
    _, second = recorded(lambda: shor.find_period(eng, C, A, 0.5))
    _, other = recorded(lambda: shor.find_period(eng, C, 5, 0.5))
    assert names(first).count("engine.plan") == 1
    assert "engine.plan" not in names(second)
    assert names(other).count("engine.plan") == 1


@pytest.mark.parametrize("structured", [True, False])
def test_semiclassical_attempt_span_tree(structured):
    a = sc_base()
    rs = np.full(SC_L, 0.5, np.float32)
    out, recs = recorded(lambda: sc.run_semiclassical(SC_C, a, SC_L, SC_M, rs, structured=structured))
    (attempt,) = [r for r in recs if r.parent is None]
    assert attempt.name == "sc.attempt"
    top = children(recs, attempt)
    steps = [r for r in top if r.name == "sc.step"]
    assert len(steps) == SC_L
    for step, kind in zip(steps, out.oracles):
        parts = names(children(recs, step))
        want = ["sc.permute", "sc.rotate", "sc.branch_sums"] if kind == "structured" else ["sc.gather_pass"]
        assert parts == want + ["sc.collapse"]
    plans = [r for r in top if r.name == "sc.plan"]
    if structured:
        assert len(plans) == 1 and plans[0].counts["planned"] == out.oracles.count("structured") >= 2
    else:
        assert plans == [] and out.oracles == ["gather"] * SC_L


def test_sc_permute_span_counts_its_legs():
    """Each structured step's sc.permute span counts its offset-transpose
    launches: one a leg (collect where v > 1, deal where u > 1, the reversal
    alone where neither) of each of the two planes."""
    from quantumcomputer_tpu_torch.ops import modperm

    a = sc_base()
    rs = np.full(SC_L, 0.5, np.float32)
    out, recs = recorded(lambda: sc.run_semiclassical(SC_C, a, SC_L, SC_M, rs, structured=True))
    a_invs = [pow(pow(a, 1 << (SC_L - 1 - s), SC_C), -1, SC_C) for s in range(SC_L)]
    plans = [p for p in sc._structured_plans(SC_C, a_invs, SC_M) if p is not None]
    permutes = [r for r in recs if r.name == "sc.permute"]
    assert len(permutes) == len(plans) == out.oracles.count("structured") >= 2
    assert [r.counts["legs"] for r in permutes] == [2 * len(modperm.legs(p)) for p in plans]
    assert all(r.counts["legs"] in (2, 4) for r in permutes)


def test_profiler_trace_holds_the_nested_qc_ranges(tmp_path):
    eng = engine()
    fused._case_tables.cache_clear()
    path = tmp_path / "trace.json"
    with prof.trace(str(path)):  # spans record while the profiler does, with no switch
        shor.find_period(eng, C, A, 0.3)
    recs = prof.span_records(clear=True)
    assert names(recs).count("driver.attempt") == 1
    events = json.loads(path.read_text())["traceEvents"]
    qc = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith("qc."):
            qc.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert len(qc["qc.oracle.gate"]) == L
    assert len(qc["qc.oracle.table"]) == len(set(oracle_multipliers(eng))) == fused._case_tables.cache_info().misses
    assert len(qc["qc.engine.run"]) == len(qc["qc.measure.sample"]) == 1

    def inside(inner, outer):
        return all(any(a <= x and y <= b for a, b in qc[outer]) for x, y in qc[inner])

    assert inside("qc.engine.run", "qc.driver.attempt")
    assert inside("qc.fused.segment", "qc.engine.run") and inside("qc.oracle.gate", "qc.engine.run")
    assert inside("qc.oracle.table", "qc.oracle.gate") and inside("qc.driver.period", "qc.driver.attempt")
    assert prof.span_records() == []  # off again once the profiler stopped
    shor.find_period(eng, C, A, 0.3)
    assert prof.span_records() == []


def test_buffer_bound_and_dropped_count(monkeypatch):
    monkeypatch.setattr(prof, "MAX_SPANS", 3)
    prof.record_spans(True)
    for i in range(5):
        with prof.span("engine.run", counts_i=i):
            pass
    recs = prof.span_records()
    assert [r.counts["counts_i"] for r in recs] == [0, 1, 2]
    assert prof.dropped_spans() == 2
    prof.span_records(clear=True)
    assert prof.span_records() == [] and prof.dropped_spans() == 0


def test_summary_counts_and_a_span_that_raises():
    prof.record_spans(True)
    with prof.span("outer") as outer:
        outer.counts["planned"] = 4
        for _ in range(3):
            with prof.span("inner"):
                pass
        with pytest.raises(ValueError):
            with prof.span("inner"):
                raise ValueError("raised inside a span")
    recs = prof.span_records()
    assert [r.name for r in recs] == ["inner"] * 4 + ["outer"]
    assert all(r.parent == recs[-1].id for r in recs[:4]) and recs[-1].counts == {"planned": 4}
    summary = prof.span_summary(recs)
    assert list(summary) == ["inner", "outer"]
    assert summary["inner"]["count"] == 4 and summary["outer"]["count"] == 1
    assert summary["outer"]["host_ms"] >= summary["inner"]["host_ms"] >= 0.0
    assert summary["inner"]["device_ms"] is None
    with prof.span("after") as rec:  # the raising span left the stack
        assert rec.parent is None


def test_reset_span_and_the_measurement_counts():
    """engine.reset holds the reset inside engine.run; measure.sample
    carries the sampler's geometry (measure.sample_geometry): one flat
    block below 2^16 amplitudes, the hierarchical blocks at 2^16."""
    from quantumcomputer_tpu_torch.ops import measure

    for L_ in (L, 11):
        eng = StateVectorEngine(Register(L_, M), dtype="complex32")
        _, recs = recorded(lambda: shor.find_period(eng, C, A, 0.4))
        (run,) = [r for r in recs if r.name == "engine.run"]
        (reset,) = [r for r in recs if r.name == "engine.reset"]
        assert reset.parent == run.id and reset.counts == {}
        (sample,) = [r for r in recs if r.name == "measure.sample"]
        dim = 1 << (L_ + M)
        want = measure.sample_geometry(torch.zeros((2, dim), dtype=torch.bfloat16))
        assert (sample.counts["blocks"], sample.counts["block"]) == want
        assert want == ((1, dim) if dim < (1 << 16) else (8, 1 << 13))


def _moved_bytes(n, C_, A_list, controls, itemsize):
    """Bytes an in-place pass moves, by brute force: the elements whose
    value a run of the plain gates changes on a state of distinct values,
    read and written, in both planes."""
    from quantumcomputer_tpu_torch.ops import gates as tops

    planar = torch.arange(2 << n, dtype=torch.float64).view(2, -1)
    out = tops.apply_camodc_ladder_high_planes_(planar.clone(), C_, list(A_list), list(controls), M)
    return 2 * itemsize * int((out != planar).sum())


@pytest.mark.parametrize("budget_states,dtype", [(None, torch.float32), (1.5, torch.float32), (None, torch.bfloat16)])
def test_mhigh_oracle_spans_count_their_bytes(monkeypatch, budget_states, dtype):
    """Every m_high oracle.gate span carries `inplace` and `bytes`
    (oracle.pass_bytes): an out-of-place ladder every element of both
    planes read and written, an in-place walk, pair or strip run the
    elements it moves (held to a brute-force count).  Run merged, the
    adjacent walks and the ladder after them are one strip run, whose span
    counts the plan `entries` it took besides its `gates`: with two states
    fitting the float32 plan's 11 walks and its ladder of 4, bf16's 12
    walks and its ladder of 3; at 1.5 states the float32 walks (0-12) and
    then the in-place pair.  Run entry by entry (with norms), each entry is
    its own pass: with two states fitting a ladder out of place beside the
    walks, at 1.5 states in-place pairs."""
    from quantumcomputer_tpu_torch.sim import engine as eng_mod
    from quantumcomputer_tpu_torch.sim import statevec as sv

    L_ = 15
    n = L_ + M
    if budget_states is not None:
        monkeypatch.setenv("QC_TPU_HBM_BYTES", str(int(budget_states * (8 << n))))
    itemsize = torch.empty((), dtype=dtype).element_size()
    circuit = shor_circuit_mhigh(C, A, L_, M)
    plan = eng_mod.plan_circuit(circuit, 0, n, dtype, "cpu")
    entries = [e[1] for e in plan if e[0] != "fused" and e[1].name in ("camodc_high", "camodc_ladder_high")]
    strips = {(None, torch.float32): [(15, 12)], (1.5, torch.float32): [(13, 13)],
              (None, torch.bfloat16): [(15, 13)]}[budget_states, dtype]
    for norms in (None, []):
        state = sv.initial_planar(n, dtype, 1 << L_, "cpu")
        _, recs = recorded(lambda: eng_mod.apply_circuit_fused_(state, circuit, 0, plan, norms=norms))
        gates = [r for r in recs if r.name == "oracle.gate"]
        assert sum(r.counts["gates"] for r in gates) == L_
        assert sum(r.counts.get("entries", 1) for r in gates) == len(entries)
        if norms is not None:
            assert [r.counts["gates"] for r in gates] == [len(g.qubits) for g in entries]
        merged = [(r.counts["gates"], r.counts["entries"]) for r in gates if "entries" in r.counts]
        assert merged == ([] if norms is not None else strips)
        kinds = set()
        first = 0
        for r in gates:
            K = r.counts["gates"]
            controls = tuple(range(first, first + K))
            A_list = [pow(A, 1 << j, C) for j in controls]
            if r.counts["inplace"]:
                assert r.counts["bytes"] == _moved_bytes(n, C, A_list, controls, itemsize)
            else:
                assert K > 1 and r.counts["bytes"] == 2 * 2 * itemsize << n
            kinds.add((K > 1, r.counts["inplace"]))
            first += K
        want = {None: {(False, 1), (True, 0)}, 1.5: {(False, 1), (True, 1)}}[budget_states]
        assert kinds == ({(True, 1)} if norms is None else want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_segment_spans_count_their_matrix_groups(dtype):
    """A recording fused.segment span carries `groups`, the matrix-group
    ops (lanemat, rowmat, xtable) of the segment as apply_fused ran it: at
    n = 13 the bf16 plan's H and iQFT segments run on the tensor cores
    (groups > 0), while float32 keeps every segment in its butterfly form
    (0).  The count equals the grouping itself, segment by segment."""
    from quantumcomputer_tpu_torch.sim import engine as eng_mod
    from quantumcomputer_tpu_torch.sim import statevec as sv

    L_, M_ = 8, 5
    n = L_ + M_
    circuit = shor_circuit_mhigh(C, A, L_, M_)
    plan = eng_mod.plan_circuit(circuit, 0, n, dtype, "cpu")
    want = [sum(op[0] in fused.MATRIX_KINDS for op in fused.segment_ops(e[1], 0, dtype, n)[0])
            for e in plan if e[0] == "fused"]
    state = sv.initial_planar(n, dtype, 1 << L_, "cpu")
    _, recs = recorded(lambda: eng_mod.apply_circuit_fused_(state, circuit, 0, plan))
    got = [r.counts["groups"] for r in recs if r.name == "fused.segment"]
    assert got == want
    if dtype == torch.bfloat16:
        assert sum(g > 0 for g in got) == 2 and all(g in (0, 1, 2, 3) for g in got)
    else:
        assert got and not any(got)


def test_group_count_made_only_while_spans_record(monkeypatch):
    """With spans off the fused path makes no group count; recording, one
    a fused.segment span, and none for any other span."""
    calls = []
    real = fused.matrix_groups
    monkeypatch.setattr(fused, "matrix_groups", lambda *args: calls.append(args) or real(*args))
    eng = StateVectorEngine(Register(8, 5), dtype="complex32", layout="m_high")
    circuit = shor_circuit_mhigh(C, A, 8, 5)
    eng.run(circuit)
    assert calls == []
    _, recs = recorded(lambda: eng.run(circuit))
    segments = [r for r in recs if r.name == "fused.segment"]
    assert len(calls) == len(segments) > 0
    assert all("groups" not in r.counts for r in recs if r.name != "fused.segment")
