"""QAOA's card route on the CPU: the adjoint step (variational.qaoa_step on
the engine's torch backend, the passes' plain versions) against the tape
evolution (algorithms/qaoa_plain.py), the passes against their definitions,
the cost table, the Adam loop, and the engine's bounded plan cache and
adjoint span.

Tolerances: complex128 runs agree with the float64 tape to 1e-10 (both are
exact up to float64 rounding over a few hundred passes).  complex64 runs
agree to 1e-5 of the cut and 1e-4 of the largest gradient component: each
of the step's ~8 n p + 4 p passes rounds every amplitude to float32 (unit
roundoff 6e-8), and a component's error is a difference of two such
inner products.
"""

import numpy as np
import pytest
import torch

from quantumcomputer_tpu_torch.algorithms import qaoa_plain
from quantumcomputer_tpu_torch.algorithms import variational as var
from quantumcomputer_tpu_torch.models import circuit as cir
from quantumcomputer_tpu_torch.ops import fused
from quantumcomputer_tpu_torch.ops import qaoa as qops
from quantumcomputer_tpu_torch.sim import engine as eng_mod
from quantumcomputer_tpu_torch.sim import statevec as sv
from quantumcomputer_tpu_torch.utils import profiling

TOL = {torch.complex128: (1e-10, 1e-10), torch.complex64: (1e-5, 1e-4)}
CASES = [(6, 1, 0), (6, 4, 1), (8, 2, 2), (8, 3, 3), (10, 1, 4), (10, 4, 5)]


def _angles(p, seed):
    return np.random.default_rng(seed).uniform(0.05, 0.9, (2, p))


def _tape(n, edges, prm):
    cost = torch.from_numpy(var.maxcut_cost_vector(n, edges)).double()
    return qaoa_plain.cut_and_gradient(cost, n, prm)


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("n,p,seed", CASES)
def test_adjoint_step_matches_the_tape(n, p, seed, dtype):
    edges = var.random_regular_graph(n, 3, seed)
    prm = _angles(p, seed)
    e, g = var.qaoa_step(var.qaoa_engine(n, dtype=dtype, device="cpu"), qops.CostTable(n, edges, "cpu"), prm)
    e_ref, g_ref = _tape(n, edges, prm)
    cut_tol, grad_tol = TOL[dtype]
    assert abs(e - e_ref) <= cut_tol * abs(e_ref)
    assert np.abs(g - g_ref).max() <= grad_tol * np.abs(g_ref).max()


def test_adjoint_step_complex32_rounds_but_follows():
    n, p = 8, 2
    edges = var.random_regular_graph(n, 3, 7)
    prm = _angles(p, 7)
    e, g = var.qaoa_step(var.qaoa_engine(n, dtype="complex32", device="cpu"), qops.CostTable(n, edges, "cpu"), prm)
    e_ref, g_ref = _tape(n, edges, prm)
    assert abs(e - e_ref) <= 2e-2 * abs(e_ref)
    assert np.abs(g - g_ref).max() <= 0.2 * np.abs(g_ref).max()


def test_twenty_adam_steps_follow_the_tape_trajectory():
    n, p = 8, 3
    edges = var.random_regular_graph(n, 3, 11)
    params0 = var.qaoa_initial_parameters(p, 11)
    run = var.QAOAOptimizer(var.qaoa_engine(n, dtype=torch.complex128, device="cpu"), qops.CostTable(n, edges, "cpu"),
                            params0.numpy(), learning_rate=0.05)
    trace = [run.step()[0] for _ in range(20)]
    cost = torch.from_numpy(var.maxcut_cost_vector(n, edges)).double()
    params, want = qaoa_plain.optimize(cost, n, params0.clone(), 20, 0.05)
    np.testing.assert_allclose(trace, want, rtol=1e-6)
    np.testing.assert_allclose(run.params.detach().numpy(), params.numpy(), atol=1e-6)


def test_qaoa_maxcut_keeps_the_tape_route_on_the_cpu():
    edges = [(0, 1), (1, 2), (2, 3), (3, 0)]
    res = var.qaoa_maxcut(4, edges, p=2, steps=40, learning_rate=0.08, seed=2, device="cpu")
    params, trace = qaoa_plain.optimize(torch.from_numpy(var.maxcut_cost_vector(4, edges)), 4,
                                        var.qaoa_initial_parameters(2, 2), 40, 0.08)
    np.testing.assert_array_equal(res.parameters, params.numpy())
    np.testing.assert_array_equal(res.expectations, trace)


# -- the passes against their definitions ----------------------------------------------------


def _state(n, dtype, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    z /= np.linalg.norm(z)
    return z, torch.from_numpy(np.stack([z.real, z.imag])).to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 1e-6), (torch.bfloat16, 2e-2)])
def test_passes_against_their_definitions(dtype, tol):
    n = 7
    edges = var.random_regular_graph(8, 3, 3)
    edges = [e for e in edges if max(e) < n] + [(0, 6, 2)]
    table = qops.CostTable(n, edges, "cpu")
    c = var.maxcut_cost_vector(n, edges).astype(np.float64)
    np.testing.assert_array_equal(table.levels.numpy(), c.astype(np.uint8))
    z, psi = _state(n, dtype, 1)
    y, lam = _state(n, dtype, 2)
    z, y = (sv.to_numpy_complex(t).astype(np.complex128) for t in (psi, lam))  # the rounded inputs
    gamma = 0.37
    ph = qops.phase_tables(table.K, [gamma], -1.0, dtype, "cpu")[0]
    got = sv.to_numpy_complex(qops.apply_phase(psi.clone(), table, ph))
    assert np.abs(got - z * np.exp(-1j * gamma * c)).max() <= tol * np.abs(z).max()
    out = torch.empty_like(psi)
    e = float(qops.expect(psi, table, out))
    assert abs(e - float(np.sum(np.abs(z) ** 2 * c))) <= 1e-12 * e
    assert np.abs(sv.to_numpy_complex(out) - c * z).max() <= tol * np.abs(c * z).max()
    back = qops.phase_tables(table.K, [gamma], 1.0, dtype, "cpu")[0]
    for write in (True, False):
        a, b = psi.clone(), lam.clone()
        s = float(qops.cost_grad(a, b, table, back, write))
        assert abs(s - float(np.sum(c * (np.conj(y) * z).imag))) <= 1e-12
        want = (z * np.exp(1j * gamma * c), y * np.exp(1j * gamma * c)) if write else (z, y)
        for t, w in zip((a, b), want):
            assert np.abs(sv.to_numpy_complex(t) - w).max() <= tol * np.abs(w).max()
    idx = np.arange(1 << n)
    for group in qops.mixer_groups(n, dtype):
        want = sum(float(np.sum((np.conj(y) * z[idx ^ (1 << q)]).imag)) for q in group[2])
        assert abs(float(qops.mixer_grad(psi, lam, group)) - want) <= 1e-12


@pytest.mark.parametrize("n", [1, 5, 12, 13, 18, 30, 31])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_mixer_groups_cover_every_qubit_once_within_a_tile(n, dtype):
    groups = qops.mixer_groups(n, dtype)
    qubits = [q for g in groups for q in g[2]]
    assert sorted(qubits) == list(range(n))
    for t, axes, qs in groups:
        assert t + len(axes) <= qops.TILE_BITS[dtype] and all(a >= t for a in axes)
        assert all(q < t or q in axes for q in qs)


def test_cost_table_takes_whole_weights_only():
    with pytest.raises(ValueError, match="whole weights"):
        qops.CostTable(3, [(0, 1, 0.5)], "cpu")
    with pytest.raises(ValueError, match="sum to 300"):
        qops.CostTable(3, [(0, 1, 300)], "cpu")
    with pytest.raises(ValueError, match="distinct qubits"):
        qops.CostTable(3, [(1, 1)], "cpu")
    assert qops.CostTable(3, [(0, 1, 2.0), (1, 2)], "cpu").levels.tolist() == [0, 2, 3, 1, 1, 3, 2, 0]


@pytest.mark.parametrize("n,dtype", [(6, torch.complex128), (10, torch.complex64), (14, torch.complex64),
                                     (16, torch.complex128), (14, "complex32")])
def test_mixer_takes_its_angle_at_launch(n, dtype):
    """apply_mixer (the segments planned once, the angle's values at launch)
    against engine.run of the n RX(2 beta) gates, for angles other than the
    one the plan was made at, 0 and a negative one among them."""
    eng = var.qaoa_engine(n, dtype=dtype, device="cpu")
    rdtype = eng.real_dtype
    segments = qops.mixer_segments(n, rdtype)
    assert sorted(op[1] for ops, _ in segments for op in ops) == list(range(n))
    assert (len(segments) == 1) == (n <= fused.TILE_BITS[rdtype])
    betas = [0.0, 0.11, -0.7, 1.9]
    values = qops.mixer_values(n, betas, rdtype, "cpu")
    assert values.shape == (len(betas), n, fused.OPF_STRIDE) and values.dtype == sv.compute_dtype(rdtype)
    _, psi0 = _state(n, rdtype, n)
    tol = {torch.float64: 1e-13, torch.float32: 1e-6, torch.bfloat16: 2e-2}[rdtype]
    for j, b in enumerate(betas):
        got = qops.apply_mixer(psi0.clone(), values[j])
        want = eng.run(tuple(cir.RX(q, 2.0 * b) for q in range(n)), psi0.clone())
        assert (got.double() - want.double()).abs().max() <= tol


def test_segment_values_are_checked():
    n = 5
    (ops, axes), = qops.mixer_segments(n, torch.float32)
    psi = qops.plus_state(n, torch.float32, "cpu")
    with pytest.raises(ValueError, match="must be a"):
        fused.apply_segment_values(psi, ops, axes, 0, torch.zeros((n, fused.OPF_STRIDE), dtype=torch.float64))
    with pytest.raises(ValueError, match="must be a"):
        fused.apply_segment_values(psi, ops, axes, 0, torch.zeros((n - 1, fused.OPF_STRIDE)))
    with pytest.raises(ValueError, match="values at launch"):
        fused.apply_segment_values(psi, (("iqft", 3),), (), 0, torch.zeros((1, fused.OPF_STRIDE)))


@pytest.mark.parametrize("n,d,seed", [(30, 3, 2021), (10, 3, 0), (12, 4, 5)])
def test_random_regular_graph(n, d, seed):
    edges = var.random_regular_graph(n, d, seed)
    assert edges == var.random_regular_graph(n, d, seed) == sorted(edges)
    assert len(edges) == n * d // 2 and len(set(edges)) == len(edges) and all(a < b for a, b in edges)
    assert np.bincount(np.array(edges).ravel(), minlength=n).tolist() == [d] * n


# -- spans and the engine ------------------------------------------------------------------


def test_qaoa_step_spans():
    n, p = 6, 2
    profiling.record_spans(True)
    profiling.span_records(clear=True)
    try:
        var.qaoa_step(var.qaoa_engine(n, dtype=torch.complex64, device="cpu"),
                      qops.CostTable(n, var.random_regular_graph(n, 3, 1), "cpu"), _angles(p, 1))
        recs = profiling.span_records(clear=True)
    finally:
        profiling.record_spans(False)
    names = [r.name for r in recs]
    root = [r for r in recs if r.name == "qaoa.step"]
    assert len(root) == 1 and root[0].parent is None
    for name, count in (("qaoa.forward", 1), ("qaoa.expect", 1), ("qaoa.backward", 1), ("qaoa.cost", p), ("qaoa.grad", 2 * p)):
        assert names.count(name) == count, name
    grads = [r.counts for r in recs if r.name == "qaoa.grad"]
    assert sorted(g["passes"] for g in grads) == [1] * p + [len(qops.mixer_groups(n, torch.float32))] * p
    assert all(g["bytes"] > 0 for g in grads)


def test_engine_adjoint_span_counts_the_dagger_gates():
    e = eng_mod.StateVectorEngine(eng_mod.Register(3, 0), backend="torch")
    circuit = (cir.H(0), cir.CNOT(0, 1), cir.RX(2, 0.3), cir.CPHASE(1, 2, 0.7))
    planes = e.zero_state().requires_grad_()
    profiling.record_spans(True)
    profiling.span_records(clear=True)
    try:
        e.run(circuit, planes).square().sum().backward()
        recs = profiling.span_records(clear=True)
    finally:
        profiling.record_spans(False)
    adj = [r for r in recs if r.name == "engine.adjoint"]
    assert len(adj) == 1 and adj[0].counts["gates"] == len(circuit)
    assert any(r.name == "engine.run" and r.parent == adj[0].id for r in recs)


def test_engine_plan_cache_keeps_the_circuits_used_last(monkeypatch):
    monkeypatch.setattr(eng_mod, "PLAN_CACHE", 4)
    monkeypatch.setattr(eng_mod, "plan_circuit", lambda circuit, *args: [("single", g) for g in circuit])
    e = eng_mod.StateVectorEngine(eng_mod.Register(2, 0), backend="torch")
    circuits = [(cir.RX(0, 0.1 * k),) for k in range(6)]
    for c in circuits[:4]:
        e._plan(c)
    e._plan(circuits[0])  # a hit moves it to the end
    e._plan(circuits[4])
    e._plan(circuits[5])
    assert list(e._plans) == [circuits[3], circuits[0], circuits[4], circuits[5]]
