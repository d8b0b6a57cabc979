"""The port's Benes oracle path (--oracle benes) against the JAX package's, on
the CPU: the host router (ops/benes.py), the fused segment's camodc op
(its plain Benes version against the JAX kernel in interpret mode), the
planner's cap and tile budget, the engine end to end, and the other engine
options of this slice (strict_reference, dd64, nan_checks).

Tolerances: the router and every pure data movement exactly; segments mixed
with gates 3e-5 (the JAX fused suite's ATOL) and the Shor circuit 2e-5 (the
JAX suite's bound for it); the strict oracle exactly at complex128, circuits
at complex128 and dd64 1e-12 (against the JAX package's double-float
engines)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.algorithms import semiclassical as jsc
from quantumcomputer_tpu.models import circuit as jcir
from quantumcomputer_tpu.models.shor_circuit import shor_circuit as jshor_circuit
from quantumcomputer_tpu.ops import benes as jbenes
from quantumcomputer_tpu.ops import gates as xops
from quantumcomputer_tpu.ops import pallas_fused as pf
from quantumcomputer_tpu.sim.dd_engine import DDStateVectorEngine
from quantumcomputer_tpu.sim.engine import Register as JRegister
from quantumcomputer_tpu.sim.engine import StateVectorEngine as JEngine
from quantumcomputer_tpu_torch import Register, StateVectorEngine, interop, shor_circuit
from quantumcomputer_tpu_torch.algorithms import semiclassical as sc
from quantumcomputer_tpu_torch.algorithms import shor
from quantumcomputer_tpu_torch.models import circuit as cir
from quantumcomputer_tpu_torch.ops import benes, fused
from quantumcomputer_tpu_torch.ops import gates as tops
from quantumcomputer_tpu_torch.sim import engine as tengine

N = 16
# tests/test_pallas_fused.py:205: (C, A, M, control)
MODMUL_CASES = [(15, 7, 4, 9), (15, 13, 4, 15), (33, 29, 6, 13), (251, 13, 8, 14)]


def _planes32(rng, n):
    psi = rng.standard_normal((2, 1 << n))
    return (psi / np.sqrt(np.sum(psi * psi))).astype(np.float32)


def _assert_same_route(pi):
    got, want = benes.benes_route(pi), jbenes.benes_route(pi)
    assert [b for b, _ in got] == [b for b, _ in want]
    for (_, m_got), (_, m_want) in zip(got, want):
        np.testing.assert_array_equal(m_got, m_want)


@pytest.mark.parametrize("k", range(1, 11))
def test_route_of_random_permutations_matches_jax(k):
    rng = np.random.default_rng(k)
    for _ in range(3):
        _assert_same_route(rng.permutation(1 << k))
    assert benes.benes_stage_count(k) == jbenes.benes_stage_count(k) == len(benes.benes_route(np.arange(1 << k)))


@pytest.mark.parametrize("C,A,M,c_q", MODMUL_CASES)
def test_route_of_modmul_permutations_matches_jax(C, A, M, c_q):
    f = np.arange(1 << M)
    _assert_same_route(np.where(f < C, (A * f) % C, f))
    stages = fused.camodc_route(C, A, M)
    assert len(stages) == 2 * M - 1 and all(m.dtype == bool for _, m in stages)


@pytest.mark.parametrize("C,A,M,c_q", MODMUL_CASES)
def test_plain_camodc_segment_equals_the_pallas_kernel(C, A, M, c_q):
    """Data movement only: the port's plain Benes version equals the JAX
    kernel (interpret mode) exactly, and both equal the gather."""
    planes = _planes32(np.random.default_rng(C + c_q), N)
    jgates = (jcir.CAMODC(C, A, c_q),)
    re, im = jnp.asarray(planes[0]), jnp.asarray(planes[1])
    jsegs = pf.plan_circuit(jgates, N, M, fuse_oracle=True)
    for _, ops, axes in jsegs:
        re, im = pf.apply_fused(re, im, ops, axes, N, M)
    segs = fused.plan_circuit(interop.circuit_from_reference(jgates), N, M, fuse_oracle=True)
    assert [s[1] for s in segs] == [s[1] for s in jsegs] == [(("camodc", c_q, C, A % C),)]
    got = fused.plain_segment(interop.state_from_numpy(planes), segs[0][1], M)
    np.testing.assert_array_equal(interop.state_to_numpy(got), np.stack([re, im]))
    gather = tops.apply_c_amodc_planes_(interop.state_from_numpy(planes), C, A, c_q, M)
    assert torch.equal(got, gather)


def test_mixed_h_and_oracle_run_matches_the_pallas_kernel():
    """tests/test_pallas_fused.py's mixed run: H gates and the modexp ladder
    fused together, within the JAX suite's 3e-5."""
    C, a, M = 33, 7, 6
    jgates = []
    for j, hq in enumerate((13, 14, 15, 7)):
        jgates += [jcir.H(hq), jcir.CAMODC(C, pow(a, 1 << j, C), M + j)]
    planes = _planes32(np.random.default_rng(5), N)
    re, im = jnp.asarray(planes[0]), jnp.asarray(planes[1])
    for _, ops, axes in pf.plan_circuit(tuple(jgates), N, M, fuse_oracle=True):
        re, im = pf.apply_fused(re, im, ops, axes, N, M)
    state = interop.state_from_numpy(planes)
    plan = fused.plan_circuit(interop.circuit_from_reference(tuple(jgates)), N, M, fuse_oracle=True)
    assert all(s[0] == "fused" for s in plan)
    for _, ops, _axes in plan:
        state = fused.plain_segment(state, ops, M)
    np.testing.assert_allclose(interop.state_to_numpy(state), np.stack([re, im]), atol=3e-5)


def _segment_fits(ops, axes, n, M, dtype):
    t, high, *_ = fused.host_descriptor(ops, axes, n, M, dtype)
    tile_bits = fused.segment_tile_bits(ops, M, fused.TILE_BITS[dtype])
    assert t + len(high) <= tile_bits <= 13
    if any(op[0] == "camodc" for op in ops):
        assert t >= M
    slot = 2 * (1 << (t + len(high))) * torch.empty((), dtype=dtype).element_size()
    assert slot <= 128 << 10  # one ring slot; the kernel takes two when they fit 128 KB


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_planner_cap_and_tile_budget_match_jax(dtype):
    """JAX test_planner_camodc_table_budget: at most MAX_CAMODC_PER_SEGMENT
    oracles a segment, grouped as the JAX planner groups them; every
    segment's tile holds its work blocks within the budget."""
    C, M = 251, 8
    jgates = tuple(jcir.CAMODC(C, 13 + 2 * j, 14) for j in range(5))
    jsegs = pf.plan_circuit(jgates, N, M, fuse_oracle=True)
    segs = fused.plan_circuit(interop.circuit_from_reference(jgates), N, M, fused.TILE_BITS[dtype], fuse_oracle=True)
    assert fused.MAX_CAMODC_PER_SEGMENT == pf.MAX_CAMODC_PER_SEGMENT
    assert all(s[0] == "fused" for s in segs)
    assert [s[1] for s in segs] == [s[1] for s in jsegs]
    for _, ops, axes in segs:
        assert sum(op[0] == "camodc" for op in ops) <= fused.MAX_CAMODC_PER_SEGMENT
        _segment_fits(ops, axes, N, M, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C,a,L,M", [(33, 7, 9, 6), (8191, 3, 15, 13)])
def test_shor_plan_op_order_matches_jax(dtype, C, a, L, M):
    """The oracles of the Shor circuit fuse, two to a segment, in the JAX
    plan's order; segment cuts made by axes may differ (the tile budgets
    differ), the op sequence does not."""
    n = L + M
    circuit = shor_circuit(C, a, L, M)
    segs = fused.plan_circuit(circuit, n, M, fused.TILE_BITS[dtype], fuse_oracle=True)
    jsegs = pf.plan_circuit(jshor_circuit(C, a, L, M), n, M, fuse_oracle=True)
    assert all(s[0] == "fused" for s in segs)
    assert [op for s in segs for op in s[1]] == [op for s in jsegs for op in s[1]]

    def oracle_groups(plan):
        return [[op for op in s[1] if op[0] == "camodc"] for s in plan if any(op[0] == "camodc" for op in s[1])]

    assert oracle_groups(segs) == oracle_groups(jsegs)
    for _, ops, axes in segs:
        _segment_fits(ops, axes, n, M, dtype)


def test_without_fuse_oracle_the_oracle_stays_a_gather():
    g = cir.CAMODC(15, 7, 9)
    assert fused.gate_to_op(g) is None and fused.gate_to_op(g, 4) is None
    assert fused.gate_to_op(g, 14, True) is None  # M > 13: the JAX condition
    assert fused.gate_to_op(g, 4, True) == pf.gate_to_op(jcir.CAMODC(15, 7, 9), 4, True) == ("camodc", 9, 15, 7)
    assert fused.gate_segment(g, 14, 12) is None
    with pytest.raises(ValueError, match="L register"):
        fused.host_descriptor((("camodc", 2, 15, 7),), (), 14, 4, torch.float32)


def test_engine_shor_with_benes_oracle_matches_pallas():
    """shor_circuit(33, 7, 9, 6) through the cuda backend's planned path
    (its plain versions, on CPU tensors) with the oracles fused, against
    the JAX pallas engine with oracle="benes", within 2e-5."""
    C, a, L, M = 33, 7, 9, 6
    jeng = JEngine(JRegister(L=L, M=M), dtype=jnp.complex64, backend="pallas", oracle="benes")
    want = np.asarray(jeng.run(jshor_circuit(C, a, L, M)))
    eng = StateVectorEngine(Register(L=L, M=M), backend="torch")
    circuit = shor_circuit(C, a, L, M)
    plan = tengine.plan_circuit(circuit, M, L + M, torch.float32, "cpu", fuse_oracle=True)
    assert not any(s[0] == "single" for s in plan)
    got = tengine.apply_circuit_fused_(eng.initial_state(), circuit, M, plan)
    np.testing.assert_allclose(interop.state_to_numpy(got), want, atol=2e-5)
    assert StateVectorEngine(Register(L=L, M=M), backend="torch", oracle="benes").oracle == "benes"
    with pytest.raises(ValueError, match="unknown oracle"):
        StateVectorEngine(Register(L=L, M=M), backend="torch", oracle="ladder")


@pytest.mark.parametrize("C,a,c_q,M,n", [(15, 7, 5, 4, 8), (21, 2, 5, 4, 8), (33, 29, 7, 6, 9)])
def test_strict_oracle_matches_jax(C, a, c_q, M, n):
    """The warn-and-wrap scatter exactly at complex128, the 2^M < C case
    (21 at M = 4) included."""
    rng = np.random.default_rng(C)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    want = np.asarray(xops.apply_c_amodc_strict(jnp.asarray(psi), C, a, c_q, M))
    got = tops.apply_c_amodc_strict(torch.from_numpy(psi), C, a, c_q, M)
    np.testing.assert_array_equal(got.numpy(), want)
    f = np.arange(1 << M)
    np.testing.assert_array_equal(tops.modmul_permutation(C, a, M), np.where(f < C, a % C * f % C, f))


def test_strict_reference_engine_matches_jax():
    C, a, L, M = 21, 2, 4, 4  # 2^M < C: non-unitary, as in the reference
    jeng = JEngine(JRegister(L=L, M=M), dtype=jnp.complex128, strict_reference=True)
    want = np.asarray(jeng.run(jshor_circuit(C, a, L, M)))
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, strict_reference=True)
    assert eng.backend == "torch"
    np.testing.assert_allclose(interop.state_to_numpy(eng.run(shor_circuit(C, a, L, M))), want, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="strict_reference mode requires"):
        StateVectorEngine(Register(L=L, M=M), backend="torch", layout="m_high", strict_reference=True)
    with pytest.raises(ValueError, match="conflicts with the provided engine"):
        eng = StateVectorEngine(Register(L=3, M=4))
        shor.shors_algorithm(15, 3, 4, forced_trial_int=7, engine=eng, strict_reference=True)


def test_dd64_full_engine_matches_jax_dd():
    C, a, L, M = 15, 7, 3, 4
    jeng = DDStateVectorEngine(JRegister(L=L, M=M))
    want = jeng.to_numpy(jeng.run(jshor_circuit(C, a, L, M)))
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch")
    np.testing.assert_allclose(eng.to_numpy(eng.run(shor_circuit(C, a, L, M))), want, rtol=0, atol=1e-12)
    dd = shor.shors_algorithm(C, L, M, forced_trial_int=a, seed=4, dtype="dd64", backend="torch")
    c128 = shor.shors_algorithm(C, L, M, forced_trial_int=a, seed=4, dtype=torch.complex128, backend="torch")
    assert [r.measured_index for r in dd.attempts] == [r.measured_index for r in c128.attempts]
    with pytest.raises(ValueError, match="dd64 parity mode"):
        shor.shors_algorithm(C, L, M, dtype="dd64", layout="m_high")


def test_dd64_semiclassical_matches_jax_dd():
    C, a, L, M = 21, 2, 4, 5
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        rs = np.asarray(jax.random.uniform(key, (L,), jnp.float32), np.float64)  # the JAX dd driver's draws
        want = jsc.run_semiclassical(C, a, L, M, key, dtype="dd64")
        got = sc.run_semiclassical(C, a, L, M, rs, dtype="dd64")
        assert got.bits == want.bits
        np.testing.assert_allclose(got.branch_probs, want.branch_probs, rtol=0, atol=1e-12)


def test_nan_checks_print_the_jax_line(capfd):
    C, a, L, M = 15, 7, 3, 4
    circuit = tuple(g for g in shor_circuit(C, a, L, M) if g.name != "camodc")
    jcircuit = tuple(g for g in jshor_circuit(C, a, L, M) if g.name != "camodc")
    planes = np.random.default_rng(1).standard_normal((2, 1 << (L + M)))
    planes[0, 3] = np.nan
    jeng = JEngine(JRegister(L=L, M=M), dtype=jnp.complex128, nan_checks=True)
    np.asarray(jeng.run(jcircuit, jnp.asarray(planes)))
    want = [line for line in capfd.readouterr().out.splitlines() if line.startswith("***")]
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch", nan_checks=True)
    eng.run(circuit, interop.state_from_numpy(planes))
    got = [line for line in capfd.readouterr().out.splitlines() if line.startswith("***")]
    assert got == want and len(got) == len(circuit)
    assert got[0] == f"*** non-finite amplitudes after gate 0 {circuit[0].name}{circuit[0].qubits}"
    StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch", nan_checks=True).run(circuit)
    assert "***" not in capfd.readouterr().out
    tengine.apply_circuit_fused_(interop.state_from_numpy(planes), circuit, M, nan_checks=True)
    lines = capfd.readouterr().out.splitlines()
    first = fused.plan_circuit(circuit, L + M, M)[0]
    assert lines and lines[0] == f"*** non-finite amplitudes after fused segment 0 ({len(first[1])} ops)"
