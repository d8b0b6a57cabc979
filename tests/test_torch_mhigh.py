"""The port's m_high layout (quantumcomputer_tpu_torch: shor_circuit_mhigh,
the engine's layout switch and oracle planner, shors_algorithm) against the JAX
package's, on the same circuits and draws.

Final planes are held to the JAX XLA engine at 1e-12 in complex128, through
both the torch backend and the cuda backend's planned path (whose kernels
take their plain versions on CPU tensors), and at complex64 to the JAX
pallas engine at its own test's 2e-5 (tests/test_mhigh_layout.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.models.circuit import Gate as JGate
from quantumcomputer_tpu.models.shor_circuit import shor_circuit_mhigh as jshor_circuit_mhigh
from quantumcomputer_tpu.ops import pallas_oracle as po
from quantumcomputer_tpu.sim import engine as jengine
from quantumcomputer_tpu_torch import Register, StateVectorEngine, interop, shor_circuit_mhigh, shors_algorithm
from quantumcomputer_tpu_torch.models.circuit import Gate
from quantumcomputer_tpu_torch.sim import engine as tengine


def _jax_final(C, a, L, M, dtype, backend, state=None):
    eng = jengine.StateVectorEngine(jengine.Register(L=L, M=M), dtype=dtype, backend=backend, layout="m_high")
    circuit = jshor_circuit_mhigh(C, a, L, M)
    return np.asarray(eng.run(circuit) if state is None else eng.run(circuit, jnp.asarray(state)))


def _jax_planned(circuit, M, n, itemsize, ladder_fits):
    """The JAX pallas path's oracle rewrite (engine.apply_circuit_planes)."""
    if ladder_fits:
        return jengine.fuse_oracle_ladders(
            circuit, M,
            eligible=lambda g: g.name == "camodc_high" and po.ladder_high_supported((g.qubits[0],), g.meta[2], n, itemsize),
        )
    circuit = jengine.fuse_oracle_ladders(
        circuit, M,
        eligible=lambda g: g.name == "camodc_high" and po.pair_member_supported(g.qubits[0], g.meta[2], n, itemsize),
        max_run=2,
    )
    split = []
    for g in circuit:
        if g.name == "camodc_ladder_high" and not po.pair_inplace_supported(g.qubits, g.meta[1], n, itemsize):
            split.extend(JGate("camodc_high", (c,), meta=(g.meta[0], A, g.meta[1])) for c, A in zip(g.qubits, g.meta[2:]))
        else:
            split.append(g)
    return tuple(split)


@pytest.mark.parametrize("C,a,L,M", [(15, 7, 3, 4), (33, 7, 5, 6), (8191, 3, 15, 13), (8187, 13, 17, 13)])
def test_shor_circuit_mhigh_crosses_interop(C, a, L, M):
    assert interop.circuit_from_reference(jshor_circuit_mhigh(C, a, L, M)) == shor_circuit_mhigh(C, a, L, M)


# (15, 7, 13, 4) is n = 17: controls 10, 11 and 12 pass the ladder predicate
# at f64 (11 and 12 at f32), so the cuda plan holds a fused ladder.
@pytest.mark.parametrize("C,a,L,M", [(15, 7, 3, 4), (21, 2, 4, 5), (33, 7, 5, 6), (15, 7, 13, 4)])
def test_mhigh_engine_complex128_matches_jax(C, a, L, M):
    want = _jax_final(C, a, L, M, jnp.complex128, "xla")
    circuit = shor_circuit_mhigh(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch", layout="m_high")
    np.testing.assert_allclose(interop.state_to_numpy(eng.run(circuit)), want, atol=1e-12)
    plan = tengine.plan_circuit(circuit, 0, L + M, torch.float64, "cpu")
    planned = tengine.apply_circuit_fused_(eng.initial_state(), circuit, 0, plan)
    np.testing.assert_allclose(interop.state_to_numpy(planned), want, atol=1e-12)
    ladders = [s[1].qubits for s in plan if s[0] == "single" and s[1].name == "camodc_ladder_high"]
    assert ladders == ([(10, 11, 12)] if L == 13 else [])


def test_mhigh_engine_complex64_matches_pallas():
    C, a, L, M = 33, 7, 9, 6
    want = _jax_final(C, a, L, M, jnp.complex64, "pallas")
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex64, backend="torch", layout="m_high")
    np.testing.assert_allclose(interop.state_to_numpy(eng.run(shor_circuit_mhigh(C, a, L, M))), want, atol=2e-5)
    planned = tengine.apply_circuit_fused_(eng.initial_state(), shor_circuit_mhigh(C, a, L, M), 0)
    np.testing.assert_allclose(interop.state_to_numpy(planned), want, atol=2e-5)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("ladder_fits", [True, False])
@pytest.mark.parametrize("C,a,L,M", [(8191, 3, 15, 13), (8187, 13, 17, 13), (33, 7, 15, 6), (15, 7, 13, 4)])
def test_oracle_plan_matches_jax(C, a, L, M, ladder_fits, itemsize):
    n = L + M
    want = _jax_planned(jshor_circuit_mhigh(C, a, L, M), 0, n, itemsize, ladder_fits)
    got = tengine.fuse_oracles(shor_circuit_mhigh(C, a, L, M), 0, n, itemsize, ladder_fits)
    assert got == interop.circuit_from_reference(want)


def test_ceiling_branch_pairs_and_splits_like_jax(monkeypatch):
    """The JAX suite's memory-ceiling circuit (tests/test_mhigh_layout.py):
    with the budget forced below two states the planner pairs (13, 14) in
    place and leaves 12 and 11 single; the run matches the JAX XLA engine."""
    C, M, L = 33, 6, 15
    n = L + M
    controls = (13, 14, 12, 11)
    jcirc = tuple(JGate("camodc_high", (c,), meta=(C, pow(29, 1 + (c % 3), C), M)) for c in controls)
    circ = interop.circuit_from_reference(jcirc)
    state_bytes = 2 * (1 << n) * 4
    monkeypatch.setenv("QC_TPU_HBM_BYTES", str(state_bytes * 3 // 2))  # one state fits, two do not
    plan = tengine.plan_circuit(circ, 0, n, torch.float32, "cpu")
    assert [s[1].name for s in plan] == ["camodc_ladder_high", "camodc_high", "camodc_high"]
    assert tengine.fuse_oracles(circ, 0, n, 4, False) == interop.circuit_from_reference(_jax_planned(jcirc, 0, n, 4, False))
    monkeypatch.delenv("QC_TPU_HBM_BYTES")
    (single,) = tengine.plan_circuit(circ, 0, n, torch.float32, "cpu")
    assert single[1].qubits == controls  # two states fit: all four fuse into one ladder

    rng = np.random.default_rng(11)
    psi = rng.standard_normal((2, 1 << n))
    psi /= np.sqrt(np.sum(psi * psi))
    jeng = jengine.StateVectorEngine(jengine.Register(L=L, M=M), dtype=jnp.complex128, backend="xla", layout="m_high")
    want = np.asarray(jeng.run(jcirc, jnp.asarray(psi)))
    got = tengine.apply_circuit_fused_(interop.state_from_numpy(psi), circ, 0, plan)
    np.testing.assert_allclose(interop.state_to_numpy(got), want, atol=1e-12)


def test_ladder_ping_pong_and_copy_back():
    """An odd number of out-of-place ladders leaves the result in the
    scratch buffer: apply_circuit_fused_ returns it, and run() copies it
    back into a state the caller passed."""
    C, a, L, M = 15, 7, 13, 4
    circuit = shor_circuit_mhigh(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch", layout="m_high")
    want = eng.run(circuit)
    start = eng.initial_state()
    out = tengine.apply_circuit_fused_(start, circuit, 0)
    assert out is not start  # one ladder: the result is in the scratch buffer
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-12)
    eng.backend = "cuda"  # the cuda backend's run() on CPU tensors (plain kernels)
    state = eng.initial_state()
    assert eng.run(circuit, state) is state
    assert torch.equal(state, out)
    assert torch.equal(eng.run(circuit), out)


def test_logical_index_and_injected_draw_match_jax():
    C, a, L, M = 15, 7, 6, 4
    jeng = jengine.StateVectorEngine(jengine.Register(L=L, M=M), dtype=jnp.complex128, layout="m_high")
    psi = np.asarray(jeng.run(jshor_circuit_mhigh(C, a, L, M)))
    cum = np.cumsum(psi[0] ** 2 + psi[1] ** 2)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch", layout="m_high")
    assert eng.initial_state()[0].nonzero().item() == 1 << L
    circuit = shor_circuit_mhigh(C, a, L, M)
    for r in (0.05, 0.3, 0.62, 0.97):
        phys = int(np.searchsorted(cum, r * cum[-1], side="left"))
        got = eng.run_and_measure_index(circuit, r)
        assert got == phys
        assert eng.logical_index(got) == jeng.logical_index(phys)
    for phys in range(0, 1 << (L + M), 37):
        assert eng.logical_index(phys) == jeng.logical_index(phys)


def test_shors_algorithm_mhigh_factors_15():
    res = shors_algorithm(15, 3, 4, forced_trial_int=7, seed=0, dtype=torch.complex128, layout="m_high")
    assert res.ok and res.factors == (5, 3)
    with pytest.raises(ValueError, match="unknown layout"):
        StateVectorEngine(Register(L=3, M=4), backend="torch", layout="sideways")


def test_unfused_gate_on_a_planar_state_dispatches_like_jax():
    """apply_gate_planes_ routes a lone high control to the masked walk, a
    low one to the cycle walk, a qualifying pair to the in-place pair, any
    other run to the ladder; all give the plain result."""
    from quantumcomputer_tpu_torch.ops import gates as tops

    C, M, n = 33, 6, 21
    rng = np.random.default_rng(12)
    psi = rng.standard_normal((2, 1 << n)).astype(np.float32)
    gates = [
        Gate("camodc_high", (13,), meta=(C, 29, M)),
        Gate("camodc_high", (3,), meta=(C, 29, M)),
        Gate("camodc_ladder_high", (13, 14), meta=(C, M, 29, 7)),
        Gate("camodc_ladder_high", (2, 9, 4), meta=(C, M, 29, 7, 4)),
    ]
    for g in gates:
        want = interop.state_from_numpy(psi)
        if g.name == "camodc_high":
            tops.apply_camodc_high_planes_(want, C, g.meta[1], g.qubits[0], M)
        else:
            tops.apply_camodc_ladder_high_planes_(want, C, g.meta[2:], g.qubits, M)
        state = interop.state_from_numpy(psi)
        assert tengine.apply_gate_planes_(state, g, 0) is state
        assert torch.equal(state, want)
