"""The port's engine (quantumcomputer_tpu_torch/sim/engine.py) against the
JAX package's StateVectorEngine: the full Shor circuit from the same reset,
compared on the final planes.

complex128 is held to 1e-12 against the JAX xla backend (x64); complex64 at
n = 16 to the JAX fused suite's 3e-5 against the JAX pallas backend, whose
kernels run in interpret mode on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.models.shor_circuit import shor_circuit as jshor_circuit
from quantumcomputer_tpu.sim.engine import Register as JRegister
from quantumcomputer_tpu.sim.engine import StateVectorEngine as JEngine
from quantumcomputer_tpu_torch import Register, StateVectorEngine, interop, shor_circuit
from quantumcomputer_tpu_torch.ops import fused
from quantumcomputer_tpu_torch.sim import engine as tengine
from quantumcomputer_tpu_torch.sim import statevec as sv


def _jax_final(C, a, L, M, dtype, backend):
    eng = JEngine(JRegister(L=L, M=M), dtype=dtype, backend=backend)
    return np.asarray(eng.run(jshor_circuit(C, a, L, M)))


@pytest.mark.parametrize("C,a,L,M", [(15, 7, 3, 4), (21, 2, 4, 5)])
def test_shor_circuit_complex128_matches_jax(C, a, L, M):
    want = _jax_final(C, a, L, M, jnp.complex128, "xla")
    circuit = interop.circuit_from_reference(jshor_circuit(C, a, L, M))
    assert circuit == shor_circuit(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch")
    got = eng.run(circuit)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(interop.state_to_numpy(got), want, atol=1e-12)
    # The cuda backend's planned path (fused segments + in-place gathers),
    # here with the segments' plain versions because the tensor is on the CPU.
    planned = tengine.apply_circuit_fused_(eng.initial_state(), circuit, M)
    np.testing.assert_allclose(interop.state_to_numpy(planned), want, atol=1e-12)


def test_shor_circuit_complex64_n16_matches_pallas():
    C, a, L, M = 15, 7, 12, 4
    want = _jax_final(C, a, L, M, jnp.complex64, "pallas")
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex64, backend="torch")
    got = eng.run(shor_circuit(C, a, L, M))
    np.testing.assert_allclose(interop.state_to_numpy(got), want, atol=3e-5)
    planned = tengine.apply_circuit_fused_(eng.initial_state(), shor_circuit(C, a, L, M), M)
    np.testing.assert_allclose(interop.state_to_numpy(planned), want, atol=3e-5)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_run_norm_is_one(dtype):
    eng = StateVectorEngine(Register(L=8, M=5), dtype=dtype, backend="torch")
    assert abs(eng.run_norm(shor_circuit(21, 2, 8, 5)) - 1.0) < (1e-5 if dtype == torch.complex64 else 1e-12)


def test_run_and_measure_index_uses_the_injected_draw():
    C, a, L, M = 15, 7, 6, 4
    psi = _jax_final(C, a, L, M, jnp.complex128, "xla")
    cum = np.cumsum(psi[0] ** 2 + psi[1] ** 2)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch")
    circuit = shor_circuit(C, a, L, M)
    for r in (0.05, 0.3, 0.62, 0.97):
        want = int(np.searchsorted(cum, r * cum[-1], side="left"))
        assert eng.run_and_measure_index(circuit, r) == want
        idx, collapsed = eng.measure(eng.run(circuit), r)
        assert idx == want
        assert eng.run_and_measure(circuit, r)[0] == want
        assert float(collapsed[0, idx]) == 1.0 and float(collapsed.abs().sum()) == 1.0


def test_run_updates_a_given_state_in_place():
    eng = StateVectorEngine(Register(L=3, M=4), backend="torch")
    state = eng.initial_state()
    out = eng.run(shor_circuit(15, 7, 3, 4), state)
    assert out is state
    assert abs(eng.norm(out) - 1.0) < 1e-6


def test_engine_plan_is_cached_per_circuit():
    eng = StateVectorEngine(Register(L=12, M=4), backend="torch")
    circuit = shor_circuit(15, 7, 12, 4)
    plan = eng._plan(circuit)
    assert eng._plan(circuit) is plan
    assert [seg[0] for seg in plan].count("single") == 12  # the 12 oracle gathers
    assert all(len(seg[2]) <= fused.TILE_BITS[torch.float32] - fused.LOW_BITS for seg in plan if seg[0] == "fused")


def test_backend_resolution():
    assert tengine.resolve_backend("torch") == "torch"
    assert tengine.resolve_backend("auto") == ("cuda" if torch.cuda.is_available() else "torch")
    with pytest.raises(ValueError):
        tengine.resolve_backend("pallas")
    with pytest.raises(ValueError):
        StateVectorEngine(Register(L=3, M=4), backend="cuda", device="cpu")


def test_interop_round_trip():
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        planes = rng.standard_normal((2, 64)).astype(dtype)
        t = interop.state_from_numpy(planes)
        assert t.dtype == (torch.float32 if dtype == np.float32 else torch.float64)
        np.testing.assert_array_equal(interop.state_to_numpy(t), planes)
    with pytest.raises(ValueError):
        interop.state_from_numpy(np.zeros((3, 8), np.float32))
    with pytest.raises(TypeError):
        interop.state_from_numpy(np.zeros((2, 8), np.int32))
    planes = rng.standard_normal((2, 16))
    np.testing.assert_array_equal(sv.to_numpy_complex(interop.state_from_numpy(planes)), planes[0] + 1j * planes[1])


def test_sample_does_not_collapse_and_logical_index_is_identity():
    C, a, L, M = 15, 7, 6, 4
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch")
    state = eng.run(shor_circuit(C, a, L, M))
    before = state.clone()
    rs = [0.05, 0.3, 0.62, 0.97]
    idx = eng.sample(state, rs)
    assert idx.tolist() == [eng.run_and_measure_index(shor_circuit(C, a, L, M), r) for r in rs]
    assert torch.equal(state, before)
    assert eng.logical_index(int(idx[0])) == int(idx[0])
