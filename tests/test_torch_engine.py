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
from quantumcomputer_tpu_torch.models import circuit as tcir
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


# ---------------------------------------------------------------------------
# fuse=False, the per-gate route, and the engine surface of the validation
# layer.


@pytest.mark.parametrize("layout", ["standard", "m_high"])
def test_per_gate_route_equals_fused_route(layout):
    """The cuda backend's per-gate route (fuse=False) and its planned route
    give the same state; on CPU tensors both run the kernels' plain
    versions, so they must agree with the torch backend at 1e-12."""
    from quantumcomputer_tpu_torch import shor_circuit_mhigh

    C, a, L, M = 39, 7, 9, 6
    circuit = shor_circuit_mhigh(C, a, L, M) if layout == "m_high" else shor_circuit(C, a, L, M)
    m_eff = 0 if layout == "m_high" else M
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch", layout=layout, fuse=False)
    want = eng.run(circuit)
    per_gate = tengine.apply_circuit_per_gate_(eng.initial_state(), circuit, m_eff)
    planned = tengine.apply_circuit_fused_(eng.initial_state(), circuit, m_eff)
    np.testing.assert_allclose(interop.state_to_numpy(per_gate), interop.state_to_numpy(want), atol=1e-12)
    np.testing.assert_allclose(interop.state_to_numpy(planned), interop.state_to_numpy(per_gate), atol=1e-12)
    fused_eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch", layout=layout)
    assert eng.fuse is False and fused_eng.fuse is True
    assert torch.equal(fused_eng.run(circuit), want)


def test_zero_state_probabilities_and_to_numpy_match_jax():
    C, a, L, M = 15, 7, 3, 4
    jeng = JEngine(JRegister(L=L, M=M), dtype=jnp.complex128)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch")
    zero = eng.zero_state()
    assert zero.dtype == torch.float64 and zero.device.type == "cpu"
    np.testing.assert_array_equal(interop.state_to_numpy(zero), np.asarray(jeng.zero_state()))
    jstate = jeng.run(jshor_circuit(C, a, L, M))
    state = eng.run(shor_circuit(C, a, L, M))
    np.testing.assert_allclose(eng.to_numpy(state), jeng.to_numpy(jstate), atol=1e-12)
    np.testing.assert_allclose(eng.probabilities(state).numpy(), np.asarray(jeng.probabilities(jstate)), atol=1e-12)


def test_no_gate_with_an_op_form_reaches_the_plain_ops(monkeypatch):
    """The cuda backend's routes send every gate with a fused-op form
    through fused.apply_fused (a one-op segment when run alone, the
    standard-layout oracle's included), never through the complex plain
    ops, and mcphase in place on the planes: counted by patching both."""
    from quantumcomputer_tpu_torch.models import circuit as cir
    from quantumcomputer_tpu_torch.models.circuit import Gate

    n, M = 14, 5
    u = np.linalg.qr(np.random.default_rng(3).standard_normal((4, 4)))[0]
    gates = (
        cir.H(13), cir.X(2), cir.RZ(9, 0.3), cir.PHASE(12, 0.4), cir.CPHASE(13, 1, 0.5), cir.CZ(3, 11),
        cir.CNOT(10, 2), cir.SWAP(4, 12), cir.U2Q(13, 6, u), cir.IQFT_STAGE(13), cir.IQFT_STAGE(M),
        cir.MCPHASE((1, 7, 12), 0.25), cir.CAMODC(21, 2, 7), Gate("camodc_high", (3,), meta=(21, 4, M)),
    )
    with_op = [g for g in gates if fused.gate_to_op(g, M, fuse_oracle=True) is not None]
    assert len(with_op) == 12
    plain_calls, kernel_calls = [], []
    real_plain, real_fused = tengine.apply_gate, fused.apply_fused

    def counting_plain(state, g, m):
        plain_calls.append(g.name)
        return real_plain(state, g, m)

    def counting_fused(planar, ops, axes, m):
        kernel_calls.append(ops)
        return real_fused(planar, ops, axes, m)

    monkeypatch.setattr(tengine, "apply_gate", counting_plain)
    monkeypatch.setattr(fused, "apply_fused", counting_fused)
    state = interop.state_from_numpy(np.random.default_rng(4).standard_normal((2, 1 << n)))
    want = interop.state_to_numpy(tengine.apply_circuit_plain_(state.clone(), gates, M))
    plain_calls.clear()
    got = tengine.apply_circuit_per_gate_(state.clone(), gates, M)
    # mcphase, the one gate here with no op form, runs in place on the planes.
    assert plain_calls == [] and len(kernel_calls) == len(with_op)
    np.testing.assert_allclose(interop.state_to_numpy(got), want, atol=1e-12)
    plain_calls.clear()
    kernel_calls.clear()
    got = tengine.apply_circuit_fused_(state.clone(), gates, M)
    assert plain_calls == [] and kernel_calls
    np.testing.assert_allclose(interop.state_to_numpy(got), want, atol=1e-12)
    for g in with_op:
        plain_calls.clear()
        tengine.apply_gate_planes_(state.clone(), g, M)
        assert plain_calls == []


# ---------------------------------------------------------------------------
# The engine options of the JAX package's constructor: oracle, nan_checks,
# strict_reference.


def test_benes_oracle_plans_the_oracles_into_segments():
    """oracle="benes": the plan the cuda backend would run holds every
    oracle as a camodc op, two to a segment, as the JAX pallas plan groups
    them; the gather engine keeps them single."""
    C, a, L, M = 15, 7, 12, 4
    circuit = shor_circuit(C, a, L, M)
    benes = StateVectorEngine(Register(L=L, M=M), backend="torch", oracle="benes")._plan(circuit)
    gather = StateVectorEngine(Register(L=L, M=M), backend="torch")._plan(circuit)
    assert [seg[0] for seg in gather].count("single") == L
    assert all(seg[0] == "fused" for seg in benes)
    counts = [sum(op[0] == "camodc" for op in seg[1]) for seg in benes]
    assert sum(counts) == L and max(counts) == fused.MAX_CAMODC_PER_SEGMENT
    want = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch").run(circuit)
    got = tengine.apply_circuit_fused_(sv.initial_planar(L + M, torch.float64), circuit, M, plan=benes)
    np.testing.assert_allclose(interop.state_to_numpy(got), interop.state_to_numpy(want), atol=1e-12)


def test_engine_options_are_checked_as_in_jax():
    reg = Register(L=3, M=4)
    with pytest.raises(ValueError, match="unknown oracle backend"):
        StateVectorEngine(reg, backend="torch", oracle="slot")
    with pytest.raises(ValueError, match="strict_reference mode requires"):
        StateVectorEngine(reg, backend="torch", layout="m_high", strict_reference=True)
    eng = StateVectorEngine(reg, strict_reference=True, nan_checks=True)
    assert (eng.backend, eng.strict_reference, eng.nan_checks, eng.oracle) == ("torch", True, True, "gather")
    assert [g.name for g in eng._prep(shor_circuit(15, 7, 3, 4))].count("camodc_strict") == 3


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_strict_reference_runs_on_the_card_when_there_is_one(monkeypatch, backend):
    """strict_reference picks the plain ops, not the host: with a CUDA device
    present (faked here; nothing is allocated) its engine defaults to it,
    the CLI's forced backend="torch" included; device="cpu" keeps the CPU,
    and without a card it is the CPU."""
    reg = Register(L=3, M=4)
    assert StateVectorEngine(reg, backend=backend, strict_reference=True).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tengine, "state_fits", lambda *args: True)
    eng = StateVectorEngine(reg, backend=backend, strict_reference=True)
    assert (eng.backend, eng.device.type) == ("torch", "cuda")
    assert StateVectorEngine(reg, backend=backend, strict_reference=True, device="cpu").device.type == "cpu"
    assert StateVectorEngine(reg, backend="torch").device.type == "cpu"


def test_strict_reference_equals_the_gather_when_unitary():
    """With 2^M >= C the warn-and-wrap scatter is the same permutation as
    the gather: both engines give the same state at complex128."""
    C, a, L, M = 21, 2, 4, 5
    circuit = shor_circuit(C, a, L, M)
    strict = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, strict_reference=True).run(circuit)
    plain = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch").run(circuit)
    np.testing.assert_allclose(interop.state_to_numpy(strict), interop.state_to_numpy(plain), atol=1e-12)


def test_nan_checks_label_each_route(capsys):
    """The JAX labels: per gate "gate i name(qubits)" on the torch backend
    and with fuse=False; per plan entry "fused segment i (k ops)" or
    "gate name(qubits)" on the planned route."""
    M = 4
    circuit = (tcir.H(5), tcir.CAMODC(15, 7, 5), tcir.H(6))
    planes = np.zeros((2, 1 << 8))
    planes[0, 1] = np.nan
    tengine.apply_circuit_per_gate_(interop.state_from_numpy(planes), circuit, M, nan_checks=True)
    assert capsys.readouterr().out.splitlines() == [
        f"*** non-finite amplitudes after gate {i} {g.name}{g.qubits}" for i, g in enumerate(circuit)
    ]
    tengine.apply_circuit_fused_(interop.state_from_numpy(planes), circuit, M, nan_checks=True)
    assert capsys.readouterr().out.splitlines() == [
        "*** non-finite amplitudes after fused segment 0 (1 ops)",
        "*** non-finite amplitudes after gate camodc(5,)",
        "*** non-finite amplitudes after fused segment 2 (1 ops)",
    ]
    tengine.apply_circuit_fused_(interop.state_from_numpy(np.ones((2, 1 << 8))), circuit, M, nan_checks=True)
    assert capsys.readouterr().out == ""


def test_kernel_checks_need_a_card():
    from quantumcomputer_tpu_torch.utils import kernel_checks

    assert len(kernel_checks.CHECKS) == 21
    with pytest.raises(ValueError, match="CUDA device"):
        kernel_checks.run_all("cpu")
