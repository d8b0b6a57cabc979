"""The port's adjoint circuits and engine gradient against the JAX package.

`models/circuit.dagger_gate` / `dagger_circuit` (a copy of the JAX
package's) and `StateVectorEngine.run`'s gradient (sim/engine._AdjointRun:
the backward runs the dagger circuit on the cotangent through the engine's
own path, as the JAX engine's custom VJP does), on the CPU.

Tolerances: gate adjoints equal; U^dagger U within 1e-12 at complex128; the
gradient within 1e-12 of jax.vjp at complex128 and within 5e-5 of the JAX
pallas engine's at complex64 (tests/test_adjoint.py's own); complex32
gradients within the complex32 circuit bound of tests/test_torch_complex32.py
(2e-3 on a unit cotangent, as tests/test_complex32.py:35 holds states);
strict_reference's autograd gradient within 1e-12 of jax.grad;
expectation_on_engine within 1e-10 at complex128 and 0.05 at complex32
(tests/test_variational_engines.py's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.algorithms import variational as jvar
from quantumcomputer_tpu.models import circuit as jcir
from quantumcomputer_tpu.models.shor_circuit import shor_circuit as jshor_circuit
from quantumcomputer_tpu.models.shor_circuit import shor_circuit_mhigh as jshor_circuit_mhigh
from quantumcomputer_tpu.sim import statevec as jsv
from quantumcomputer_tpu.sim.engine import Register as JRegister
from quantumcomputer_tpu.sim.engine import StateVectorEngine as JEngine
from quantumcomputer_tpu_torch import Register, StateVectorEngine, interop
from quantumcomputer_tpu_torch.algorithms import variational as var
from quantumcomputer_tpu_torch.models import circuit as cir
from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
from quantumcomputer_tpu_torch.sim import engine as tengine
from quantumcomputer_tpu_torch.sim import statevec as sv
from tests.conftest import random_state

CIRCUIT_TOL = 2e-3  # tests/test_torch_complex32.py, tests/test_complex32.py:35


def _random_circuit(n, rng, k=25):
    """tests/test_adjoint.py's random circuit, as JAX package gates."""
    gates = []
    names = ["h", "x", "y", "z", "phase", "rx", "ry", "rz"]
    for _ in range(k):
        r = rng.random()
        if r < 0.6:
            q = int(rng.integers(n))
            nm = names[int(rng.integers(len(names)))]
            p = (float(rng.random() * 3),) if nm in ("phase", "rx", "ry", "rz") else ()
            gates.append(jcir.Gate(nm, (q,), p))
        elif r < 0.85:
            q0, q1 = map(int, rng.choice(n, 2, replace=False))
            nm = ["cz", "cphase", "cnot", "swap"][int(rng.integers(4))]
            p = (float(rng.random() * 3),) if nm == "cphase" else ()
            gates.append(jcir.Gate(nm, (q0, q1), p))
        else:
            q = int(rng.integers(n))
            m = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
            u, _ = np.linalg.qr(m)
            gates.append(jcir.U1Q(q, u))
    return tuple(gates)


def _planar(psi, dtype=torch.float64):
    return torch.stack([torch.from_numpy(psi.real.copy()), torch.from_numpy(psi.imag.copy())]).to(dtype)


def _amps(planar) -> np.ndarray:
    a = np.asarray(planar.detach().double().numpy() if isinstance(planar, torch.Tensor) else planar, np.float64)
    return a[0] + 1j * a[1]


# -- adjoint gates -------------------------------------------------------------


_U = np.linalg.qr(np.arange(4).reshape(2, 2) + 1j * np.eye(2))[0]
_U4 = np.linalg.qr(np.arange(16).reshape(4, 4) + 1j * np.eye(4))[0]

GATES = {
    "h": lambda c: c.H(3), "x": lambda c: c.X(1), "y": lambda c: c.Y(0), "z": lambda c: c.Z(2),
    "s": lambda c: c.S(2), "t": lambda c: c.T(4), "phase": lambda c: c.PHASE(1, 0.7),
    "rx": lambda c: c.RX(0, 1.3), "ry": lambda c: c.RY(2, -0.4), "rz": lambda c: c.RZ(3, 2.1),
    "u1q": lambda c: c.U1Q(1, _U), "cnot": lambda c: c.CNOT(4, 1), "swap": lambda c: c.SWAP(0, 3),
    "cz": lambda c: c.CZ(2, 0), "cphase": lambda c: c.CPHASE(3, 1, 0.9), "u2q": lambda c: c.U2Q(4, 2, _U4),
    "mcphase": lambda c: c.MCPHASE((0, 2, 4), 1.1), "camodc": lambda c: c.CAMODC(33, 29, 7),
    "camodc_high": lambda c: c.Gate("camodc_high", (2,), meta=(33, 29, 6)),
    "camodc_ladder": lambda c: c.Gate("camodc_ladder", (7, 8, 9), meta=(33, 6, 29, 16, 25)),
    "camodc_ladder_high": lambda c: c.Gate("camodc_ladder_high", (0, 1, 2), meta=(33, 6, 29, 16, 25)),
    "iqft_stage": lambda c: c.IQFT_STAGE(11),
}


@pytest.mark.parametrize("M", [0, 6])
@pytest.mark.parametrize("kind", sorted(GATES))
def test_dagger_gate_equals_jax(kind, M):
    want = interop.circuit_from_reference(jcir.dagger_gate(GATES[kind](jcir), M))
    assert cir.dagger_gate(GATES[kind](cir), M) == want


@pytest.mark.parametrize("M", [0, 4])
def test_dagger_circuit_equals_jax(M, rng):
    jcirc = _random_circuit(9, rng) + (jcir.IQFT_STAGE(8), jcir.CAMODC(15, 7, 6))
    circ = interop.circuit_from_reference(jcirc)
    assert cir.dagger_circuit(circ, M) == interop.circuit_from_reference(jcir.dagger_circuit(jcirc, M))


# -- U^dagger U = 1 ------------------------------------------------------------------


def test_dagger_roundtrip_random(rng):
    n = 9
    circ = interop.circuit_from_reference(_random_circuit(n, rng))
    eng = StateVectorEngine(Register(L=n, M=0), dtype=torch.complex128, backend="torch")
    psi = random_state(n, rng)
    out = eng.run(cir.dagger_circuit(circ, 0), eng.run(circ, _planar(psi)))
    np.testing.assert_allclose(_amps(out), psi, atol=1e-12)


def _layout_circuit(layout, C, a, L, M):
    if layout == "m_high":
        return shor_circuit_mhigh(C, a, L, M), 0, 1 << L
    return shor_circuit(C, a, L, M), M, 1


@pytest.mark.parametrize("path", ["torch", "planned"])
@pytest.mark.parametrize("layout", ["standard", "m_high"])
def test_dagger_roundtrip_shor_circuit(layout, path):
    """Includes the iQFT stage's expansion and the inverse multipliers;
    "planned" runs both circuits through the cuda backend's plan (fused
    segments, ladders, walks) on float64 CPU planes, the kernels' plain
    versions."""
    C, a, L, M = 21, 2, 4, 5
    circ, m_eff, reset = _layout_circuit(layout, C, a, L, M)
    adj = cir.dagger_circuit(circ, m_eff)
    n = L + M
    if path == "torch":
        eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch", layout=layout)
        back = eng.run(adj, eng.run(circ))
    else:
        state = sv.initial_planar(n, torch.float64, reset)
        for c in (circ, adj):
            state = tengine.apply_circuit_fused_(state, c, m_eff, tengine.plan_circuit(c, m_eff, n, torch.float64, "cpu"))
    want = np.zeros(1 << n, np.complex128)
    want[reset] = 1.0
    np.testing.assert_allclose(_amps(back if path == "torch" else state), want, atol=1e-12)


# -- the engine's gradient -------------------------------------------------------------


def _port_grad(eng, circ, p, w):
    p = p.clone().requires_grad_()
    out = eng.run(circ, p)
    torch.sum(out * w).backward()
    return p.grad, out


@pytest.mark.parametrize("seed", range(3))
def test_vjp_matches_jax(seed):
    """The port's autograd gradient == jax.vjp of the JAX engine's
    _compiled_run (its custom VJP), complex128."""
    rng = np.random.default_rng(seed)
    n = 8
    jcirc = _random_circuit(n, rng, k=15)
    jeng = JEngine(JRegister(L=n, M=0), dtype=jnp.complex128)
    psi, ct = random_state(n, rng), random_state(n, rng)
    _, vjp = jax.vjp(jeng._compiled_run(jcirc, with_norms=False), jsv.from_numpy_complex(psi, jnp.float64))
    (want,) = vjp(jsv.from_numpy_complex(ct, jnp.float64))
    eng = StateVectorEngine(Register(L=n, M=0), dtype=torch.complex128, backend="torch")
    got, _ = _port_grad(eng, interop.circuit_from_reference(jcirc), _planar(psi), _planar(ct))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(_amps(got), _amps(np.asarray(want)), atol=1e-12)


@pytest.mark.parametrize("layout", ["standard", "m_high"])
def test_vjp_of_shor_circuit_matches_jax(layout):
    C, a, L, M = 21, 2, 4, 5
    jcirc = (jshor_circuit_mhigh if layout == "m_high" else jshor_circuit)(C, a, L, M)
    jeng = JEngine(JRegister(L=L, M=M), dtype=jnp.complex128, layout=layout)
    rng = np.random.default_rng(7)
    ct = random_state(L + M, rng)
    _, vjp = jax.vjp(jeng._compiled_run(jcirc, with_norms=False), jeng.initial_state())
    (want,) = vjp(jsv.from_numpy_complex(ct, jnp.float64))
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch", layout=layout)
    got, _ = _port_grad(eng, interop.circuit_from_reference(jcirc), eng.initial_state(), _planar(ct))
    np.testing.assert_allclose(_amps(got), _amps(np.asarray(want)), atol=1e-12)


def test_grad_matches_jax_pallas_backend(rng):
    """tests/test_adjoint.py::test_grad_through_pallas_backend's loss at
    n = 14, complex64: the port's torch backend against the JAX pallas
    engine (interpret mode)."""
    n = 14
    jcirc = _random_circuit(n, rng, k=12)
    psi, w = random_state(n, rng), random_state(n, rng)
    jeng = JEngine(JRegister(L=n, M=0), dtype=jnp.complex64, backend="pallas")
    run = jeng._compiled_run(jcirc, with_norms=False)
    w_planar = jsv.from_numpy_complex(w, jnp.float32)
    want = jax.grad(lambda p: jnp.sum(run(p) * w_planar))(jsv.from_numpy_complex(psi, jnp.float32))
    eng = StateVectorEngine(Register(L=n, M=0), dtype=torch.complex64, backend="torch")
    got, _ = _port_grad(eng, interop.circuit_from_reference(jcirc), _planar(psi, torch.float32),
                        _planar(w, torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_amps(got), _amps(np.asarray(want)), atol=5e-5)
    # d loss / d p = planar(U^dagger w)
    back = eng.run(cir.dagger_circuit(interop.circuit_from_reference(jcirc), 0), _planar(w, torch.float32))
    assert torch.equal(got, back)


def test_c32_backprop_adjoint_matches_jax():
    """tests/test_complex32.py::test_c32_backprop_adjoint's circuit and loss:
    the port's complex32 engine off the card (the kernels' plain versions on
    bf16 planes) against the JAX pallas engine's gradient (interpret mode).
    The cotangent 2 Re(out) has norm <= 2, so twice the circuit bound."""
    n = 13
    jcirc = (jcir.H(12), jcir.RY(5, 0.3), jcir.H(0))
    j32 = JEngine(JRegister(L=n, M=0), dtype="complex32", backend="pallas")
    want = jax.grad(lambda p: jnp.sum(j32._compiled_run(jcirc, with_norms=False)(p)[0].astype(jnp.float32) ** 2))(
        j32.zero_state())
    e32 = StateVectorEngine(Register(L=n, M=0), dtype="complex32")
    assert e32.device.type == "cpu" and e32.backend == "cuda"
    p = e32.zero_state().requires_grad_()
    out = e32.run(interop.circuit_from_reference(jcirc), p)
    torch.sum(out[0].float() ** 2).backward()
    assert p.grad.dtype == torch.bfloat16
    assert bool(torch.isfinite(p.grad.float()).all())
    want_t = interop.state_from_numpy(np.asarray(want))
    assert want_t.dtype == torch.bfloat16
    assert float((p.grad.double() - want_t.double()).abs().max()) < 2 * CIRCUIT_TOL


@pytest.mark.parametrize("layout,oracle_kind", [("standard", "gather"), ("standard", "benes"), ("m_high", "gather")])
def test_c32_shor_gradient_matches_jax(layout, oracle_kind):
    """The Shor circuit's gradient on bf16 planes through the planned path
    (fused segments, camodc ops, ladders and walks, each applied backwards
    with inverse multipliers) against the JAX pallas complex32 engine's,
    on a unit cotangent."""
    C, a, L, M = 33, 29, 8, 6
    jcirc = (jshor_circuit_mhigh if layout == "m_high" else jshor_circuit)(C, a, L, M)
    j32 = JEngine(JRegister(L=L, M=M), dtype="complex32", backend="pallas", layout=layout, oracle=oracle_kind)
    w = random_state(L + M, np.random.default_rng(3))
    w32 = jsv.from_numpy_complex(w, jnp.float32).astype(jnp.bfloat16)
    run = j32._compiled_run(jcirc, with_norms=False)
    want = jax.grad(lambda p: jnp.sum(run(p).astype(jnp.float32) * w32.astype(jnp.float32)))(j32.initial_state())
    e32 = StateVectorEngine(Register(L=L, M=M), dtype="complex32", layout=layout, oracle=oracle_kind)
    p = e32.initial_state().requires_grad_()
    out = e32.run(interop.circuit_from_reference(jcirc), p)
    torch.sum(out.float() * interop.state_from_numpy(np.asarray(w32)).float()).backward()
    assert p.grad.dtype == torch.bfloat16
    want_t = interop.state_from_numpy(np.asarray(want))
    assert float((p.grad.double() - want_t.double()).abs().max()) < CIRCUIT_TOL
    # the gradient is U^dagger w through the same path
    w_t = interop.state_from_numpy(np.asarray(w32))
    assert torch.equal(p.grad, e32.run(cir.dagger_circuit(interop.circuit_from_reference(jcirc), e32.m_eff), w_t))


def test_strict_reference_gradient_matches_jax():
    """strict_reference has no adjoint (2^M < C: the scatter is not
    unitary): the port differentiates through its plain ops with autograd,
    the JAX engine through XLA."""
    C, a, L, M = 15, 7, 3, 3
    jcirc = jshor_circuit(C, a, L, M)
    jeng = JEngine(JRegister(L=L, M=M), dtype=jnp.complex128, strict_reference=True)
    w = random_state(L + M, np.random.default_rng(11))
    run = jeng._compiled_run(jeng._prep(jcirc), with_norms=False)
    w_planar = jsv.from_numpy_complex(w, jnp.float64)
    want = jax.grad(lambda p: jnp.sum(run(p) * w_planar))(jeng.initial_state())
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, strict_reference=True, device="cpu")
    p = eng.initial_state()
    got, out = _port_grad(eng, interop.circuit_from_reference(jcirc), p, _planar(w))
    np.testing.assert_allclose(_amps(got), _amps(np.asarray(want)), atol=1e-12)
    # the forward value is the strict engine's, and the input planes stay as they were
    np.testing.assert_allclose(_amps(out), _amps(eng.run(interop.circuit_from_reference(jcirc))), atol=1e-12)
    assert torch.equal(p, eng.initial_state())


@pytest.mark.parametrize("dtype", [torch.complex128, "complex32"])
def test_run_without_gradient_consumes_its_input(dtype):
    """No gradient asked for: run() keeps its in-place path (the input is
    updated and returned), also for an input that requires grad under
    torch.no_grad(); with a gradient asked for, the input stays as it was."""
    circ = shor_circuit(15, 7, 3, 4)
    eng = StateVectorEngine(Register(L=3, M=4), dtype=dtype)
    state = eng.initial_state()
    assert eng.run(circ, state) is state
    assert abs(eng.norm(state) - 1.0) < 1e-2 and float(state[0, 1]) != 1.0
    leaf = eng.initial_state().requires_grad_()
    with torch.no_grad():
        assert eng.run(circ, leaf) is leaf
    leaf = eng.initial_state().requires_grad_()
    out = eng.run(circ, leaf)
    assert out is not leaf and out.requires_grad and torch.equal(leaf, eng.initial_state())
    assert torch.equal(out.detach(), eng.run(circ))


def test_run_with_norms_and_measure_take_no_gradient():
    """As in the JAX package, only run() is differentiable: the others work
    in place on their input."""
    eng = StateVectorEngine(Register(L=3, M=4), dtype=torch.complex64)
    leaf = eng.initial_state().requires_grad_()
    with pytest.raises(RuntimeError):
        eng.run_with_norms(shor_circuit(15, 7, 3, 4), leaf)


# -- expectation_on_engine ----------------------------------------------------------


def _prep_circuit(c, n):
    """tests/test_variational_engines.py's state preparation."""
    gates = [c.H(q) for q in range(0, n, 2)]
    gates += [c.CNOT(q, q + 1) for q in range(0, n - 1, 2)]
    gates += [c.RY(q, 0.3 + 0.11 * q) for q in range(n)]
    gates += [c.CZ(q, (q + 2) % n) for q in range(0, n - 1)]
    gates += [c.T(0), c.S(n - 1)]
    return tuple(gates)


@pytest.mark.parametrize("which", ["tfim", "heisenberg"])
def test_expectation_on_engine_matches_jax(which):
    n = 5
    jterms = (jvar.tfim_hamiltonian(n, J=1.1, h=0.6) if which == "tfim" else jvar.heisenberg_hamiltonian(n)) + [
        jvar.pauli_term(0.5, {}), jvar.pauli_term(-0.4, {n - 2: "Y", 0: "Z"})]
    terms = [var.pauli_term(c, ops) for c, ops in jterms]
    jeng = JEngine(JRegister(L=n, M=0), dtype=jnp.complex128)
    jstate = jeng.run(_prep_circuit(jcir, n), jeng.zero_state())
    want = jvar.expectation_on_engine(jeng, jstate, jterms)
    eng = StateVectorEngine(Register(L=n, M=0), dtype=torch.complex128, backend="torch")
    state = eng.run(_prep_circuit(cir, n), eng.zero_state())
    before = state.clone()
    got = var.expectation_on_engine(eng, state, terms)
    assert got == pytest.approx(want, abs=1e-10)
    assert torch.equal(state, before)  # not consumed
    assert var.expectation_on_engine(eng, state, terms) == pytest.approx(got, abs=1e-10)
    assert float(var.expectation(state, terms)) == pytest.approx(want, abs=1e-10)
    # complex32 (bf16 planes, float32 inner products) within the JAX test's 0.05
    e32 = StateVectorEngine(Register(L=n, M=0), dtype="complex32")
    s32 = e32.run(_prep_circuit(cir, n), e32.zero_state())
    assert var.expectation_on_engine(e32, s32, terms) == pytest.approx(want, abs=0.05)


def test_re_inner_bf16_matches_jax(rng):
    n = 7
    a = jsv.from_numpy_complex(random_state(n, rng), jnp.float32).astype(jnp.bfloat16)
    b = jsv.from_numpy_complex(random_state(n, rng), jnp.float32).astype(jnp.bfloat16)
    want = float(jvar._re_inner(a, b))
    got = var._re_inner(interop.state_from_numpy(np.asarray(a)), interop.state_from_numpy(np.asarray(b)))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, abs=1e-6)


def test_to_and_from_complex_are_out_of_place():
    """The strict_reference gradient runs autograd through both."""
    planar = torch.randn(2, 16, dtype=torch.float64)
    z = sv.to_complex(planar)
    back = sv.from_complex(z)
    assert z.data_ptr() not in (planar.data_ptr(), planar[1].data_ptr()) and back.data_ptr() != planar.data_ptr()
    assert torch.equal(back, planar)
    assert sv.complex_dtype_of(torch.bfloat16) == torch.complex64 == sv.complex_dtype_of(torch.float32)
    assert sv.complex_dtype_of(torch.float64) == torch.complex128
    with pytest.raises(ValueError):
        sv.complex_dtype_of(torch.int32)


def test_prof_grad_needs_a_card(monkeypatch, capsys):
    """scripts/prof_grad.py times the flagship's gradient on the card only."""
    from quantumcomputer_tpu_torch.scripts import prof_grad

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert prof_grad.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert [f[0] for f in prof_grad.FORMS] == ["gather", "benes", "m_high", "m_high c32"]
