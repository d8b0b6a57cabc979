"""The port's variational layer (quantumcomputer_tpu_torch/algorithms/
variational.py) against the JAX package's, on the CPU at small n.

The same inputs go through both packages: states and parameters made with
numpy, or the JAX package's own draws (its jax.random keys and splits, as
its functions make them) passed to the port's `initial_parameters`.

Tolerances: Pauli images within 1e-12 at complex128 (the JAX suite's);
expectations within 1e-12 at complex128 and 1e-6 at complex64; term lists,
cost vectors, entangler signs and dense matrices equal; the ansatz state
within 1e-12 at float64 and 1e-6 at float32; the energy gradient within
1e-10 of jax.grad at float64 and 1e-5 of central differences (the JAX
suite's); VQE / QAOA traces fed the JAX initial parameters within 1e-4 of
the JAX traces at every step, and the final energy and parameters within
1e-4 (float32 Adam over 250 steps; the measured spread is 4e-6), the QAOA
card route's loop (the adjoint step at complex128) likewise, and its
expected cut and gradient within 1e-10 of jax.value_and_grad at
complex128; then the JAX suite's own assertions on the port's seeded runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.algorithms import variational as jvar
from quantumcomputer_tpu.sim import statevec as jsv
import quantumcomputer_tpu_torch as port
from quantumcomputer_tpu_torch.algorithms import variational as var
from quantumcomputer_tpu_torch.ops import qaoa as qops
from quantumcomputer_tpu_torch.sim import statevec as sv
from tests.conftest import random_state

TRACE_TOL = 1e-4


def _dense_pauli(ops, n):
    return var.dense_hamiltonian([var.pauli_term(1.0, ops)], n)


def _planar(psi, dtype=torch.float64):
    return torch.stack([torch.from_numpy(psi.real.copy()), torch.from_numpy(psi.imag.copy())]).to(dtype)


def _jax_vqe_inits(ans, seed, restarts):
    """The initial parameters jvar.vqe draws for key PRNGKey(seed)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), restarts)
    return [np.asarray(ans.initial_parameters(k, scale=0.1 + 0.35 * r)) for r, k in enumerate(keys)]


def _jax_qaoa_init(seed, p):
    """The initial parameters jvar.qaoa_maxcut draws for key PRNGKey(seed)."""
    kg, kb = jax.random.split(jax.random.PRNGKey(seed))
    return np.asarray(jnp.stack([
        0.1 + 0.05 * jax.random.normal(kg, (p,), dtype=jnp.float32),
        0.4 + 0.05 * jax.random.normal(kb, (p,), dtype=jnp.float32),
    ]))


def test_exports():
    for name in ("HardwareEfficientAnsatz", "expectation", "expectation_on_engine", "pauli_term", "qaoa_maxcut", "vqe"):
        assert getattr(port, name) is getattr(var, name)


# -- Pauli observables ------------------------------------------------------------


@pytest.mark.parametrize("s", ["X", "Y", "Z"])
@pytest.mark.parametrize("q", [0, 1, 3])
def test_apply_pauli_single(rng, s, q):
    n = 4
    psi = random_state(n, rng)
    ops = var.pauli_term(1.0, {q: s})[1]
    got = var.apply_pauli(torch.from_numpy(psi), ops, n).numpy()
    want = np.asarray(jvar.apply_pauli(jnp.asarray(psi), ops, n))
    np.testing.assert_allclose(got, want, atol=1e-12)
    np.testing.assert_allclose(got, _dense_pauli({q: s}, n) @ psi, atol=1e-12)


@pytest.mark.parametrize("k", range(10))
def test_apply_pauli_strings(k):
    n = 5
    rng = np.random.default_rng(100 + k)
    psi = random_state(n, rng)
    qubits = rng.choice(n, size=rng.integers(1, n + 1), replace=False)
    ops = {int(q): "XYZ"[rng.integers(3)] for q in qubits}
    term = var.pauli_term(1.0, ops)
    got = var.apply_pauli(torch.from_numpy(psi), term[1], n).numpy()
    np.testing.assert_allclose(got, np.asarray(jvar.apply_pauli(jnp.asarray(psi), term[1], n)), atol=1e-12)
    np.testing.assert_allclose(got, _dense_pauli(ops, n) @ psi, atol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
@pytest.mark.parametrize("which", ["tfim", "heisenberg"])
def test_expectation_matches_jax_and_dense(rng, which, dtype, tol):
    n = 4
    terms = (var.tfim_hamiltonian(n, J=1.3, h=0.7) if which == "tfim" else var.heisenberg_hamiltonian(n)) + [
        var.pauli_term(0.25, {}), var.pauli_term(-0.6, {0: "Y", 3: "X"})]
    psi = random_state(n, rng)
    planar = _planar(psi, dtype)
    got = var.expectation(planar, terms)
    assert got.dtype == dtype and got.dim() == 0
    jplanar = jsv.from_numpy_complex(psi, jnp.float64 if dtype == torch.float64 else jnp.float32)
    assert float(got) == pytest.approx(float(jvar.expectation(jplanar, terms)), abs=tol)
    dense = var.dense_hamiltonian(terms, n)
    np.testing.assert_array_equal(dense, jvar.dense_hamiltonian(terms, n))
    assert float(got) == pytest.approx(float(np.real(psi.conj() @ dense @ psi)), abs=tol)


def test_expectation_bf16_planes_sum_in_float32(rng):
    n = 5
    psi = random_state(n, rng)
    terms = var.tfim_hamiltonian(n)
    planar = _planar(psi, torch.bfloat16)
    got = var.expectation(planar, terms)
    assert got.dtype == torch.bfloat16
    want = float(var.expectation(planar.double(), terms))
    assert float(got) == pytest.approx(want, rel=2 ** -8)


def test_pauli_term_errors_match_jax():
    cases = [([(0, "X"), (0, "Z")],), ({0: "Q"},), ({-1: "X"},)]
    for (ops,) in cases:
        with pytest.raises(ValueError) as want:
            jvar.pauli_term(1.0, ops)
        with pytest.raises(ValueError) as got:
            var.pauli_term(1.0, ops)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jvar.apply_pauli(jnp.zeros(8, jnp.complex64), ((5, "X"),), 3)
    with pytest.raises(ValueError) as got:
        var.apply_pauli(torch.zeros(8, dtype=torch.complex64), ((5, "X"),), 3)
    assert str(got.value) == str(want.value)
    assert var.pauli_term(2, {3: "x", 1: "z"}) == jvar.pauli_term(2, {3: "x", 1: "z"}) == (2.0, ((1, "Z"), (3, "X")))


@pytest.mark.parametrize("n", [2, 3, 6])
def test_hamiltonian_term_lists_match_jax(n):
    for periodic in (False, True):
        assert var.tfim_hamiltonian(n, J=1.1, h=0.6, periodic=periodic) == jvar.tfim_hamiltonian(
            n, J=1.1, h=0.6, periodic=periodic)
    assert var.heisenberg_hamiltonian(n, J=0.7) == jvar.heisenberg_hamiltonian(n, J=0.7)


_RNG_EDGES = [(int(a), int(b), float(w)) for (a, b), w in zip(
    np.random.default_rng(21).integers(0, 10, (30, 2)), np.random.default_rng(22).random(30) * 3)]


@pytest.mark.parametrize("n,edges", [(5, [(0, 1), (1, 2), (2, 3), (3, 0)]), (5, [(0, 4, 2.5), (1, 3, 0.5), (2, 4)]),
                                     (10, _RNG_EDGES + [(6, 6, 1.5)])])
def test_maxcut_cost_vector_matches_jax(n, edges):
    got = var.maxcut_cost_vector(n, edges)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jvar.maxcut_cost_vector(n, edges))


def test_cz_signs_of_any_pairs_match_jax():
    pairs = [(int(a), int(b)) for a, b in np.random.default_rng(5).integers(0, 9, (12, 2))] + [(3, 3)]
    np.testing.assert_array_equal(var._cz_ring_signs(9, pairs), jvar._cz_ring_signs(9, pairs))


def test_maxcut_cost_vector_square():
    # tests/test_variational.py::test_maxcut_cost_vector on the port
    cost = var.maxcut_cost_vector(4, [(0, 1), (1, 2), (2, 3), (3, 0)])
    assert cost.shape == (16,) and cost.max() == 4.0
    assert cost[0b0101] == 4.0 and cost[0b1010] == 4.0 and cost[0] == 0.0 and cost[0b1111] == 0.0
    cost_w = var.maxcut_cost_vector(2, [(0, 1, 2.5)])
    assert cost_w[0b01] == 2.5 and cost_w[0b00] == 0.0


@pytest.mark.parametrize("entangler", ["brick", "ring"])
@pytest.mark.parametrize("n", [2, 3, 5])
def test_cz_signs_and_pairs_match_jax(n, entangler):
    ans, jans = var.HardwareEfficientAnsatz(n, 3, entangler=entangler), jvar.HardwareEfficientAnsatz(n, 3, entangler=entangler)
    assert ans.parameter_shape == jans.parameter_shape and ans.num_parameters == jans.num_parameters
    for layer in (0, 1):
        assert ans._pairs(layer) == jans._pairs(layer)
        got = var._cz_ring_signs(n, ans._pairs(layer))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jvar._cz_ring_signs(n, jans._pairs(layer)))


# -- the ansatz ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
@pytest.mark.parametrize("entangler", ["brick", "ring"])
@pytest.mark.parametrize("rotation", ["Y", "XY"])
def test_ansatz_apply_matches_jax(rotation, entangler, dtype, tol):
    n, depth = 5, 3
    ans = var.HardwareEfficientAnsatz(n, depth, rotation=rotation, entangler=entangler)
    jans = jvar.HardwareEfficientAnsatz(n, depth, rotation=rotation, entangler=entangler)
    theta = np.random.default_rng(9).standard_normal(ans.parameter_shape).astype(
        np.float64 if dtype == torch.float64 else np.float32)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = np.asarray(jans.apply(jnp.asarray(theta), rdtype=jdt))
    got = ans.apply(torch.from_numpy(theta), rdtype=dtype)
    assert got.dtype == dtype and got.shape == (2, 1 << n)
    np.testing.assert_allclose(got.numpy(), want, atol=tol)


@pytest.mark.parametrize("kind", ["X", "Y", "Z"])
def test_rotations_match_jax(kind, rng):
    n, q = 4, 2
    psi = random_state(n, rng)
    got = var._ROT[kind](torch.from_numpy(psi), q, n, torch.tensor(0.83, dtype=torch.float64)).numpy()
    want = np.asarray(jvar._ROT[kind](jnp.asarray(psi), q, n, jnp.asarray(0.83, jnp.float64)))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_ansatz_state_normalized_and_real():
    ans = var.HardwareEfficientAnsatz(n=4, depth=3)
    theta = ans.initial_parameters(torch.Generator().manual_seed(7))
    assert theta.dtype == torch.float32 and theta.shape == (4, 4)
    planar = ans.apply(theta)
    assert float(sv.norm(planar)) == pytest.approx(1.0, abs=1e-6)
    assert float(planar[1].abs().max()) == 0.0
    again = ans.initial_parameters(torch.Generator().manual_seed(7), scale=0.45)
    assert torch.allclose(again, 4.5 * theta)


def _energy_fns(n, depth, terms):
    ans, jans = var.HardwareEfficientAnsatz(n, depth), jvar.HardwareEfficientAnsatz(n, depth)
    return (lambda th: var.expectation(ans.apply(th, rdtype=torch.float64), terms),
            lambda th: jvar.expectation(jans.apply(th, rdtype=jnp.float64), terms), jans)


def test_energy_gradient_matches_jax_and_finite_differences():
    """autograd through the ansatz == jax.grad (float64), and both ==
    central differences (tests/test_variational.py's check)."""
    n, depth = 3, 2
    terms = var.tfim_hamiltonian(n, J=1.0, h=0.9)
    energy, jenergy, jans = _energy_fns(n, depth, terms)
    theta = np.asarray(jans.initial_parameters(jax.random.PRNGKey(3), scale=0.7)).astype(np.float64)
    want = np.asarray(jax.grad(jenergy)(jnp.asarray(theta)))
    th = torch.from_numpy(theta.copy()).requires_grad_()
    energy(th).backward()
    got = th.grad.numpy()
    np.testing.assert_allclose(got, want, atol=1e-10)
    eps = 1e-6
    for idx in [(0, 0), (1, 2), (2, 1)]:
        bump = theta.copy()
        bump[idx] += eps
        ep = float(energy(torch.from_numpy(bump)))
        bump[idx] -= 2 * eps
        em = float(energy(torch.from_numpy(bump)))
        assert got[idx] == pytest.approx((ep - em) / (2 * eps), abs=1e-5)


@pytest.mark.parametrize("terms_of", ["tfim", "heisenberg"])
def test_energy_gradient_complex_ansatz_matches_jax(terms_of):
    n, depth = 4, 3
    terms = var.tfim_hamiltonian(n) if terms_of == "tfim" else var.heisenberg_hamiltonian(n)
    ans = var.HardwareEfficientAnsatz(n, depth, rotation="XY", entangler="ring")
    jans = jvar.HardwareEfficientAnsatz(n, depth, rotation="XY", entangler="ring")
    theta = np.random.default_rng(4).standard_normal(ans.parameter_shape)
    want = np.asarray(jax.grad(lambda th: jvar.expectation(jans.apply(th, jnp.float64), terms))(jnp.asarray(theta)))
    th = torch.from_numpy(theta.copy()).requires_grad_()
    var.expectation(ans.apply(th, torch.float64), terms).backward()
    np.testing.assert_allclose(th.grad.numpy(), want, atol=1e-10)


# -- VQE and QAOA fed the JAX package's initial parameters ---------------------------


@pytest.mark.parametrize("which", ["tfim", "heisenberg"])
def test_vqe_follows_the_jax_trace(which):
    """The kept restart's trace.  Heisenberg runs one restart: its restarts
    end on the degenerate ground energy -4 within float32 rounding of each
    other, so which one is kept is a tie either package may break its own
    way (test_vqe_restarts_end_at_the_jax_energy holds the energies)."""
    n, depth, steps, lr, seed, restarts = (4, 3, 250, 0.08, 1, 3) if which == "tfim" else (3, 4, 150, 0.06, 5, 1)
    terms = var.tfim_hamiltonian(n) if which == "tfim" else var.heisenberg_hamiltonian(n)
    want = jvar.vqe(terms, n, depth=depth, steps=steps, learning_rate=lr, key=jax.random.PRNGKey(seed),
                    restarts=restarts)
    inits = _jax_vqe_inits(jvar.HardwareEfficientAnsatz(n, depth), seed, restarts)
    got = var.vqe(terms, n, depth=depth, steps=steps, learning_rate=lr, restarts=restarts,
                  initial_parameters=inits, device="cpu")
    assert got.energies.shape == (steps,) and got.n == n and got.depth == depth and got.steps == steps
    assert np.abs(got.energies - want.energies).max() < TRACE_TOL
    assert got.energy == pytest.approx(want.energy, abs=TRACE_TOL)
    assert got.parameters.dtype == np.float32
    np.testing.assert_allclose(got.parameters, want.parameters, atol=TRACE_TOL)
    np.testing.assert_allclose(got.state, want.state, atol=TRACE_TOL)


def test_vqe_restarts_end_at_the_jax_energy():
    n, depth, steps, lr, seed, restarts = 3, 4, 150, 0.06, 5, 2
    terms = var.heisenberg_hamiltonian(n)
    want = jvar.vqe(terms, n, depth=depth, steps=steps, learning_rate=lr, key=jax.random.PRNGKey(seed),
                    restarts=restarts)
    got = var.vqe(terms, n, depth=depth, steps=steps, learning_rate=lr, restarts=restarts, device="cpu",
                  initial_parameters=_jax_vqe_inits(jvar.HardwareEfficientAnsatz(n, depth), seed, restarts))
    assert got.energy == pytest.approx(want.energy, abs=TRACE_TOL)


def test_vqe_float64_states_follow_the_jax_trace():
    n, depth, steps = 3, 2, 40
    terms = var.tfim_hamiltonian(n, J=0.8, h=1.2)
    want = jvar.vqe(terms, n, depth=depth, steps=steps, key=jax.random.PRNGKey(4), rdtype=jnp.float64)
    got = var.vqe(terms, n, depth=depth, steps=steps, rdtype=torch.float64, device="cpu",
                  initial_parameters=_jax_vqe_inits(jvar.HardwareEfficientAnsatz(n, depth), 4, 1))
    assert got.state.dtype == np.complex128
    assert np.abs(got.energies - want.energies).max() < TRACE_TOL


def test_vqe_needs_an_initial_array_per_restart():
    with pytest.raises(ValueError, match="restarts"):
        var.vqe(var.tfim_hamiltonian(3), 3, depth=1, steps=1, restarts=2, initial_parameters=[np.zeros((2, 3))],
                device="cpu")


@pytest.mark.parametrize("seed", [2, 7])
def test_qaoa_follows_the_jax_trace(seed):
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2, 0.5)]
    want = jvar.qaoa_maxcut(4, edges, p=2, steps=150, learning_rate=0.08, key=jax.random.PRNGKey(seed))
    got = var.qaoa_maxcut(4, edges, p=2, steps=150, learning_rate=0.08, initial_parameters=_jax_qaoa_init(seed, 2),
                          device="cpu")
    assert np.abs(got.expectations - want.expectations).max() < TRACE_TOL
    np.testing.assert_allclose(got.parameters, want.parameters, atol=TRACE_TOL)
    assert got.expected_cut == pytest.approx(want.expected_cut, abs=TRACE_TOL)
    assert (got.best_bitstring, got.best_cut, got.optimal_cut) == (want.best_bitstring, want.best_cut, want.optimal_cut)
    assert got.approximation_ratio == pytest.approx(want.approximation_ratio, abs=TRACE_TOL)


@pytest.mark.parametrize("seed,n,p", [(2, 4, 2), (7, 4, 2), (3, 6, 3)])
def test_qaoa_adjoint_route_follows_the_jax_trace(seed, n, p):
    """The card route's loop (QAOAOptimizer over qaoa_step, here on the
    engine's torch backend at complex128) from the JAX draw of the initial
    angles: every step's expected cut and the final angles against
    jvar.qaoa_maxcut's, on whole-weight graphs."""
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2, 2)] if n == 4 else var.random_regular_graph(n, 3, seed)
    steps = 150
    want = jvar.qaoa_maxcut(n, edges, p=p, steps=steps, learning_rate=0.08, key=jax.random.PRNGKey(seed))
    run = var.QAOAOptimizer(var.qaoa_engine(n, dtype=torch.complex128, device="cpu"), qops.CostTable(n, edges, "cpu"),
                            _jax_qaoa_init(seed, p), learning_rate=0.08)
    trace = np.array([run.step()[0] for _ in range(steps)])
    assert np.abs(trace - want.expectations).max() < TRACE_TOL
    np.testing.assert_allclose(run.params.detach().numpy(), want.parameters, atol=TRACE_TOL)


@pytest.mark.parametrize("n,p,seed", [(6, 1, 1), (6, 3, 2), (8, 4, 4)])
def test_qaoa_step_gradient_is_jax_grad(n, p, seed):
    """qaoa_step's expected cut and adjoint gradient at complex128 against
    jax.value_and_grad of the JAX package's expected cut (its cost vector
    and traced RX butterflies, at complex128), within 1e-10."""
    edges = var.random_regular_graph(n, 3, seed)
    cost = jnp.asarray(jvar.maxcut_cost_vector(n, edges), dtype=jnp.float64)

    def expected_cut(prm):
        z = jnp.full((1 << n,), 1.0 / np.sqrt(1 << n), dtype=jnp.complex128)
        for k in range(p):
            z = z * jnp.exp(-1j * prm[0, k] * cost)
            for q in range(n):
                z = jvar._rot_x(z, q, n, 2.0 * prm[1, k])
        return jnp.sum((jnp.real(z) ** 2 + jnp.imag(z) ** 2) * cost)

    prm = np.random.default_rng(seed).uniform(0.05, 0.9, (2, p))
    e_want, g_want = jax.value_and_grad(expected_cut)(jnp.asarray(prm))
    e, g = var.qaoa_step(var.qaoa_engine(n, dtype=torch.complex128, device="cpu"), qops.CostTable(n, edges, "cpu"), prm)
    assert abs(e - float(e_want)) <= 1e-10 * abs(e)
    assert np.abs(g - np.asarray(g_want)).max() <= 1e-10 * np.abs(g).max()


def test_initial_parameters_are_not_modified():
    inits = _jax_vqe_inits(jvar.HardwareEfficientAnsatz(3, 1), 0, 1)
    before = inits[0].copy()
    var.vqe(var.tfim_hamiltonian(3), 3, depth=1, steps=5, initial_parameters=inits, device="cpu")
    np.testing.assert_array_equal(inits[0], before)


# -- the JAX suite's own assertions (tests/test_variational.py), on the port ---------


def test_vqe_tfim_ground_state():
    n = 4
    terms = var.tfim_hamiltonian(n, J=1.0, h=1.0)
    exact = float(np.linalg.eigvalsh(var.dense_hamiltonian(terms, n))[0])
    res = var.vqe(terms, n, depth=3, steps=250, learning_rate=0.08, seed=1, restarts=3, device="cpu")
    assert res.energy >= exact - 1e-5 * abs(exact)
    assert res.energy <= exact + 0.02 * abs(exact)
    assert res.energies[-1] < res.energies[0]
    psi = res.state
    H = var.dense_hamiltonian(terms, n)
    assert float(np.real(psi.conj() @ H @ psi)) == pytest.approx(res.energy, abs=1e-4)


def test_vqe_heisenberg():
    n = 3
    terms = var.heisenberg_hamiltonian(n)
    exact = float(np.linalg.eigvalsh(var.dense_hamiltonian(terms, n))[0])
    res = var.vqe(terms, n, depth=4, steps=350, learning_rate=0.06, seed=5, restarts=3, device="cpu")
    assert res.energy >= exact - 1e-5 * abs(exact)
    assert res.energy <= exact + 0.01 * abs(exact)


def test_ansatz_ring_vs_brick_expressivity():
    n = 4
    terms = var.tfim_hamiltonian(n)
    exact = float(np.linalg.eigvalsh(var.dense_hamiltonian(terms, n))[0])
    ring = var.vqe(terms, n, steps=250, learning_rate=0.08, seed=1, restarts=2, device="cpu",
                   ansatz=var.HardwareEfficientAnsatz(n, 3, entangler="ring"))
    brick = var.vqe(terms, n, steps=250, learning_rate=0.08, seed=1, restarts=2, device="cpu",
                    ansatz=var.HardwareEfficientAnsatz(n, 3, entangler="brick"))
    assert brick.energy < ring.energy
    assert (brick.energy - exact) / abs(exact) < 0.01


def test_qaoa_maxcut_square():
    edges = [(0, 1), (1, 2), (2, 3), (3, 0)]
    res = var.qaoa_maxcut(4, edges, p=2, steps=150, learning_rate=0.08, seed=2, device="cpu")
    assert res.optimal_cut == 4.0
    assert res.best_cut == 4.0
    assert res.approximation_ratio > 0.9
    assert res.expectations[-1] > res.expectations[0]
