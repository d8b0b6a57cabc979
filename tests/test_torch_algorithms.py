"""The port's generic algorithm layer (quantumcomputer_tpu_torch/algorithms/
grover.py, oracle_algorithms.py, simon.py, qpe.py, amplitude_estimation.py,
quantum_volume.py) against the JAX package's, on the CPU at the JAX suite's
sizes, with the same draws: each test takes its draws from the JAX key in
the order the JAX function splits and uses it.

Tolerances: measured indices, hidden strings, QPE readouts (x, raw) and
records' bits exactly; success and branch probabilities within 1e-5 and
1e-6 at complex64 (the JAX suite's own); QV's ideal heavy weights exactly
(one numpy oracle), its measured HOPs and verdict exactly; the planned
(cuda backend) complex64 Grover state within the complex64 circuit bound
3e-5 of the JAX state."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.algorithms import amplitude_estimation as jae
from quantumcomputer_tpu.algorithms import grover as jgrover
from quantumcomputer_tpu.algorithms import oracle_algorithms as jora
from quantumcomputer_tpu.algorithms import qpe as jqpe
from quantumcomputer_tpu.algorithms import quantum_volume as jqv
from quantumcomputer_tpu.algorithms import simon as jsimon
from quantumcomputer_tpu.models import circuit as jcir
from quantumcomputer_tpu.sim.engine import Register as JRegister
from quantumcomputer_tpu.sim.engine import StateVectorEngine as JEngine
from quantumcomputer_tpu_torch import Register, StateVectorEngine, interop
from quantumcomputer_tpu_torch.algorithms import amplitude_estimation as ae
from quantumcomputer_tpu_torch.algorithms import grover, qpe, quantum_volume as qv, simon
from quantumcomputer_tpu_torch.algorithms import oracle_algorithms as ora
from quantumcomputer_tpu_torch.models import circuit as tcir
from quantumcomputer_tpu_torch.sim import engine as tengine


def _r(key, dtype=jnp.float32) -> float:
    """The draw a JAX engine's measure(state, key) takes (float32 for
    complex64 and complex32, float64 for complex128)."""
    return float(jax.random.uniform(key, dtype=dtype))


def _eng(L, M, dtype=torch.complex64, **kw):
    return StateVectorEngine(Register(L=L, M=M), dtype=dtype, backend=kw.pop("backend", "torch"), **kw)


# -- Grover ------------------------------------------------------------------


@pytest.mark.parametrize("n,marked,iters", [(6, 40, None), (8, 173, None), (7, 5, 3), (2, 1, 1)])
def test_grover_circuit_equals_jax(n, marked, iters):
    assert grover.grover_iterations(n) == jgrover.grover_iterations(n)
    assert grover.grover_circuit(n, marked, iters) == interop.circuit_from_reference(
        jgrover.grover_circuit(n, marked, iters))


@pytest.mark.parametrize("seed", range(3))
def test_grover_search_matches_jax(seed):
    n, marked = 8, 173
    key = jax.random.PRNGKey(seed)
    want_idx, want_p = jgrover.grover_search(n, marked, key, engine=JEngine(JRegister(L=n, M=0)))
    idx, p = grover.grover_search(n, marked, _r(key), engine=_eng(n, 0))
    assert idx == want_idx == marked
    assert abs(p - want_p) < 1e-5


def test_grover_probability_matches_theory_and_jax():
    n, marked = 6, 40
    eng = _eng(n, 0)
    for r in (1, 3, grover.grover_iterations(n)):
        _, p = grover.grover_search(n, marked, 0.5, engine=eng, iterations=r)
        _, want_p = jgrover.grover_search(n, marked, jax.random.PRNGKey(1), engine=JEngine(JRegister(L=n, M=0)),
                                          iterations=r)
        theory = math.sin((2 * r + 1) * math.asin(1.0 / math.sqrt(1 << n))) ** 2
        assert abs(p - theory) < 1e-5 and abs(p - want_p) < 1e-5


def test_grover_planned_state_matches_jax():
    """The cuda backend's plan (fused segments, mcphase in place on the
    planes), here through the plain versions on CPU planes."""
    n, marked = 9, 300
    jc = jgrover.grover_circuit(n, marked, 4)
    want = np.asarray(JEngine(JRegister(L=n, M=0), dtype=jnp.complex64).run(jc, JEngine(JRegister(L=n, M=0)).zero_state()))
    circ = interop.circuit_from_reference(jc)
    plan = tengine.plan_circuit(circ, 0, n, torch.float32, "cpu")
    assert sum(e[0] == "single" and e[1].name == "mcphase" for e in plan) == 8
    got = tengine.apply_circuit_fused_(tengine.sv.zero_planar(n), circ, 0, plan)
    np.testing.assert_allclose(interop.state_to_numpy(got), want, atol=3e-5)


def test_grover_default_engine_draws_from_the_seed():
    a = grover.grover_search(6, 17, seed=4)
    b = grover.grover_search(6, 17, engine=_eng(6, 0), r=float(torch.rand((), generator=torch.Generator().manual_seed(4))))
    assert a == b and a[0] == 17


# -- Bernstein-Vazirani / Deutsch-Jozsa ---------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_bernstein_vazirani_matches_jax(seed):
    n = 8
    s = int(np.random.default_rng(seed).integers(0, 1 << n))
    key = jax.random.PRNGKey(seed)
    assert interop.circuit_from_reference(jora.bv_circuit(n, s)) == ora.bv_circuit(n, s)
    want = jora.bernstein_vazirani(n, s, key)
    assert ora.bernstein_vazirani(n, s, _r(key), engine=_eng(n, 0)) == want == s


@pytest.mark.parametrize("s", [0, 1, 0b1010101, 0b1111111])
def test_deutsch_jozsa_matches_jax(s):
    n = 7
    oracle_j = jora.bv_oracle(n, s) if s else []
    oracle_t = ora.bv_oracle(n, s) if s else []
    want = jora.deutsch_jozsa(n, oracle_j)
    got = ora.deutsch_jozsa(n, oracle_t, _r(jax.random.PRNGKey(0)), engine=_eng(n, 0))
    assert got is want is (s == 0)


def test_bv_complex32_and_validation():
    n, s = 10, 0b1100110101
    assert ora.bernstein_vazirani(n, s, 0.7, dtype="complex32") == s  # the kernels' plain versions on bf16 planes
    with pytest.raises(ValueError) as want:
        jora.bv_oracle(4, 16)
    with pytest.raises(ValueError) as got:
        ora.bv_oracle(4, 16)
    assert str(got.value) == str(want.value)


# -- Simon ----------------------------------------------------------------------


def _simon_draws(key, rounds, dtype=jnp.float32):
    """The per-round draws of the JAX simon_search: one split per round."""
    rs = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        rs.append(_r(sub, dtype))
    return rs


@pytest.mark.parametrize("seed,n,s", [(0, 5, 0b10110), (1, 6, 0b000011), (2, 4, 0b1000)])
def test_simon_matches_jax(seed, n, s):
    key = jax.random.PRNGKey(seed)
    want = jsimon.simon_search(n, s, key)
    got = simon.simon_search(n, s, _simon_draws(key, 4 * n + 12), engine=_eng(n, n))
    assert (got.s, got.rounds, got.equations) == (want.s, want.rounds, want.equations)
    assert got.s == s


def test_simon_complex128_and_circuit():
    key = jax.random.PRNGKey(9)
    want = jsimon.simon_search(5, 0b01010, key, dtype=jnp.complex128)
    got = simon.simon_search(5, 0b01010, _simon_draws(key, 32, jnp.float64), dtype=torch.complex128)
    assert (got.s, got.rounds, got.equations) == (want.s, want.rounds, want.equations)
    assert simon.simon_circuit(6, 0b110110) == interop.circuit_from_reference(jsimon.simon_circuit(6, 0b110110))
    for bad in (0, 16):
        with pytest.raises(ValueError) as w:
            jsimon.simon_oracle(4, bad)
        with pytest.raises(ValueError) as g:
            simon.simon_oracle(4, bad)
        assert str(g.value) == str(w.value)


def test_gf2_nullspace_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(200):
        n = int(rng.integers(2, 9))
        rows = [int(x) for x in rng.integers(0, 1 << n, int(rng.integers(1, 2 * n)))]
        assert simon._gf2_nullspace(rows, n) == jsimon._gf2_nullspace(rows, n)


# -- QPE -----------------------------------------------------------------------


def _phase_cu(mod, phi):
    return lambda j, control: [mod.CPHASE(control, 0, 2.0 * math.pi * phi * (1 << j))]


def _phase_u(mod, phi):
    return lambda j: [mod.PHASE(0, 2.0 * math.pi * phi * (1 << j))]


@pytest.mark.parametrize("k", [0, 1, 5, 11, 15])
def test_estimate_phase_matches_jax(k):
    key = jax.random.PRNGKey(k)
    want = jqpe.estimate_phase(_phase_cu(jcir, k / 16.0), 4, 1, key)
    got = qpe.estimate_phase(_phase_cu(tcir, k / 16.0), 4, 1, _r(key), engine=_eng(4, 1))
    assert (got.x, got.raw, got.t) == (want.x, want.raw, want.t) and got.x == k
    assert got.phase == k / 16.0
    assert qpe.qpe_circuit(_phase_cu(tcir, 0.3), 4, 2, (tcir.X(0),)) == interop.circuit_from_reference(
        jqpe.qpe_circuit(_phase_cu(jcir, 0.3), 4, 2, (jcir.X(0),)))


@pytest.mark.parametrize("k", [0, 3, 8, 13])
def test_semiclassical_qpe_matches_jax(k):
    key = jax.random.PRNGKey(k)
    want = jqpe.run_semiclassical_qpe(_phase_u(jcir, k / 16.0), 4, 1, key)
    rs = np.asarray(jax.random.uniform(key, (4,), dtype=jnp.float32))
    got = qpe.run_semiclassical_qpe(_phase_u(tcir, k / 16.0), 4, 1, rs)
    assert (got.x, got.raw, got.record.bits) == (want.x, want.raw, want.record.bits) and got.x == k
    np.testing.assert_allclose(got.record.branch_probs, want.record.branch_probs, rtol=0, atol=1e-6)


def _h_cu(mod):
    s = 1.0 / math.sqrt(2.0)
    ch = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, s, s], [0, 0, s, -s]], np.complex128)
    return lambda j, control: [] if j else [mod.U2Q(control, 0, ch)]


def test_semiclassical_qpe_every_branch_matches_jax():
    """U = H on |1> (not an eigenstate): every forced branch's record and
    conditionals against the JAX package's, and the joint branch
    distribution against the port's full-register engine."""
    t, M = 3, 1
    amps = tengine.sv.to_numpy_complex(_eng(t, M).run(qpe.qpe_circuit(_h_cu(tcir), t, M)))
    full = np.zeros(1 << t)
    for idx in range(1 << (t + M)):
        counting = idx >> M
        x_tilde = sum(((counting >> i) & 1) << (t - 1 - i) for i in range(t))
        full[((1 << t) - x_tilde) % (1 << t)] += abs(amps[idx]) ** 2
    semi = np.zeros(1 << t)
    for branch in range(1 << t):
        forced = [(branch >> s) & 1 for s in range(t)]
        want = jqpe.run_semiclassical_qpe(lambda j: [] if j else [jcir.H(0)], t, M, jax.random.PRNGKey(0),
                                          forced_bits=forced)
        got = qpe.run_semiclassical_qpe(lambda j: [] if j else [tcir.H(0)], t, M, [0.0] * t, forced_bits=forced)
        assert (got.raw, got.x, got.record.bits) == (want.raw, want.x, want.record.bits) == (branch, got.x, forced)
        np.testing.assert_allclose(got.record.branch_probs, want.record.branch_probs, rtol=0, atol=1e-6)
        p = got.record.probability
        semi[got.x] = 0.0 if math.isnan(p) else p
    np.testing.assert_allclose(semi, full, atol=1e-6)


def test_semiclassical_qpe_complex32_prep_and_checks():
    res = qpe.run_semiclassical_qpe(_phase_u(tcir, 6 / 16.0), 4, 1, seed=0, dtype="complex32")
    assert res.x == 6
    np.testing.assert_allclose(res.record.branch_probs, 1.0, atol=5e-2)
    key = jax.random.PRNGKey(2)
    want = jqpe.run_semiclassical_qpe(_phase_u(jcir, 11 / 16.0), 4, 1, key, prep=(jcir.X(0),))
    got = qpe.run_semiclassical_qpe(_phase_u(tcir, 11 / 16.0), 4, 1, np.asarray(jax.random.uniform(key, (4,))),
                                    prep=(tcir.X(0),))
    assert got.x == want.x == 0
    with pytest.raises(ValueError, match="forced_bits"):
        qpe.run_semiclassical_qpe(_phase_u(tcir, 0.25), 4, 1, forced_bits=[1, 0])
    with pytest.raises(ValueError, match="does not match QPE geometry"):
        qpe.estimate_phase(_phase_cu(tcir, 0.25), 3, 2, 0.5, engine=_eng(4, 2))
    with pytest.raises(ValueError, match="layout"):
        qpe.estimate_phase(_phase_cu(tcir, 0.25), 3, 2, 0.5, engine=_eng(3, 2, layout="m_high"))


def test_qpe_recovers_shor_period_as_jax():
    from quantumcomputer_tpu_torch.algorithms import number_theory as nt

    C, a, t, M = 15, 7, 3, 4
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = jqpe.estimate_phase(lambda j, c: [jcir.CAMODC(C, pow(a, 1 << j, C), c)], t, M, key)
        got = qpe.estimate_phase(lambda j, c: [tcir.CAMODC(C, pow(a, 1 << j, C), c)], t, M, _r(key),
                                 engine=_eng(t, M))
        assert (got.x, got.raw) == (want.x, want.raw)
        if nt.find_period_from_omega(got.raw / float(1 << t), a, C) == 4:
            return
    raise AssertionError("no draw recovered the period 4")


# -- Amplitude estimation ----------------------------------------------------------


@pytest.mark.parametrize("n,marked,t,seed", [(2, [0, 1], 3, 0), (2, [0, 1], 3, 3), (3, [5], 5, 1), (3, [1, 6], 4, 2)])
def test_amplitude_estimate_matches_jax(n, marked, t, seed):
    key = jax.random.PRNGKey(seed)
    want = jae.amplitude_estimate(n, marked, t, key)
    got = ae.amplitude_estimate(n, marked, t, _r(key), engine=_eng(t, n))
    assert (got.qpe.x, got.qpe.raw) == (want.qpe.x, want.qpe.raw)
    assert got.a_hat == want.a_hat
    assert ae._controlled_grover_iterate(n, marked, n + 1) == list(
        interop.circuit_from_reference(jae._controlled_grover_iterate(n, marked, n + 1)))


def test_amplitude_estimate_validation_matches_jax():
    for args in ((2, [], 3), (2, [4], 3), (1, [0, 1], 3)):
        with pytest.raises(ValueError) as w:
            jae.amplitude_estimate(*args, jax.random.PRNGKey(0))
        with pytest.raises(ValueError) as g:
            ae.amplitude_estimate(*args, 0.5)
        assert str(g.value) == str(w.value)


def test_amplitude_estimate_planned_with_mcphase():
    """The cuda backend's plan on CPU planes: every MCPHASE in place, the
    exact case a = 1/2 reads 1/2."""
    n, t = 2, 3
    eng = _eng(t, n)
    prep = (tcir.X(0),) + tuple(tcir.H(q) for q in range(n))
    circ = qpe.qpe_circuit(lambda j, c: ae._controlled_grover_iterate(n, [0, 1], c) * (1 << j), t, n, prep)
    planned = tengine.apply_circuit_fused_(eng.initial_state(), circ, n)
    np.testing.assert_allclose(interop.state_to_numpy(planned), interop.state_to_numpy(eng.run(circ)), atol=3e-5)


@pytest.mark.parametrize("n,marked,t", [(4, [3, 9], 5), (3, [6], 6), (5, [1, 2, 30], 4)])
def test_amplitude_estimate_readout_distribution(n, marked, t, monkeypatch):
    """kernel_checks.ae_counting_probabilities, which the card's check of
    amplitude estimation reads its expected readout from, is the counting
    register's distribution of the complex128 run (1e-12), and every draw
    reads the value its interval holds (readouts_within with no slack)."""
    from quantumcomputer_tpu_torch.utils import kernel_checks

    want = kernel_checks.ae_counting_probabilities(n, len(marked), t)
    eng = _eng(t, n, torch.complex128)
    marginals = []
    run = eng.run

    def observed_run(circ, state=None):
        out = run(circ, state)
        marginals.append(kernel_checks.counting_marginal(out, n))  # before measure collapses it
        return out

    monkeypatch.setattr(eng, "run", observed_run)
    for r in np.random.default_rng(t).random(12):
        res = ae.amplitude_estimate(n, marked, t, float(r), engine=eng)
        np.testing.assert_allclose(marginals[-1], want, rtol=0, atol=1e-12)
        assert kernel_checks.readouts_within(want, float(r), 0.0) == [int(f"{res.qpe.raw:0{t}b}"[::-1], 2)]


def test_amplitude_estimate_drift_script_on_cpu(capsys):
    """scripts/prof_ae_drift.py at a small size on the CPU (the kernels'
    plain versions): complex64 within 1e-6 of the ideal distribution in
    total variation, complex32 within 1e-2 (bf16 storage)."""
    from quantumcomputer_tpu_torch.scripts import prof_ae_drift

    assert prof_ae_drift.main(["--device", "cpu", "--sizes", "5,4"]) == 0
    lines = capsys.readouterr().out.splitlines()
    tv = {line.split()[2]: float(line.split("total variation ")[1].split(",")[0]) for line in lines}
    assert tv["complex64"] <= 1e-6 and tv["complex32"] <= 1e-2, lines


# -- Quantum volume ------------------------------------------------------------------


def test_qv_circuits_and_oracle_equal_jax():
    for seed, m in ((0, 5), (3, 6), (7, 3)):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):
            jc = jqv.qv_model_circuit(m, jr)
            tc = qv.qv_model_circuit(m, tr)
            assert tc == interop.circuit_from_reference(jc)
            np.testing.assert_array_equal(qv.ideal_probabilities(tc, m), jqv.ideal_probabilities(jc, m))
            p = qv.ideal_probabilities(tc, m)
            np.testing.assert_array_equal(qv.heavy_set(p), jqv.heavy_set(p))
    u = qv.haar_su4(np.random.default_rng(0))
    np.testing.assert_array_equal(u, jqv.haar_su4(np.random.default_rng(0)))
    with pytest.raises(ValueError):
        qv.qv_model_circuit(1, np.random.default_rng(0))
    with pytest.raises(ValueError):
        qv.ideal_probabilities((tcir.H(0),), 2)


def _qv_draws(key, num_circuits, shots, dtype=jnp.float32):
    rs = []
    for _ in range(num_circuits):
        key, sub = jax.random.split(key)
        rs.append(np.asarray(jax.random.uniform(sub, (shots,), dtype=dtype)))
    return np.stack(rs)


@pytest.mark.parametrize("m,num_circuits,shots,seed", [(4, 12, 60, 1), (3, 4, 100, 7), (5, 6, 40, 2)])
def test_run_quantum_volume_matches_jax(m, num_circuits, shots, seed):
    want = jqv.run_quantum_volume(m, JEngine(JRegister(L=m, M=0), dtype=jnp.complex64),
                                  num_circuits=num_circuits, shots=shots, seed=seed)
    rs = _qv_draws(jax.random.PRNGKey(seed), num_circuits, shots)
    got = qv.run_quantum_volume(m, _eng(m, 0), num_circuits=num_circuits, shots=shots, seed=seed, rs=rs)
    assert got.ideal_hops == want.ideal_hops
    assert got.hops == want.hops
    assert (got.mean_hop, got.lower_2sigma, got.passed, got.quantum_volume) == (
        want.mean_hop, want.lower_2sigma, want.passed, want.quantum_volume)
    assert got.to_dict() == want.to_dict()


def test_qv_passes_complex32_and_from_the_seed():
    eng = StateVectorEngine(Register(L=4, M=0), dtype="complex32")  # the kernels' plain versions on the CPU
    res = qv.run_quantum_volume(4, eng, num_circuits=30, shots=80, seed=5)
    assert res.passed and res.quantum_volume == 16 and 0.75 < res.mean_hop < 1.0
    a = qv.run_quantum_volume(3, _eng(3, 0), num_circuits=3, shots=20, seed=4)
    b = qv.run_quantum_volume(3, _eng(3, 0), num_circuits=3, shots=20, seed=4, rs=_eng(3, 0).draws((3, 20), 4))
    assert a.hops == b.hops
    with pytest.raises(ValueError, match="rs must have shape"):
        qv.run_quantum_volume(3, _eng(3, 0), num_circuits=3, shots=20, rs=np.zeros((2, 20)))


def test_engine_sample_matches_jax():
    """engine.sample against the JAX engine's for the same key's draws
    (the flat path at n = 10, complex64)."""
    n = 10
    jc = jqv.qv_model_circuit(n, np.random.default_rng(3))
    jeng = JEngine(JRegister(L=n, M=0), dtype=jnp.complex64)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jeng.sample(jeng.run(jc, jeng.zero_state()), key, 200))
    eng = _eng(n, 0)
    got = eng.sample(eng.run(interop.circuit_from_reference(jc), eng.zero_state()),
                     np.asarray(jax.random.uniform(key, (200,), dtype=jnp.float32)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
