"""The port's sharded engine (quantumcomputer_tpu_torch/parallel/sharded.py)
against the JAX package's ShardedStateVectorEngine on the 8 forced host
devices and against the port's single-device engine, with the same
circuits, states and draws.

Tolerances: 1e-12 at complex128 (the JAX mesh suite's bound), 3e-5 at
complex64 (the fused path at n - d = 14, as tests/test_sharded.py holds
the JAX fused mesh path); measured and sampled indices equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.algorithms import shor as jshor
from quantumcomputer_tpu.models import circuit as jcir
from quantumcomputer_tpu.models import shor_circuit as jsc
from quantumcomputer_tpu.parallel import mesh as jmesh
from quantumcomputer_tpu.parallel.sharded import ShardedStateVectorEngine as JSharded
from quantumcomputer_tpu.sim.engine import Register as JRegister
from quantumcomputer_tpu.sim.engine import StateVectorEngine as JEngine
from quantumcomputer_tpu_torch import interop
from quantumcomputer_tpu_torch.algorithms import shor
from quantumcomputer_tpu_torch.models.circuit import dagger_circuit
from quantumcomputer_tpu_torch.ops import fused
from quantumcomputer_tpu_torch.parallel.mesh import build_mesh
from quantumcomputer_tpu_torch.parallel.sharded import ShardedStateVectorEngine, plan_sharded
from quantumcomputer_tpu_torch.sim import checkpoint
from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
from quantumcomputer_tpu_torch.utils.profiling import mesh_collective_report

ATOL = 1e-12
C64_TOL = 3e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread a test: the suite runs in several worker
    processes at once (pytest-xdist), and torch's default of a thread a core
    in each of them oversubscribes the CPU (a sharded run of a few seconds
    took minutes under that load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

_rng = np.random.default_rng(1234)
_U4 = np.linalg.qr(_rng.standard_normal((4, 4)) + 1j * _rng.standard_normal((4, 4)))[0]

# n = 6 on 8 shards: qubits 3, 4, 5 are global (tests/test_sharded.py's circuits).
GATE_CLASSES = {
    "hadamard_butterflies": tuple(jcir.H(q) for q in range(6)),
    "dense_1q": (jcir.H(5), jcir.X(4), jcir.RY(3, 0.7), jcir.RX(5, 1.1), jcir.Y(4)),
    "diagonals": (
        jcir.H(5), jcir.H(4), jcir.H(3), jcir.H(2), jcir.Z(5), jcir.PHASE(4, 0.33), jcir.RZ(3, -0.9),
        jcir.CPHASE(5, 4, 0.21), jcir.CPHASE(5, 1, 0.43), jcir.CPHASE(2, 0, 0.55), jcir.CZ(4, 0),
        jcir.CPHASE(1, 3, 0.66),
    ),
    "dense_2q_one_global": (
        jcir.H(5), jcir.H(2), jcir.H(0), jcir.CNOT(4, 1), jcir.CNOT(1, 4), jcir.SWAP(5, 0), jcir.U2Q(3, 2, _U4),
    ),
    "dense_2q_both_global": (
        jcir.H(5), jcir.H(3), jcir.H(1), jcir.CNOT(5, 4), jcir.CNOT(3, 5), jcir.SWAP(4, 3), jcir.U2Q(5, 3, _U4),
    ),
    "iqft_stages": tuple([jcir.H(q) for q in range(2, 6)] + [jcir.Gate("iqft_stage", (l,)) for l in (5, 4, 3, 2)]),
    "mcphase": (jcir.H(5), jcir.H(4), jcir.H(1), jcir.H(0), jcir.MCPHASE((5, 4, 1), 0.7), jcir.MCPHASE((5, 3), 0.2),
                jcir.MCPHASE((1, 0), -0.4)),
}


def _engines(L, M, d, dtype=torch.complex128, layout="standard", backend="auto"):
    jdt = {torch.complex128: jnp.complex128, torch.complex64: jnp.complex64}[dtype]
    want = JSharded(JRegister(L=L, M=M), dtype=jdt, mesh=jmesh.build_mesh(num_devices=1 << d), layout=layout)
    got = ShardedStateVectorEngine(Register(L=L, M=M), dtype=dtype, mesh=build_mesh(1 << d), layout=layout,
                                   backend=backend)
    return want, got


def _shor(C, a, L, M, layout):
    build = jsc.shor_circuit_mhigh if layout == "m_high" else jsc.shor_circuit
    return build(C, a, L, M)


@pytest.mark.parametrize("name", list(GATE_CLASSES))
def test_gate_classes_on_global_qubits_match_jax(name):
    jc = GATE_CLASSES[name]
    want, got = _engines(4, 2, 3)
    single = StateVectorEngine(Register(4, 2), dtype=torch.complex128, backend="torch")
    c = interop.circuit_from_reference(jc)
    out = got.to_numpy(got.run(c))
    np.testing.assert_allclose(out, want.to_numpy(want.run(jc)), atol=ATOL)
    np.testing.assert_allclose(out, single.to_numpy(single.run(c)), atol=ATOL)


def test_global_control_oracle_matches_jax():
    """n = 7 on 8 shards: the oracle's controls 4-6 are global (the permute
    or the identity, no exchange), the work register local."""
    jc = jsc.shor_circuit(15, 7, 3, 4)
    want, got = _engines(3, 4, 3)
    out = got.to_numpy(got.run(interop.circuit_from_reference(jc)))
    np.testing.assert_allclose(out, want.to_numpy(want.run(jc)), atol=ATOL)
    assert got.comm.stats["ppermute"]["count"] == 6  # 3 H and 3 iQFT stages on global qubits


@pytest.mark.parametrize("layout", ["standard", "m_high"])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("C,a,L,M", [(15, 7, 3, 4), (21, 2, 4, 5)])
def test_full_shor_circuit_matches_jax(C, a, L, M, d, layout):
    jc = _shor(C, a, L, M, layout)
    want, got = _engines(L, M, d, layout=layout)
    single = StateVectorEngine(Register(L, M), dtype=torch.complex128, backend="torch", layout=layout)
    c = interop.circuit_from_reference(jc)
    out = got.to_numpy(got.run(c))
    np.testing.assert_allclose(out, want.to_numpy(want.run(jc)), atol=ATOL)
    np.testing.assert_allclose(out, single.to_numpy(single.run(c)), atol=ATOL)


def test_mhigh_ladders_fuse_only_runs_of_at_least_D():
    """The JAX rule: a run of >= D m_high oracles fuses into one ladder (a
    rotation of D - 1 shard exchanges), shorter runs stay packed singles."""
    jc = jsc.shor_circuit_mhigh(33, 7, 5, 6)
    c = interop.circuit_from_reference(jc)
    names = lambda d: [e[1].name for e in plan_sharded(c, 11, 0, d, torch.float64, False, True) if e[0] == "gate"]
    assert names(2).count("camodc_ladder_high") == 1 and names(2).count("camodc_high") == 0  # 5 >= 4
    assert names(3).count("camodc_ladder_high") == 0 and names(3).count("camodc_high") == 5  # 5 < 8
    assert [e[1].name for e in plan_sharded(c, 11, 0, 2, torch.float64, False, False)].count("camodc_high") == 5
    want, got = _engines(5, 6, 2, layout="m_high")
    np.testing.assert_allclose(got.to_numpy(got.run(c)), want.to_numpy(want.run(jc)), atol=ATOL)
    assert got.comm.stats["ppermute"]["count"] == 3  # one ladder: D - 1 rotation rounds


@pytest.mark.parametrize("layout", ["standard", "m_high"])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_fused_path_at_14_local_qubits(d, layout, monkeypatch):
    """n - d = 14: shard-local runs go through the fused planner, every
    shard applying each segment and each shard-local standard oracle gate,
    its one-op segment (the kernels' plain versions on CPU shards); against
    the JAX single-chip engine and the port's, complex64."""
    C, a, M = 33, 7, 6
    L = 14 + d - M
    jc = _shor(C, a, L, M, layout)
    c = interop.circuit_from_reference(jc)
    calls = []
    apply_fused = fused.apply_fused
    monkeypatch.setattr(fused, "apply_fused", lambda *args: calls.append(args[0].shape) or apply_fused(*args))
    eng = ShardedStateVectorEngine(Register(L, M), dtype=torch.complex64, mesh=build_mesh(1 << d), layout=layout,
                                   backend="cuda")
    segments = sum(e[0] == "fused" for e in eng.plan(c))
    oracles = sum(e[0] == "gate" and e[1].name == "camodc" and e[1].qubits[0] < 14 for e in eng.plan(c))
    assert (oracles > 0) == (layout == "standard")
    out = eng.to_numpy(eng.run(c))
    assert segments > 0 and len(calls) == (1 << d) * (segments + oracles) and set(calls) == {(2, 1 << 14)}
    want = JEngine(JRegister(L=L, M=M), dtype=jnp.complex64, backend="xla", layout=layout)
    np.testing.assert_allclose(out, want.to_numpy(want.run(jc)), atol=C64_TOL)
    single = StateVectorEngine(Register(L, M), dtype=torch.complex64, backend="torch", layout=layout)
    np.testing.assert_allclose(out, single.to_numpy(single.run(c)), atol=C64_TOL)


@pytest.mark.parametrize("dtype,L,M,d", [(torch.complex128, 3, 4, 3), (torch.complex64, 12, 6, 2)],
                         ids=["complex128_flat", "complex64_block_sums"])
def test_measure_matches_jax_for_the_same_draws(dtype, L, M, d):
    """The two-level pick: the index JAX's mesh measure takes for a key
    equals the port's for that key's uniform; the collapsed states agree.
    At complex64 the shards hold 2^16 amplitudes, so the in-shard pick is
    the block-sum sampler."""
    jc = jsc.shor_circuit(15 if M == 4 else 33, 7, L, M)
    c = interop.circuit_from_reference(jc)
    want, got = _engines(L, M, d, dtype)
    rdt = jnp.float64 if dtype == torch.complex128 else jnp.float32
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        r = float(jax.random.uniform(key, dtype=rdt))
        i_want, c_want = want.measure(want.run(jc), key)
        i_got, c_got = got.measure(got.run(c), r)
        assert i_got == i_want, seed
        np.testing.assert_allclose(got.to_numpy(c_got), want.to_numpy(c_want), atol=ATOL)
    assert got.run_and_measure_index(c, r) == i_got == got.run_and_measure(c, r)[0]


def test_sample_matches_jax_and_does_not_collapse():
    jc = jsc.shor_circuit(15, 7, 3, 4)
    c = interop.circuit_from_reference(jc)
    want, got = _engines(3, 4, 3)
    key = jax.random.PRNGKey(9)
    rs = np.asarray(jax.random.uniform(key, (200,), dtype=jnp.float64))
    state = got.run(c)
    idx = got.sample(state, rs)
    assert idx.dtype == torch.int64 and idx.shape == (200,)
    assert idx.tolist() == np.asarray(want.sample(want.run(jc), key, 200)).tolist()
    assert all(shor.read_omega(int(i), 3, 4) in (0.0, 0.25, 0.5, 0.75) for i in idx)
    assert abs(got.norm(state) - 1.0) < ATOL
    assert abs(float(got.probabilities(state).sum()) - 1.0) < ATOL


def test_norm_trace_and_run_norm_match_jax():
    jc = jsc.shor_circuit_reference(15, 7, 3, 4)
    c = interop.circuit_from_reference(jc)
    want, got = _engines(3, 4, 3)
    _, n_want = want.run_with_norms(jc)
    _, n_got = got.run_with_norms(c)
    assert n_got.shape == np.asarray(n_want).shape == (3 * 3 + 3 * 2 // 2,)
    np.testing.assert_allclose(n_got.numpy(), np.asarray(n_want), atol=1e-13)
    single = StateVectorEngine(Register(3, 4), dtype=torch.complex128, backend="torch")
    assert abs(got.run_norm(c) - single.run_norm(c)) < ATOL


def test_adjoint_backprop_matches_the_single_device_gradient():
    """run is differentiable in its shards: the gradient of sum(out * w) is
    the dagger circuit applied to w, through the same sharded run, and
    equals the single-device engine's."""
    L, M = 4, 3
    c = interop.circuit_from_reference(jsc.shor_circuit(15, 7, L, M)[:4] + (jcir.RY(6, 0.3), jcir.CPHASE(6, 1, 0.4)))
    eng = ShardedStateVectorEngine(Register(L, M), dtype=torch.complex128, mesh=build_mesh(4))
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 1 << (L + M))))
    p = [x.requires_grad_() for x in eng.initial_state()]
    out = eng.run(c, p)
    torch.sum(torch.cat(out, dim=1) * w).backward()
    grad = torch.cat([x.grad for x in p], dim=1)
    assert torch.allclose(grad, eng.to_planar(eng.run(dagger_circuit(c, M), eng.from_planar(w))), atol=ATOL)
    single = StateVectorEngine(Register(L, M), dtype=torch.complex128, backend="torch")
    q = single.initial_state().requires_grad_()
    torch.sum(single.run(c, q) * w).backward()
    assert torch.allclose(grad, q.grad, atol=ATOL)
    assert float(p[0].detach()[0, 1]) == 1.0 and float(sum(x.detach().abs().sum() for x in p)) == 1.0  # untouched


def test_guardrails_match_jax():
    cases = [
        ((1, 3, 8, "standard"), "the work register must stay shard-local"),
        ((5, 2, 8, "m_high"), "the m_high global bits must lie inside the work register"),
        ((2, 0, 8, "standard"), "register too small"),
    ]
    for (L, M, D, layout), _ in cases:
        with pytest.raises(ValueError) as want:
            JSharded(JRegister(L=L, M=M), dtype=jnp.complex128, mesh=jmesh.build_mesh(num_devices=D), layout=layout)
        with pytest.raises(ValueError) as got:
            ShardedStateVectorEngine(Register(L, M), dtype=torch.complex128, mesh=build_mesh(D), layout=layout)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="complex32"):
        ShardedStateVectorEngine(Register(3, 4), dtype="complex32", mesh=build_mesh(2), backend="torch")


@pytest.mark.parametrize("layout", ["standard", "m_high"])
def test_shors_algorithm_with_mesh(layout):
    res = shor.shors_algorithm(15, 3, 4, forced_trial_int=7, seed=0, dtype=torch.complex128, mesh=build_mesh(8),
                               layout=layout)
    want = jshor.shors_algorithm(15, 3, 4, forced_trial_int=7, seed=0, dtype=jnp.complex128,
                                 mesh=jmesh.build_mesh(num_devices=8), layout=layout)
    assert res.ok and res.factors == want.factors == (5, 3)
    assert shor.shors_algorithm(15, 3, 4, forced_trial_int=7, seed=0, dtype="dd64", mesh=build_mesh(4)).factors == (5, 3)
    with pytest.raises(ValueError) as w:
        jshor.shors_algorithm(15, 3, 4, forced_trial_int=7, seed=0, mesh=jmesh.build_mesh(num_devices=2),
                              strict_reference=True)
    with pytest.raises(ValueError) as g:
        shor.shors_algorithm(15, 3, 4, forced_trial_int=7, seed=0, mesh=build_mesh(2), strict_reference=True)
    assert str(g.value) == str(w.value)


def test_find_period_on_the_mesh_takes_the_jax_index():
    """One attempt: the same draw gives JAX's measured index and period."""
    C, a, L, M = 21, 2, 4, 5
    want, got = _engines(L, M, 2)
    key = jax.random.PRNGKey(3)
    jrec = jshor.find_period(want, C, a, key)
    rec = shor.find_period(got, C, a, float(jax.random.uniform(key, dtype=jnp.float64)))
    assert (rec.measured_index, rec.period) == (jrec.measured_index, jrec.period)


def test_checkpointed_run_on_the_mesh_equals_the_run(tmp_path):
    c = interop.circuit_from_reference(jsc.shor_circuit(21, 2, 4, 5))
    eng = ShardedStateVectorEngine(Register(4, 5), dtype=torch.complex128, mesh=build_mesh(4))
    seg = checkpoint.run_with_checkpoints(eng, c, str(tmp_path), segment_gates=4)
    assert checkpoint.latest_segment(str(tmp_path)) == 3
    resumed = checkpoint.run_with_checkpoints(eng, c, str(tmp_path), segment_gates=4)
    np.testing.assert_array_equal(eng.to_numpy(resumed), eng.to_numpy(seg))
    np.testing.assert_allclose(eng.to_numpy(seg), eng.to_numpy(eng.run(c)), atol=ATOL)


def test_collective_report_counts_the_exchanges():
    """Bytes a shard sends, per kind: three global butterflies move one
    shard each; the packed m_high oracle moves less than a rotation."""
    eng = ShardedStateVectorEngine(Register(4, 2), dtype=torch.complex64, mesh=build_mesh(8))
    circ = interop.circuit_from_reference((jcir.H(5), jcir.H(4), jcir.H(3)))
    rep = mesh_collective_report(eng, circ)
    assert rep["ppermute"] == {"count": 3, "bytes": 3 * 8 * 8} and rep["total_bytes"] == 192 and rep["shards"] == 8
    m = ShardedStateVectorEngine(Register(5, 6), dtype=torch.complex64, mesh=build_mesh(8), layout="m_high")
    packed = mesh_collective_report(m, interop.circuit_from_reference(jsc.shor_circuit_mhigh(33, 7, 5, 6)))
    assert 0 < packed["total_bytes"] < 5 * 7 * 2 * (1 << 8) * 4  # below D - 1 shards a gate
    with pytest.raises(ValueError, match="sharded engine"):
        mesh_collective_report(StateVectorEngine(Register(3, 4), backend="torch"), circ)


def test_prof_sharded_needs_a_card(monkeypatch, capsys):
    """scripts/prof_sharded.py times the sharded flagship on the card only."""
    from quantumcomputer_tpu_torch.scripts import prof_sharded

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert prof_sharded.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert prof_sharded.FORMS == (("standard", "complex64"), ("m_high", "complex64"), ("standard", "complex32"),
                                  ("m_high", "complex32"))
