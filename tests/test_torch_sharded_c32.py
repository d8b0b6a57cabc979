"""The port's sharded engine at complex32 (bf16 planes, float32 compute)
against the JAX package's complex32 mesh engine on the 8 forced host
devices and against the port's single-device complex32 engine.

Tolerances: the JAX suite's complex32 circuit bound, 2e-3 max abs
(tests/test_sharded_c32.py, tests/test_complex32.py), and 5e-3 on norms.
Every exchange moves bf16: the transport counts half the complex64 bytes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.models import circuit as jcir
from quantumcomputer_tpu.models import shor_circuit as jsc
from quantumcomputer_tpu.parallel import mesh as jmesh
from quantumcomputer_tpu.parallel.sharded import ShardedStateVectorEngine as JSharded
from quantumcomputer_tpu.sim.engine import Register as JRegister
from quantumcomputer_tpu.sim.engine import StateVectorEngine as JEngine
from quantumcomputer_tpu_torch import interop
from quantumcomputer_tpu_torch.models.circuit import dagger_circuit
from quantumcomputer_tpu_torch.parallel.mesh import build_mesh
from quantumcomputer_tpu_torch.parallel.sharded import ShardedStateVectorEngine
from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
from quantumcomputer_tpu_torch.utils.profiling import mesh_collective_report

CIRCUIT_TOL = 2e-3
NORM_TOL = 5e-3


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


def _jamps(state) -> np.ndarray:
    re = np.asarray(state[0].astype(jnp.float32), np.float64)
    im = np.asarray(state[1].astype(jnp.float32), np.float64)
    return re + 1j * im


def _engines(L, M, d, layout="standard"):
    want = JSharded(JRegister(L=L, M=M), dtype="complex32", mesh=jmesh.build_mesh(num_devices=1 << d),
                    backend="pallas", layout=layout)
    got = ShardedStateVectorEngine(Register(L, M), dtype="complex32", mesh=build_mesh(1 << d), layout=layout)
    single = StateVectorEngine(Register(L, M), dtype="complex32", layout=layout)
    return want, got, single


def _check(jc, L, M, d, layout="standard"):
    want, got, single = _engines(L, M, d, layout)
    c = interop.circuit_from_reference(jc)
    state = got.run(c)
    assert all(x.dtype == torch.bfloat16 and x.shape == (2, 1 << (L + M - d)) for x in state)
    out = got.to_numpy(state)
    assert np.abs(out - _jamps(want.run(jc))).max() < CIRCUIT_TOL
    assert np.abs(out - single.to_numpy(single.run(c))).max() < CIRCUIT_TOL
    assert abs(np.vdot(out, out).real - 1.0) < NORM_TOL
    return got


@pytest.mark.parametrize("d", [2, 3])
def test_standard_layout_full_shor_matches_jax(d):
    """Global iQFT stages and global oracle controls at bf16 storage."""
    _check(jsc.shor_circuit(33, 29, 5, 6), 5, 6, d)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_mhigh_layout_full_shor_matches_jax(d):
    """The m_high oracle's row exchange crosses shards at bf16."""
    _check(jsc.shor_circuit_mhigh(33, 29, 6, 6), 6, 6, d, "m_high")


def test_gate_classes_at_bf16():
    circ = tuple(jcir.H(q) for q in range(8)) + (
        jcir.RY(7, 0.7), jcir.Z(6), jcir.PHASE(5, 0.33), jcir.CPHASE(7, 6, 0.21), jcir.CPHASE(7, 1, 0.43),
        jcir.CPHASE(2, 0, 0.55), jcir.Gate("camodc", (5,), meta=(13, 6)), jcir.H(7),
    )
    _check(circ, 4, 4, 3)


@pytest.mark.parametrize("layout", ["standard", "m_high"])
def test_fused_path_at_14_local_qubits(layout):
    """n - d = 14 at complex32: the fused planner's segments on every shard
    (the bf16 instance's plain version here, matrix groups included), within
    the circuit bound of the single-device complex32 engine and of the JAX
    single-chip complex64 engine."""
    C, a, L, M, d = 33, 7, 10, 6, 2
    jc = (jsc.shor_circuit_mhigh if layout == "m_high" else jsc.shor_circuit)(C, a, L, M)
    c = interop.circuit_from_reference(jc)
    got = ShardedStateVectorEngine(Register(L, M), dtype="complex32", mesh=build_mesh(1 << d), layout=layout)
    assert got.backend == "cuda" and any(e[0] == "fused" for e in got.plan(c))
    out = got.to_numpy(got.run(c))
    single = StateVectorEngine(Register(L, M), dtype="complex32", layout=layout)
    assert np.abs(out - single.to_numpy(single.run(c))).max() < CIRCUIT_TOL
    want = JEngine(JRegister(L=L, M=M), dtype=jnp.complex64, backend="xla", layout=layout)
    assert np.abs(out - want.to_numpy(want.run(jc))).max() < CIRCUIT_TOL


def test_norm_trace_run_norm_measure_and_sample():
    C, a, L, M = 15, 7, 3, 4
    jc = jsc.shor_circuit(C, a, L, M)
    c = interop.circuit_from_reference(jc)
    want, got, _ = _engines(L, M, 2)
    _, norms = got.run_with_norms(c)
    _, jnorms = want.run_with_norms(jc)
    assert norms.dtype == torch.float32 and norms.shape == np.asarray(jnorms).shape
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=NORM_TOL)
    assert abs(got.run_norm(c) - 1.0) < NORM_TOL
    idx, collapsed = got.run_and_measure(c, 0.37)
    amps = got.to_numpy(collapsed)
    assert amps[idx] == 1.0 and np.abs(amps).sum() == 1.0
    assert (idx & ((1 << M) - 1)) in {pow(a, k, C) for k in range(4)}
    shots = got.sample(got.run(c), np.random.default_rng(9).random(64, dtype=np.float32))
    assert {int(s) & ((1 << M) - 1) for s in shots} <= {pow(a, k, C) for k in range(4)}


def test_measured_index_matches_jax():
    C, a, L, M = 15, 7, 3, 4
    jc = jsc.shor_circuit(C, a, L, M)
    want, got, _ = _engines(L, M, 2)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        r = float(jax.random.uniform(key, dtype=jnp.float32))
        assert got.run_and_measure_index(interop.circuit_from_reference(jc), r) == want.run_and_measure_index(jc, key)


def test_complex32_halves_the_exchange_bytes_of_complex64():
    """Three global butterflies: one exchange each, bf16 planes at half the
    complex64 bytes (tests/test_sharded_c32.py's contract)."""
    circ = interop.circuit_from_reference((jcir.H(5), jcir.H(4), jcir.H(3)))
    mesh = build_mesh(8)
    r64 = mesh_collective_report(ShardedStateVectorEngine(Register(4, 2), dtype=torch.complex64, mesh=mesh), circ)
    r32 = mesh_collective_report(ShardedStateVectorEngine(Register(4, 2), dtype="complex32", mesh=mesh), circ)
    assert r64["ppermute"]["count"] == r32["ppermute"]["count"] == 3
    assert 2 * r32["total_bytes"] == r64["total_bytes"] > 0
    mh = interop.circuit_from_reference(jsc.shor_circuit_mhigh(33, 29, 6, 6))
    e64 = ShardedStateVectorEngine(Register(6, 6), dtype=torch.complex64, mesh=mesh, layout="m_high")
    e32 = ShardedStateVectorEngine(Register(6, 6), dtype="complex32", mesh=mesh, layout="m_high")
    assert 2 * mesh_collective_report(e32, mh)["total_bytes"] == mesh_collective_report(e64, mh)["total_bytes"]


def test_backprop_adjoint_at_bf16():
    """The adjoint gradient survives the bf16 mesh path: bf16 gradients,
    finite, equal to the dagger circuit run on the cotangent."""
    circ = interop.circuit_from_reference((jcir.H(5), jcir.RY(4, 0.3), jcir.H(1)))
    eng = ShardedStateVectorEngine(Register(4, 2), dtype="complex32", mesh=build_mesh(4))
    p = [x.requires_grad_() for x in eng.initial_state()]
    w = torch.arange(1 << 6, dtype=torch.float32).repeat(2, 1)
    out = eng.run(circ, p)
    torch.sum(torch.cat([x.float() for x in out], dim=1) * w).backward()
    grads = [x.grad for x in p]
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g.float()).all()) for g in grads)
    want = eng.run(dagger_circuit(circ, 2), eng.from_planar(w.to(torch.bfloat16)))
    assert all(torch.equal(g, x) for g, x in zip(grads, want))
