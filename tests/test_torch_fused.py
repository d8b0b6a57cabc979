"""The port's fused-segment module (quantumcomputer_tpu_torch/ops/fused.py)
against the JAX package's pallas_fused, on the same seeded inputs.

The JAX kernel runs in interpret mode on the CPU, as tests/test_pallas_fused.py
runs it; the port runs its plain segment (the CUDA kernel's spec).  f32 is
held to the JAX suite's ATOL; f64 to 1e-12 against the JAX package's x64 XLA
gate ops.  The CUDA kernel itself is tested only where a card is present."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.models import circuit as jcir
from quantumcomputer_tpu.ops import pallas_fused as pf
from quantumcomputer_tpu.sim import engine as jengine
from quantumcomputer_tpu.sim import reference as ref
from quantumcomputer_tpu_torch import interop
from quantumcomputer_tpu_torch.models import circuit as cir
from quantumcomputer_tpu_torch.ops import _build, fused

ATOL32 = 3e-5  # tests/test_pallas_fused.py ATOL
ATOL64 = 1e-12


def _unitary(rng, k):
    z = rng.standard_normal((k, k)) + 1j * rng.standard_normal((k, k))
    q, r = np.linalg.qr(z)
    return q * (np.diagonal(r) / np.abs(np.diagonal(r)))


def _planes(rng, n):
    psi = rng.standard_normal((2, 1 << n))
    return psi / np.sqrt(np.sum(psi * psi))


# (case id, n, M, JAX gate builder): one op kind per case, the target on the
# low (lane), middle (row) or exposed-axis bit class of the JAX kernel.
CASES = [
    ("u1q_low", 14, 0, lambda r: jcir.U1Q(3, _unitary(r, 2))),
    ("u1q_mid", 14, 0, lambda r: jcir.U1Q(9, _unitary(r, 2))),
    ("u1q_high", 15, 0, lambda r: jcir.U1Q(14, _unitary(r, 2))),
    ("diag1", 14, 0, lambda r: jcir.RZ(11, 0.7)),
    ("diag2", 14, 0, lambda r: jcir.CPHASE(13, 2, 0.9)),
    ("iqft_M0", 14, 0, lambda r: jcir.IQFT_STAGE(13)),
    ("iqft_M4", 16, 4, lambda r: jcir.IQFT_STAGE(15)),
    ("iqft_row", 14, 4, lambda r: jcir.IQFT_STAGE(10)),
    ("u2q_axis_low", 14, 0, lambda r: jcir.U2Q(13, 5, _unitary(r, 4))),
    ("u2q_low_low", 14, 0, lambda r: jcir.U2Q(6, 2, _unitary(r, 4))),
    ("u2q_axis_axis", 16, 0, lambda r: jcir.U2Q(15, 13, _unitary(r, 4))),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_one_op_segment_f32_matches_pallas(case):
    _, n, M, build = case
    rng = np.random.default_rng(7)
    jgate = build(rng)
    (gate,) = interop.circuit_from_reference((jgate,))
    jop = pf.gate_to_op(jgate, M)
    op = fused.gate_to_op(gate)
    assert op == jop  # the op descriptors are ported as they are
    planes = _planes(rng, n).astype(np.float32)
    axes = tuple(q for q in pf._op_axis_targets(jop))
    jre, jim = pf.apply_fused(jnp.asarray(planes[0]), jnp.asarray(planes[1]), (jop,), axes, n, M)
    got = fused.plain_segment(interop.state_from_numpy(planes), (op,), M)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(interop.state_to_numpy(got), np.stack([jre, jim]), atol=ATOL32)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_one_op_segment_f64_matches_xla(case):
    _, n, M, build = case
    rng = np.random.default_rng(8)
    jgate = build(rng)
    (gate,) = interop.circuit_from_reference((jgate,))
    planes = _planes(rng, n)
    want = jengine.apply_gate(jnp.asarray(planes[0] + 1j * planes[1]), jgate, M, backend="xla")
    got = fused.plain_segment(interop.state_from_numpy(planes), (fused.gate_to_op(gate),), M)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(interop.state_to_numpy(got), np.stack([want.real, want.imag]), atol=ATOL64)


def _random_circuit(rng, n, count):
    gates = []
    for _ in range(count):
        kind = rng.integers(6)
        q = int(rng.integers(n))
        p = int(rng.integers(n - 1))
        p = p + (p >= q)
        if kind == 0:
            gates.append(cir.H(q))
        elif kind == 1:
            gates.append(cir.U1Q(q, _unitary(rng, 2)))
        elif kind == 2:
            gates.append(cir.RZ(q, float(rng.uniform(0, 2 * math.pi))))
        elif kind == 3:
            gates.append(cir.CPHASE(q, p, float(rng.uniform(0, 2 * math.pi))))
        elif kind == 4:
            gates.append(cir.U2Q(max(p, q), min(p, q), _unitary(rng, 4)))
        else:
            gates.append(cir.IQFT_STAGE(q))
    return tuple(gates)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [9, 16, 21])
def test_plan_respects_tile_budget(dtype, n):
    tile_bits = fused.TILE_BITS[dtype]
    circuit = _random_circuit(np.random.default_rng(n), n, 60)
    plan = fused.plan_circuit(circuit, n, 3, tile_bits)
    assert all(seg[0] == "fused" for seg in plan)
    assert sum(len(seg[1]) for seg in plan) <= len(circuit)
    for _, ops, axes in plan:
        t, high = fused.tile_geometry(n, axes, tile_bits)
        assert t + len(high) <= tile_bits
        assert 2 * (1 << (t + len(high))) * torch.empty((), dtype=dtype).element_size() <= 32 << 10
        for op in ops:
            for q in fused._op_targets(op):
                assert q < t or q in high, (op, t, high)


def _reference_apply(psi, g, M):
    """One gate through the JAX package's numpy oracle (sim/reference.py)."""
    if g.name == "iqft_stage":
        l = g.qubits[0]
        psi = ref.apply_hadamard(psi, l)
        for k in range(l - 1, M - 1, -1):
            psi = ref.apply_c_phase(psi, l, k, math.pi / (1 << (l - k)))
        return psi
    if len(g.qubits) == 1:
        return ref.apply_1q(psi, jcir.gate_matrix_1q(g), g.qubits[0])
    q_hi, q_lo = sorted(g.qubits, reverse=True)
    m4 = jcir.gate_matrix_2q(jcir.Gate(g.name, (q_hi, q_lo), g.params, g.meta, g.matrix))
    return ref.apply_2q(psi, m4, q_hi, q_lo)


def test_plan_matches_gate_by_gate():
    """Composing and segmenting changes nothing: the plan through
    plain_segment equals the circuit gate by gate through the JAX package's
    float64 numpy oracle."""
    n, M = 15, 3
    rng = np.random.default_rng(3)
    circuit = _random_circuit(rng, n, 40) + (cir.CNOT(14, 1), cir.SWAP(2, 13))
    planes = _planes(rng, n)
    state = interop.state_from_numpy(planes)
    for _, ops, _axes in fused.plan_circuit(circuit, n, M, fused.TILE_BITS[torch.float64]):
        state = fused.plain_segment(state, ops, M)
    psi = planes[0] + 1j * planes[1]
    for g in circuit:
        psi = _reference_apply(psi, g, M)
    np.testing.assert_allclose(interop.state_to_numpy(state), np.stack([psi.real, psi.imag]), atol=ATOL64)


def test_non_fusable_gate_breaks_the_run():
    circuit = (cir.H(10), cir.CAMODC(15, 7, 5), cir.H(11), cir.MCZ(1, 2, 3), cir.H(0))
    kinds = [seg[0] for seg in fused.plan_circuit(circuit, 12, 4)]
    assert kinds == ["fused", "single", "fused", "single", "fused"]


def test_compose_ops_matches_jax():
    rng = np.random.default_rng(11)
    n = 16
    for _ in range(5):
        ops = tuple(fused.gate_to_op(g) for g in _random_circuit(rng, n, 30))
        assert fused.compose_ops(ops) == pf.compose_ops(ops)


def test_wrapper_takes_plain_version_only_on_cpu():
    rng = np.random.default_rng(5)
    planes = _planes(rng, 10).astype(np.float32)
    ops = (fused.gate_to_op(cir.H(9)),)
    before = fused.LAUNCHES
    state = interop.state_from_numpy(planes)
    out = fused.apply_fused(state, ops, (), 0)
    assert out is state  # updated in place
    assert fused.LAUNCHES == before  # no kernel launched for a CPU tensor
    np.testing.assert_array_equal(
        interop.state_to_numpy(out), interop.state_to_numpy(fused.plain_segment(interop.state_from_numpy(planes), ops, 0))
    )
    with pytest.raises(ValueError, match="no fused-segment path"):
        fused.apply_fused(torch.empty((2, 1 << 10), device="meta"), ops, (), 0)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused-segment kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    n, M = 18, 4
    rng = np.random.default_rng(9)
    circuit = _random_circuit(rng, n, 40)
    planar = interop.state_from_numpy(_planes(rng, n), cuda_device).to(dtype)
    want = planar.clone()
    before = fused.LAUNCHES
    plan = fused.plan_circuit(circuit, n, M, fused.TILE_BITS[dtype])
    for _, ops, axes in plan:
        want = fused.plain_segment(want, ops, M)
        fused.apply_fused(planar, ops, axes, M)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + len(plan)
    tol = ATOL32 if dtype == torch.float32 else ATOL64
    assert float((planar - want).abs().max()) <= tol
