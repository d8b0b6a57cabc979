"""The port's complex32 mode (bf16 planes, f32 compute) against the JAX
package's, on the CPU.

The same seeded numpy inputs, rounded once to bf16, go through the JAX
package (its Pallas kernels in interpret mode, as tests/test_complex32.py
runs them) and through the port's CPU path (the plain versions of the
kernels, on bf16 CPU planes).  Tolerances:

* fused segments without matrix groups: within one bf16 ulp
  (kernel_checks.bf16_ulps, the ulp taken at 2^-8 and above) of the JAX
  kernel run at float32 and rounded once to bf16 (both compute in float32
  and round once, so they differ only where the two float32 results
  straddle a bf16 boundary);
* segments with matrix groups (lanemat / rowmat / xtable): within one bf16
  ulp of the JAX kernel's bf16 instance, whose matrix products round their
  activations to bf16 against a hi + lo table as the port's plain version
  does (kernel_checks.bf16_within: an activation that straddles a bf16
  boundary may move elements further, within one ulp of the largest
  magnitude and the rounding model's bound on the norm);
* data movement (the camodc op, the m_high oracles): exact;
* block sums: 1e-6 (float32 accumulation in both);
* whole circuits: the JAX suite's complex32 bounds (tests/test_complex32.py):
  2e-3 max abs for the m_high, standard and benes Shor circuits with the
  norm within 5e-3 of 1, 5e-3 for the generic n = 14 mix.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quantumcomputer_tpu import cli as jcli
from quantumcomputer_tpu.algorithms import shor as jshor
from quantumcomputer_tpu.models import circuit as jcir
from quantumcomputer_tpu.models.shor_circuit import shor_circuit as jshor_circuit
from quantumcomputer_tpu.models.shor_circuit import shor_circuit_mhigh as jshor_circuit_mhigh
from quantumcomputer_tpu.ops import pallas_fused as pf
from quantumcomputer_tpu.ops import pallas_measure as pm
from quantumcomputer_tpu.ops import pallas_oracle as po
from quantumcomputer_tpu.sim import engine as jengine
from quantumcomputer_tpu.sim import statevec as jsv
from quantumcomputer_tpu_torch import cli, interop
from quantumcomputer_tpu_torch.algorithms import shor
from quantumcomputer_tpu_torch.models import circuit as cir
from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
from quantumcomputer_tpu_torch.ops import fused, measure, oracle
from quantumcomputer_tpu_torch.sim import engine
from quantumcomputer_tpu_torch.sim import statevec as sv
from quantumcomputer_tpu_torch.utils import memory
from quantumcomputer_tpu_torch.utils.kernel_checks import BF16_ULP_TOL, bf16_ulps, bf16_within, segment_products

CIRCUIT_TOL = 2e-3  # tests/test_complex32.py:35
NORM_TOL = 5e-3  # tests/test_complex32.py:36
GENERIC_TOL = 5e-3  # tests/test_complex32.py:57


def _bf16(rng, shape) -> np.ndarray:
    """Seeded unit-variance values rounded once to bf16 (an ml_dtypes array)."""
    return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)


def _unitary(rng, k):
    z = rng.standard_normal((k, k)) + 1j * rng.standard_normal((k, k))
    q, r = np.linalg.qr(z)
    return q * (np.diagonal(r) / np.abs(np.diagonal(r)))


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32))


def _segment_ok(got: torch.Tensor, x, ops, axes, n, M) -> bool:
    """A bf16 segment against the JAX kernel: its bf16 instance when the
    segment runs matrix groups, else its float32 kernel rounded once."""
    products = segment_products(ops, M, torch.bfloat16, n)
    if products:
        return bf16_within(got, _f32(_jax_fused(x, ops, axes, n, M, ml_dtypes.bfloat16)), products)
    sharp = _f32(_jax_fused(x, ops, axes, n, M, np.float32).astype(ml_dtypes.bfloat16))
    return bf16_ulps(got, sharp)[0] <= BF16_ULP_TOL


def _amps(planar) -> np.ndarray:
    """Complex128 amplitudes of a JAX or port state, bf16 widened exactly."""
    a = planar.float().numpy() if isinstance(planar, torch.Tensor) else np.asarray(planar).astype(np.float32)
    return a[0].astype(np.float64) + 1j * a[1].astype(np.float64)


# ---------------------------------------------------------------------------
# Planar states and interop.


def test_bf16_bits_round_trip_against_jax():
    x = _bf16(np.random.default_rng(1), (2, 1 << 10))
    jx = jnp.asarray(x)
    assert jx.dtype == jnp.bfloat16
    bits = np.asarray(jx).view(np.uint16)
    t = interop.state_from_numpy(bits)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(jx.astype(jnp.float32)))
    np.testing.assert_array_equal(interop.state_to_numpy(t), bits)  # exact both ways
    assert torch.equal(interop.state_from_numpy(np.asarray(jx)), t)  # an ml_dtypes array crosses as its bits


def test_complex32_token_and_f32_reductions():
    assert sv.real_dtype_of("complex32") == sv.real_dtype_of("c32") == torch.bfloat16
    assert sv.compute_dtype(torch.bfloat16) == torch.float32
    x = _bf16(np.random.default_rng(2), (2, 1 << 12))
    t = interop.state_from_numpy(x)
    probs, norm = sv.probabilities(t), sv.norm(t)
    assert probs.dtype == norm.dtype == torch.float32
    np.testing.assert_array_equal(probs.numpy(), np.asarray(jsv.probabilities(jnp.asarray(x))))
    assert abs(float(norm) - float(jsv.norm(jnp.asarray(x)))) <= 1e-6 * float(norm)
    z = sv.to_numpy_complex(t)
    assert z.dtype == np.complex64
    np.testing.assert_array_equal(z, jsv.to_numpy_complex(jnp.asarray(x)))


# ---------------------------------------------------------------------------
# The fused segment at bf16: one op of each kind, the camodc op, and
# multi-op segments.

OP_CASES = [
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
]


def _jax_fused(x: np.ndarray, jops, axes, n, M, dtype) -> np.ndarray:
    planes = [jnp.asarray(np.asarray(p).astype(dtype)) for p in x]
    return np.stack([np.asarray(p) for p in pf.apply_fused(*planes, tuple(jops), axes, n, M)])


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_one_op_segment_bf16_matches_jax(case):
    _, n, M, build = case
    rng = np.random.default_rng(17)
    jgate = build(rng)
    (gate,) = interop.circuit_from_reference((jgate,))
    op, jop = fused.gate_to_op(gate), pf.gate_to_op(jgate, M)
    assert op == jop
    axes = tuple(pf._op_axis_targets(jop))
    x = _bf16(rng, (2, 1 << n))
    got = fused.plain_segment(interop.state_from_numpy(x), (op,), M)
    assert got.dtype == torch.bfloat16
    assert _segment_ok(got, x, (jop,), axes, n, M)


def _random_ops(rng, n, count):
    gates = []
    for _ in range(count):
        q, p = (int(v) for v in rng.choice(n, 2, replace=False))
        gates.append((
            lambda: jcir.H(q), lambda: jcir.U1Q(q, _unitary(rng, 2)), lambda: jcir.RZ(q, float(rng.uniform(0, 6.3))),
            lambda: jcir.IQFT_STAGE(q), lambda: jcir.CPHASE(q, p, float(rng.uniform(0, 6.3))),
        )[int(rng.integers(5))]())
    return tuple(gates)


@pytest.mark.parametrize("n,M,seed", [(14, 0, 0), (15, 4, 1), (16, 0, 2)])
def test_multi_op_segments_bf16_match_jax(n, M, seed):
    """Each segment of a random plan, fed the same bf16 input in both
    packages (a pass is where bf16 rounds): one ulp against the float32 JAX
    kernel rounded once, or, where the segment runs matrix groups, against
    the JAX kernel's bf16 instance."""
    rng = np.random.default_rng(seed)
    jplan = pf.plan_circuit(_random_ops(rng, n, 12), n, M)  # the JAX kernel takes its own planner's axes
    assert all(s[0] == "fused" for s in jplan)
    x = _bf16(rng, (2, 1 << n))
    for _, jops, axes in jplan:
        got = fused.plain_segment(interop.state_from_numpy(x), jops, M)
        assert _segment_ok(got, x, jops, axes, n, M)
        x = interop.state_to_numpy(got).view(ml_dtypes.bfloat16)


@pytest.mark.parametrize(
    "M,C,gates",
    [(4, 15, ((15, 7, 13),)), (4, 15, ((15, 7, 13), (15, 13, 12))), (6, 33, ((33, 29, 12), (33, 7, 13)))],
)
def test_camodc_segment_bf16_is_exact_against_jax(M, C, gates):
    """The camodc op only moves data: equal bit for bit to the JAX
    kernel's bf16 instance (its Benes masks f32) and to its float32 one."""
    n = 14
    jgates = tuple(jcir.CAMODC(C0, A, c) for C0, A, c in gates)
    circuit = interop.circuit_from_reference(jgates)
    ((_, ops, axes),) = fused.plan_circuit(circuit, n, M, fused.TILE_BITS[torch.bfloat16], fuse_oracle=True)
    jops = tuple(pf.gate_to_op(g, M, fuse_oracle=True) for g in jgates)
    assert ops == jops
    x = _bf16(np.random.default_rng(M + len(gates)), (2, 1 << n))
    got = interop.state_to_numpy(fused.plain_segment(interop.state_from_numpy(x), ops, M))
    np.testing.assert_array_equal(got, _jax_fused(x, jops, axes, n, M, ml_dtypes.bfloat16).view(np.uint16))
    np.testing.assert_array_equal(got, _jax_fused(x, jops, axes, n, M, np.float32).astype(ml_dtypes.bfloat16).view(np.uint16))


def test_descriptor_tables_of_a_bf16_segment_are_float32():
    """The kernel's bf16 instance reads its coefficient records and phase
    tables in float32, the compute dtype: the same arrays as a float32
    segment's.  Its register groups hold 2^5 amplitudes a thread (the
    float32 instance's 2^4), so the groups, the slot fields of the int
    records and an iQFT op's slot factors (two a slot) are those of that
    form; its camodc segments keep the float32 form."""
    n, M = 20, 4
    circuit = (cir.H(19), cir.IQFT_STAGE(18), cir.CPHASE(17, 2, 0.3), cir.U2Q(16, 1, np.eye(4)))
    ((_, ops, axes),) = fused.plan_circuit(circuit, n, M, fused.TILE_BITS[torch.bfloat16])
    got = fused.host_descriptor(ops, axes, n, M, torch.bfloat16)
    want = fused.host_descriptor(ops, axes, n, M, torch.float32)
    assert got[:4] == want[:3] + (5,) and want[3] == 4  # t, high, vb, ne
    for a, b in zip(got[4:], want[4:]):
        assert a.dtype == b.dtype
    ops_i, ops_f, grp, ftab = got[4:]
    np.testing.assert_array_equal(ops_i[:, :3], want[4][:, :3])  # kinds and qubits
    np.testing.assert_array_equal(ops_i[:, 5:], want[4][:, 5:])  # the iQFT op's table offsets
    np.testing.assert_array_equal(ftab, want[7])
    iqft = ops_i[:, 0] == 3
    np.testing.assert_array_equal(ops_f[~iqft], want[5][~iqft])
    assert got[5].dtype == np.float32 and got[7].dtype == np.float32
    # The iQFT op's slot factors: those of its own slots, in the float32 compute dtype.
    (k,) = np.flatnonzero(iqft)
    slots = [0, 1] + [int(p) for p in grp[next(i for i, g in enumerate(grp) if g[0] <= k < g[1]), 2:5]]
    t, high = got[0], got[1]
    glob = [p if p < t else high[p - t] for p in slots]
    w = fused.iqft_phases([1 << q for q in glob], 18, M)
    np.testing.assert_array_equal(ops_f[k, :10], np.stack([w.real, w.imag], 1).reshape(-1).astype(np.float32))
    camodc = ((_, cops, caxes),) = fused.plan_circuit((cir.CAMODC(15, 7, 9), cir.H(5)), 12, M,
                                                       fused.TILE_BITS[torch.bfloat16], fuse_oracle=True)
    assert camodc and fused.host_descriptor(cops, caxes, 12, M, torch.bfloat16)[2:4] == (2, 4)


def test_fused_wrapper_takes_bf16_on_the_cpu():
    x = interop.state_from_numpy(_bf16(np.random.default_rng(4), (2, 1 << 10)))
    ops = (fused.gate_to_op(cir.H(9)),)
    before = fused.LAUNCHES
    out = fused.apply_fused(x, ops, (), 0)
    assert out is x and out.dtype == torch.bfloat16 and fused.LAUNCHES == before
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        fused.apply_fused(x.to(torch.float16), ops, (), 0)


# ---------------------------------------------------------------------------
# Block sums and the sampler.


def test_block_sums_bf16_match_jax():
    x = _bf16(np.random.default_rng(5), (2, 1 << 17))
    got = measure.block_sums(interop.state_from_numpy(x))
    want = np.asarray(pm.block_prob_sums_planes(jnp.asarray(x[0]), jnp.asarray(x[1])))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * float(want.max()))


def test_sampled_index_bf16_matches_jax_on_shared_draws():
    """Hierarchical f32 sampling of a bf16 state (2^17 amplitudes); draws
    closer than 1e-5 to a CDF boundary (in units of the total) are skipped."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 1 << 17)) * np.exp(-np.arange(1 << 17) / 2.0 ** 14)).astype(ml_dtypes.bfloat16)
    t = interop.state_from_numpy(x)
    cum = np.cumsum(np.asarray(jsv.probabilities(jnp.asarray(x)), np.float64))
    draws = rng.random(64).astype(np.float32)
    gap = np.abs(cum[None, :] / cum[-1] - draws[:, None].astype(np.float64)).min(axis=1)
    draws = draws[gap > 1e-5]
    assert len(draws) > 40
    want = np.asarray(pm.sample_indices(jnp.asarray(x), jnp.asarray(draws)))
    got = [measure.sample_index(t, float(r)) for r in draws]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The m_high oracles at bf16, and the planner at itemsize 2.


def _jax_planes(x):
    return jnp.asarray(x[0]), jnp.asarray(x[1])


@pytest.mark.parametrize(
    "site,n,M,C,A,controls",
    [
        ("cycle", 14, 6, 33, (29,), (3,)),
        ("perm", 21, 6, 33, (29,), (14,)),
        ("ladder", 18, 4, 15, (7, 4), (12, 13)),
    ],
)
def test_mhigh_oracles_bf16_are_exact_against_jax(site, n, M, C, A, controls):
    x = _bf16(np.random.default_rng(n + controls[0]), (2, 1 << n))
    state = interop.state_from_numpy(x)
    if site == "cycle":
        want = po.apply_camodc_high_cycle_planar(*_jax_planes(x), C, A[0], controls[0], M)
        got = oracle.apply_camodc_high_cycle_planar(state, C, A[0], controls[0], M)
    elif site == "perm":
        assert oracle.perm_supported(controls[0], M, n, 2)
        want = po.apply_camodc_high_perm_planar(*_jax_planes(x), C, A[0], controls[0], M)
        got = oracle.apply_camodc_high_perm_planar(state, C, A[0], controls[0], M)
    else:
        assert oracle.ladder_high_supported(controls, M, n, 2)
        want = po.apply_camodc_ladder_high_planar(*_jax_planes(x), C, A, controls, M)
        got = oracle.apply_camodc_ladder_high_planar(state, torch.empty_like(state), C, A, controls, M)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(interop.state_to_numpy(got), np.stack([np.asarray(w) for w in want]).view(np.uint16))


def test_pair_bf16_is_exact_against_the_plain_ladder():
    C, A_pair, controls, M, n = 33, (29, 7), (14, 15), 6, 22
    assert oracle.pair_inplace_supported(controls, M, n, 2)
    x = interop.state_from_numpy(_bf16(np.random.default_rng(9), (2, 1 << n)))
    want = oracle.apply_camodc_ladder_high_planar(x, torch.empty_like(x), C, A_pair, controls, M)
    assert torch.equal(oracle.apply_camodc_pair_inplace_planar(x.clone(), C, A_pair, controls, M), want)


def test_bf16_predicates_take_one_more_stride_bit():
    """tests/test_complex32.py:92-102, through the port, and equal to the
    JAX predicates over a grid at itemsize 2."""
    assert oracle.perm_supported(13, 6, 20, itemsize=4)
    assert not oracle.perm_supported(13, 6, 21, itemsize=2)
    assert oracle.perm_supported(14, 6, 21, itemsize=2)
    assert oracle.ladder_high_supported((11, 12), 6, 20, itemsize=4)
    assert not oracle.ladder_high_supported((11, 12), 6, 20, itemsize=2)
    assert oracle.ladder_high_supported((12, 13), 6, 20, itemsize=2)
    for n in (18, 21, 24, 28, 31):
        for c in range(0, n - 13):
            assert oracle.perm_supported(c, 13, n, 2) == po.perm_supported(c, 13, n, 2)
            assert oracle.pair_member_supported(c, 13, n, 2) == po.pair_member_supported(c, 13, n, 2)
            assert oracle.ladder_high_supported((c,), 13, n, 2) == po.ladder_high_supported((c,), 13, n, 2)


def _jax_planned(circuit, n, itemsize, ladder_fits):
    """The JAX pallas path's m_high oracle rewrite (engine.apply_circuit_planes)."""
    if ladder_fits:
        return jengine.fuse_oracle_ladders(
            circuit, 0,
            eligible=lambda g: g.name == "camodc_high" and po.ladder_high_supported((g.qubits[0],), g.meta[2], n, itemsize),
        )
    circuit = jengine.fuse_oracle_ladders(
        circuit, 0,
        eligible=lambda g: g.name == "camodc_high" and po.pair_member_supported(g.qubits[0], g.meta[2], n, itemsize),
        max_run=2,
    )
    split = []
    for g in circuit:
        if g.name == "camodc_ladder_high" and not po.pair_inplace_supported(g.qubits, g.meta[1], n, itemsize):
            split.extend(jcir.Gate("camodc_high", (c,), meta=(g.meta[0], A, g.meta[1])) for c, A in zip(g.qubits, g.meta[2:]))
        else:
            split.append(g)
    return tuple(split)


@pytest.mark.parametrize("ladder_fits", [True, False])
@pytest.mark.parametrize("C,a,L,M", [(8191, 3, 15, 13), (8189, 2, 18, 13), (33, 7, 15, 6)])
def test_oracle_plan_bf16_matches_jax(C, a, L, M, ladder_fits):
    n = L + M
    want = _jax_planned(jshor_circuit_mhigh(C, a, L, M), n, 2, ladder_fits)
    assert engine.fuse_oracles(shor_circuit_mhigh(C, a, L, M), 0, n, 2, ladder_fits) == interop.circuit_from_reference(want)


def test_memory_model_counts_bf16_bytes(monkeypatch):
    """n = 31 at complex32 is 8 GiB a state; the two-state test counts bf16
    bytes, as the JAX engine's two_state_programs_fit(n, bf16) does."""
    state = 2 * (1 << 31) * 2
    assert state == 8 << 30
    for budget in (state, state * 5 // 4, 2 * state - 1, 2 * state):
        monkeypatch.setenv("QC_TPU_HBM_BYTES", str(budget))
        assert memory.state_fits(31, torch.bfloat16, "cpu") == (state + state // 4 <= budget)
        assert memory.two_state_programs_fit(31, torch.bfloat16, "cpu") == jengine.two_state_programs_fit(31, jnp.bfloat16)


# ---------------------------------------------------------------------------
# Whole circuits: the port's complex32 planned path (bf16 CPU planes) against
# the JAX complex32 engine (interpret-mode kernels) and its complex64 one.


def _port_c32(circuit, n, M, state, oracle_kind="gather", norms=None):
    plan = engine.plan_circuit(circuit, M, n, torch.bfloat16, "cpu", fuse_oracle=oracle_kind == "benes")
    return engine.apply_circuit_fused_(state, circuit, M, plan, norms=norms)


@pytest.mark.parametrize("layout,oracle_kind", [("m_high", "gather"), ("standard", "gather"), ("standard", "benes")])
def test_shor_circuit_c32_matches_jax(layout, oracle_kind):
    C, a, L, M = 33, 29, 8, 6
    reg = jengine.Register(L=L, M=M)
    jbuild = jshor_circuit_mhigh if layout == "m_high" else jshor_circuit
    jcirc = jbuild(C, a, L, M)
    j32 = jengine.StateVectorEngine(reg, dtype="complex32", backend="pallas", layout=layout, oracle=oracle_kind)
    j64 = jengine.StateVectorEngine(reg, dtype=jnp.complex64, backend="pallas", layout=layout)
    want32, want64 = _amps(j32.run(jcirc)), _amps(j64.run(jcirc))
    m_eff = 0 if layout == "m_high" else M
    index = (1 << L) if layout == "m_high" else 1
    circuit = (shor_circuit_mhigh if layout == "m_high" else shor_circuit)(C, a, L, M)
    norms = []
    got = _port_c32(circuit, L + M, m_eff, sv.initial_planar(L + M, torch.bfloat16, index), oracle_kind, norms)
    assert got.dtype == torch.bfloat16
    amps = _amps(got)
    assert np.abs(amps - want64).max() < CIRCUIT_TOL
    assert np.abs(amps - want32).max() < CIRCUIT_TOL
    assert abs(np.vdot(amps, amps).real - 1.0) < NORM_TOL
    assert all(n_.dtype == torch.float32 and abs(float(n_) - 1.0) < NORM_TOL for n_ in norms)


def test_generic_mix_c32_matches_jax():
    n = 14
    jcirc = tuple(jcir.RY(q, 0.1 + 0.03 * q) for q in range(n)) + (
        jcir.H(3), jcir.CNOT(13, 2), jcir.CPHASE(12, 1, 0.7), jcir.H(13),
    )
    reg = jengine.Register(L=n, M=0)
    j32 = jengine.StateVectorEngine(reg, dtype="complex32", backend="pallas")
    j64 = jengine.StateVectorEngine(reg, dtype=jnp.complex64, backend="pallas")
    want32, want64 = _amps(j32.run(jcirc, j32.zero_state())), _amps(j64.run(jcirc, j64.zero_state()))
    got = _amps(_port_c32(interop.circuit_from_reference(jcirc), n, 0, sv.zero_planar(n, torch.bfloat16)))
    assert np.abs(got - want64).max() < GENERIC_TOL
    assert np.abs(got - want32).max() < GENERIC_TOL


def test_unfused_c32_path_matches_the_fused_one():
    """fuse=False: every gate through its bf16 path (one-op segments, the
    gather oracle), within the circuit bound of the fused plan."""
    C, a, L, M = 15, 7, 4, 4
    circuit = shor_circuit(C, a, L, M)
    per_gate = engine.apply_circuit_per_gate_(sv.initial_planar(L + M, torch.bfloat16), circuit, M)
    planned = _port_c32(circuit, L + M, M, sv.initial_planar(L + M, torch.bfloat16))
    assert per_gate.dtype == torch.bfloat16
    assert np.abs(_amps(per_gate) - _amps(planned)).max() < CIRCUIT_TOL


def test_nan_checks_on_bf16_planes(capsys):
    x = sv.zero_planar(4, torch.bfloat16)
    x[1, 3] = float("nan")
    engine.check_finite(x, "gate 0 h(0,)")
    assert capsys.readouterr().out.strip() == "*** non-finite amplitudes after gate 0 h(0,)"


# ---------------------------------------------------------------------------
# The engine, the driver and the CLI.


def test_complex32_engine_needs_the_cuda_backend(monkeypatch):
    """complex32 runs on the cuda backend's planned path only (the JAX
    engine's pallas rule): backend="torch" raises, "auto" places it as
    complex64 is placed (here, with no card, on the CPU through the plain
    versions, within the circuit bound of the JAX complex32 engine run in
    interpret mode), an explicit "cuda" with no card raises, and with a
    card present "auto" puts it on the card."""
    C, a, L, M = 15, 7, 3, 4
    reg = engine.Register(L=L, M=M)
    with pytest.raises(ValueError, match="requires backend='cuda'"):
        engine.StateVectorEngine(reg, dtype="complex32", backend="torch")
    with pytest.raises(ValueError, match="no CUDA device"):
        engine.StateVectorEngine(reg, dtype="complex32", backend="cuda")
    eng = engine.StateVectorEngine(reg, dtype="complex32")
    assert (eng.backend, eng.device.type, eng.real_dtype, eng.dtype) == ("cuda", "cpu", torch.bfloat16, "complex32")
    got = eng.run(shor_circuit(C, a, L, M))
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
    j32 = jengine.StateVectorEngine(jengine.Register(L=L, M=M), dtype="complex32", backend="pallas")
    want = _amps(j32.run(jshor_circuit(C, a, L, M)))
    assert np.abs(_amps(got) - want).max() < CIRCUIT_TOL
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("QC_TPU_HBM_BYTES", str(1 << 30))  # the budget without asking the device
    eng = engine.StateVectorEngine(reg, dtype="c32")
    assert (eng.backend, eng.device.type, eng.real_dtype, eng.dtype) == ("cuda", "cuda", torch.bfloat16, "complex32")


def test_shors_algorithm_complex32_overrides_torch_and_never_runs_on_the_cpu(monkeypatch, caplog):
    """backend="torch" is overridden to the planned path with the JAX
    package's warning, as the JAX shors_algorithm overrides xla with pallas; with each
    draw fed to both packages' samplers, both measure the same index and
    find the same factors of 15."""
    import logging

    import jax

    draws = (0.1, 0.35, 0.6, 0.85)
    logger = logging.getLogger("quantumcomputer_tpu_torch")
    logger.addHandler(caplog.handler)
    got, want = [], []
    try:
        for r in draws:
            with monkeypatch.context() as m:
                m.setattr(torch, "rand", lambda *a, r=r, **k: torch.tensor(r, dtype=k.get("dtype")))
                res = shor.shors_algorithm(15, 3, 4, forced_trial_int=7, seed=0, dtype="complex32", backend="torch")
            got.append((res.outcome.name, res.factors, [t.measured_index for t in res.attempts]))
            with monkeypatch.context() as m:
                m.setattr(jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32, r=r, **k: jnp.full(shape, r, dtype))
                jres = jshor.shors_algorithm(15, 3, 4, forced_trial_int=7, seed=0, dtype="complex32", backend="xla")
            want.append((jres.outcome.name, jres.factors, [t.measured_index for t in jres.attempts]))
    finally:
        logger.removeHandler(caplog.handler)
    assert got == want
    assert all(g[:2] == ("OK", (5, 3)) for g in got)
    assert any("overriding backend='torch' -> 'auto'" in r.getMessage() for r in caplog.records)


def test_cli_complex32_full_register_needs_a_card(capsys):
    """The full register at complex32 on this card-less host: the JAX CLI's
    exit code and factors line in each layout and with the Beneš oracle;
    only an explicit --backend cuda still exits 2."""
    argv = ["-C", "15", "-L", "3", "-M", "4", "-a", "7", "--seed", "0", "--dtype", "complex32"]
    for extra in ([], ["--layout", "m_high"], ["--oracle", "benes"]):
        want_rc = jcli.main(argv + extra)
        want = [line for line in capsys.readouterr().out.splitlines() if "Factors of" in line]
        assert cli.main(argv + extra) == want_rc == 0
        assert [line for line in capsys.readouterr().out.splitlines() if "Factors of" in line] == want
        assert want == [" --- Factors of 15 found: (5, 3)."]
    assert cli.main(argv + ["--backend", "cuda"]) == 2
    assert capsys.readouterr().err.strip() == "Error: --backend cuda needs a CUDA device, and none is available."
    assert cli.validate(cli.build_parser().parse_args(["-C", "15", "-L", "3", "-M", "4", "--dtype", "complex32"])) is None


def test_cli_strict_reference_refuses_complex32(capsys):
    assert cli.main(["-C", "15", "-L", "3", "-M", "4", "--dtype", "complex32", "--strict-reference"]) == 2
    assert capsys.readouterr().err.strip() == (
        "Error: strict-reference mode is single-chip, standard layout, torch backend, complex64/128."
    )
