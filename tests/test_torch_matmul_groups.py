"""The fused segment's matrix groups (lanemat / rowmat / xtable) in the port
against the JAX package, on the CPU.

The port keeps its own copy of the JAX grouping (ops/fused.py,
matmul_group_ops): on the same op lists it must give the same op tuples and
equal tables.  Grouped segments run through the port's plain version (the
CUDA kernel's spec) and through the JAX kernel in interpret mode, as
tests/test_pallas_fused.py runs it: float32 within the JAX suite's 3e-5;
bf16 within one bf16 ulp (kernel_checks.bf16_within) of the JAX kernel's bf16
instance, whose matrix products round their activations to bf16 and take
the table as bf16 hi + lo, as the port's plain version does.  Whole circuits
go through the port's planned path on the CPU against the JAX engine in the
same layout: complex64 within 1e-4, complex32 within the JAX suite's bounds
(tests/test_complex32.py: 2e-3 max abs, norm within 5e-3).  The row-gather
oracle's bf16 plain version equals the JAX kernel at bf16 exactly.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.models import circuit as jcir
from quantumcomputer_tpu.models.shor_circuit import shor_circuit as jshor_circuit
from quantumcomputer_tpu.models.shor_circuit import shor_circuit_mhigh as jshor_circuit_mhigh
from quantumcomputer_tpu.ops import pallas_fused as pf
from quantumcomputer_tpu.ops import pallas_oracle as po
from quantumcomputer_tpu.sim import engine as jengine
from quantumcomputer_tpu_torch import interop
from quantumcomputer_tpu_torch.models import circuit as cir
from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
from quantumcomputer_tpu_torch.ops import fused, oracle
from quantumcomputer_tpu_torch.sim import engine
from quantumcomputer_tpu_torch.sim import statevec as sv
from quantumcomputer_tpu_torch.utils.kernel_checks import bf16_within, segment_products

ATOL32 = 3e-5  # tests/test_pallas_fused.py
CIRCUIT64_TOL = 1e-4
CIRCUIT32_TOL = 2e-3  # tests/test_complex32.py:35
NORM32_TOL = 5e-3  # tests/test_complex32.py:36


def _unitary(rng, k):
    z = rng.standard_normal((k, k)) + 1j * rng.standard_normal((k, k))
    q, r = np.linalg.qr(z)
    return q * (np.diagonal(r) / np.abs(np.diagonal(r)))


def _random_gates(rng, n, count, high=None):
    """Seeded JAX gates of every fused op kind, targets below `high` (n)."""
    high = n if high is None else high
    gates = []
    for _ in range(count):
        q, p = (int(v) for v in rng.choice(high, 2, replace=False))
        gates.append((
            lambda: jcir.H(q), lambda: jcir.U1Q(q, _unitary(rng, 2)), lambda: jcir.RZ(q, float(rng.uniform(0, 6.3))),
            lambda: jcir.IQFT_STAGE(q), lambda: jcir.CPHASE(q, p, float(rng.uniform(0, 6.3))),
            lambda: jcir.U2Q(max(p, q), min(p, q), _unitary(rng, 4)), lambda: jcir.CNOT(q, p),
        )[int(rng.integers(7))]())
    return tuple(gates)


def _grouping_cases():
    cases = []
    for name, segs, M in (
        ("m_high flagship, JAX plan", pf.plan_circuit(jshor_circuit_mhigh(8191, 3, 15, 13), 28, 0), 0),
        ("full iQFT low M", pf.plan_circuit(tuple(jcir.IQFT_STAGE(l) for l in range(15, 2, -1)), 16, 3), 3),
        ("full iQFT M = 8", pf.plan_circuit(tuple(jcir.IQFT_STAGE(l) for l in range(15, 7, -1)), 16, 8), 8),
    ):
        cases += [(f"{name} {i}", seg[1], M) for i, seg in enumerate(segs) if seg[0] == "fused"]
    port = engine.plan_circuit(shor_circuit_mhigh(8191, 3, 15, 13), 0, 28, torch.bfloat16, "cpu")
    cases += [(f"m_high flagship, port plan {i}", seg[1], 0) for i, seg in enumerate(port) if seg[0] == "fused"]
    interleaved = (jcir.IQFT_STAGE(10), jcir.RY(10, 0.7), jcir.IQFT_STAGE(9), jcir.H(3))
    rng = np.random.default_rng(97)
    u2q_mix = (
        jcir.H(14), jcir.RY(13, 0.3), jcir.CNOT(5, 2), jcir.SWAP(11, 8), jcir.U2Q(14, 10, _unitary(rng, 4)),
        jcir.H(3), jcir.RZ(9, 0.4),
    )
    lane_pair = (jcir.RY(2, 0.3), jcir.CNOT(5, 1), jcir.RX(6, 0.7))
    for name, gates, M in (("row stage interleaved dense", interleaved, 0), ("u2q mix", u2q_mix, 0),
                           ("u2q lane pair", lane_pair, 0)):
        cases.append((name, tuple(pf.gate_to_op(g, M) for g in gates), M))
    for seed in range(6):
        rng = np.random.default_rng(seed)
        M = (0, 3, 7, 9)[seed % 4]
        ops = pf.compose_ops(tuple(pf.gate_to_op(g, M) for g in _random_gates(rng, 16, 24, high=14)))
        cases.append((f"random {seed} M={M}", ops, M))
    return cases


GROUPING = _grouping_cases()


@pytest.mark.parametrize("case", GROUPING, ids=[c[0] for c in GROUPING])
def test_grouping_matches_jax(case):
    _, ops, M = case
    got, got_mats = fused.matmul_group_ops(ops, M)
    want, want_mats = pf.matmul_group_ops(ops, M)
    assert got == want
    assert len(got_mats) == len(want_mats)
    for a, b in zip(got_mats, want_mats):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert fused.group_ops(tuple(ops), M)[0] == want  # the cached form the wrapper applies


def test_the_m_high_flagship_plan_groups():
    """At n = 28 the grouping planner (bf16 planes) keeps four passes: bits
    0-12 of the H layer in one 13-bit tile (rowmat + lanemat), H(13), H(14),
    the iQFT's stages 14 and 13, then stages 12-0 (rowmat + xtable +
    lanemat)."""
    plan = engine.plan_circuit(shor_circuit_mhigh(8191, 3, 15, 13), 0, 28, torch.bfloat16, "cpu")
    fused_segs = [s for s in plan if s[0] == "fused"]
    kinds = [[op[0] for op in fused.segment_ops(s[1], 0, torch.bfloat16, 28)[0]] for s in fused_segs]
    assert kinds == [["rowmat", "lanemat"], ["u1q", "u1q"], ["iqft", "iqft"], ["rowmat", "xtable", "lanemat"]]
    for _, ops, axes in fused_segs:
        gops, tables = fused.segment_ops(ops, 0, torch.bfloat16, 28)
        t, high, vb, ne, *_ = fused.host_descriptor(gops, axes, 28, 0, torch.bfloat16, tables)
        if any(op[0] in fused.MATRIX_KINDS for op in gops):
            assert (t, high, vb, ne) == (13, (), 2, 4)
        else:  # the butterfly segments: the bf16 instance's 2^5 amplitudes a thread
            assert (vb, ne) == (2, 5)
    # float64 never groups: its segments stay in the butterfly form, 11-bit tiles.
    plan64 = engine.plan_circuit(shor_circuit_mhigh(8191, 3, 15, 13), 0, 28, torch.float64, "cpu")
    for _, ops, axes in (s for s in plan64 if s[0] == "fused"):
        assert fused.segment_ops(ops, 0, torch.float64, 28) == (ops, ())
        t, high = fused.tile_geometry(28, axes, fused.segment_tile_bits(ops, 0, fused.TILE_BITS[torch.float64], axes))
        assert t + len(high) == 11


@pytest.mark.parametrize(
    "name,gates,M,want",
    [
        # a rowmat beside an axis >= 13: cut before H(13)
        ("rows then axis", (cir.H(7), cir.H(8), cir.H(13)), 0, [[7, 8], [13]]),
        # one row op beside an axis does not group: one run
        ("one row op", (cir.H(7), cir.H(13), cir.H(2)), 0, [[7, 13, 2]]),
        # bits 0-12 fit the 13-bit tile whole: one run of 13
        ("bits 0-12", tuple(cir.H(q) for q in range(13)), 0, [list(range(13))]),
        # a lanemat beside a camodc op: cut
        ("lanemat beside camodc", (cir.H(1), cir.H(2), cir.CAMODC(15, 7, 13)), 4, [[1, 2], [13]]),
    ],
)
def test_planner_cuts_where_a_matrix_group_needs_its_tile(name, gates, M, want):
    n = 16
    plan = fused.plan_circuit(gates, n, M, fused.TILE_BITS[torch.float32], fuse_oracle=True, group=True)
    assert [[op[1] for op in s[1]] for s in plan] == want
    for _, ops, axes in plan:  # every segment has its kernel geometry
        gops, tables = fused.group_ops(ops, M)
        fused.host_descriptor(gops, axes, n, M, torch.float32, tables)
    if name == "rows then axis":
        # without the grouping planner the segment is one run, which the
        # kernel's descriptor refuses (no 13-bit tile holds bits 0-13)
        ((_, ops, axes),) = fused.plan_circuit(gates, n, M, fused.TILE_BITS[torch.float32])
        gops, tables = fused.group_ops(ops, M)
        with pytest.raises(ValueError, match="matrix groups"):
            fused.host_descriptor(gops, axes, n, M, torch.float32, tables)


def test_many_lanemats_in_one_segment():
    """The JAX package splits a segment whose tables pass 10 MB of VMEM
    (pallas_fused.py:1040-1064).  The port's kernel streams its tables
    through a ring of 16 KB chunks in shared memory, so no table budget
    splits a segment: 81 repeats of [H(1), H(2), CZ(13, 2)] give 81 lanemats (10.1 MiB
    of tables) in one pass, held against the gates one by one in complex128."""
    n, M = 14, 0
    gates = (cir.H(1), cir.H(2), cir.CZ(13, 2)) * 81
    ((_, ops, axes),) = fused.plan_circuit(gates, n, M, fused.TILE_BITS[torch.float32], group=True)
    gops, tables = fused.group_ops(ops, M)
    assert sum(op[0] == "lanemat" for op in gops) == 81
    mtab = fused.matrix_tables(gops, tables, torch.float32)
    assert mtab.nbytes == 81 * 2 * 128 * 128 * 4 > pf.MAX_SEGMENT_TABLE_BYTES
    _, _, _, _, ops_i, *_ = fused.host_descriptor(gops, axes, n, M, torch.float32, tables)
    lanemats = ops_i[ops_i[:, 0] == 6]
    assert list(lanemats[:, 5]) == [i * 2 * 128 * 128 * 4 for i in range(81)] and all(lanemats[:, 6] == 1)
    rng = np.random.default_rng(3)
    psi = rng.standard_normal((2, 1 << n)).astype(np.float32)
    got = fused.plain_ops(torch.from_numpy(psi), gops, M, tables)
    want = fused.plain_ops(torch.from_numpy(psi).double(), ops, M)  # butterfly form, float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL32)


def _segments(n, M, seed, count=14):
    """A seeded random circuit planned by the port's grouping planner
    (float32 / bf16 segments), each with the JAX kernel's own axes."""
    rng = np.random.default_rng(seed)
    jgates = _random_gates(rng, n, count)
    plan = fused.plan_circuit(interop.circuit_from_reference(jgates), n, M, fused.TILE_BITS[torch.float32], group=True)
    out = []
    for _, ops, _axes in plan:
        jaxes = tuple(sorted({q for op in ops for q in pf._op_axis_targets(op)}, reverse=True))
        out.append((ops, jaxes))
    return out, rng


def _jax_fused(x, ops, axes, n, M, dtype):
    planes = [jnp.asarray(np.asarray(p).astype(dtype)) for p in x]
    return np.stack([np.asarray(p) for p in pf.apply_fused(*planes, tuple(ops), axes, n, M)])


SEGMENT_CASES = [(14, 0, 1), (14, 3, 2), (15, 8, 3), (14, 0, 4)]


def _products(ops, M):
    """The lanemat / rowmat products of a segment grouped as the JAX kernel
    groups it at float32 and bf16."""
    return sum(op[0] in ("lanemat", "rowmat") for op in fused.group_ops(ops, M)[0])


@pytest.mark.parametrize("n,M,seed", SEGMENT_CASES)
def test_grouped_f32_segments_match_jax(n, M, seed):
    segs, rng = _segments(n, M, seed)
    assert any(_products(ops, M) for ops, _ in segs)
    x = rng.standard_normal((2, 1 << n)).astype(np.float32)
    x /= np.sqrt(np.sum(x.astype(np.float64) ** 2))
    for ops, jaxes in segs:
        gops, tables = fused.group_ops(ops, M)  # grouped, as the JAX kernel groups at float32
        got = fused.plain_ops(torch.from_numpy(x), gops, M, tables).numpy()
        np.testing.assert_allclose(got, _jax_fused(x, ops, jaxes, n, M, np.float32), atol=ATOL32)
        x = got


@pytest.mark.parametrize("n,M,seed", SEGMENT_CASES)
def test_grouped_bf16_segments_match_jax(n, M, seed):
    """Each segment fed the same bf16 input in both packages (a pass is
    where bf16 rounds): one bf16 ulp against the JAX kernel's bf16 instance
    (kernel_checks.bf16_within: a grouped segment's activation straddles may
    move elements further, within the unit roundoff's bound on the norm and
    one ulp of the largest magnitude)."""
    segs, rng = _segments(n, M, seed)
    x = rng.standard_normal((2, 1 << n)).astype(ml_dtypes.bfloat16)
    grouped = 0
    for ops, jaxes in segs:
        got = fused.plain_segment(interop.state_from_numpy(x), ops, M)
        want = torch.from_numpy(_jax_fused(x, ops, jaxes, n, M, ml_dtypes.bfloat16).astype(np.float32))
        assert bf16_within(got, want, _products(ops, M))
        grouped += _products(ops, M)
        x = interop.state_to_numpy(got).view(ml_dtypes.bfloat16)
    assert grouped


@pytest.mark.parametrize("layout", ["m_high", "standard"])
@pytest.mark.parametrize("dtype", ["complex64", "complex32"])
def test_shor_slice_matches_the_jax_engine(layout, dtype):
    """The Shor circuit through the port's planned path on CPU planes (its
    segments grouped) against the JAX engine (pallas backend, interpret
    mode) in the same layout, at n = 14 with the counting register's H and
    iQFT stages on lane and row bits: m_high C = 33, a = 29, L = 8, M = 6
    (the row stage 7 as rowmat + xtable); standard C = 15, a = 7, L = 10,
    M = 4 (rowmats of the H layer)."""
    C, a, L, M = (33, 29, 8, 6) if layout == "m_high" else (15, 7, 10, 4)
    n = L + M
    planes = torch.bfloat16 if dtype == "complex32" else torch.float32
    jdtype = "complex32" if dtype == "complex32" else jnp.complex64
    jbuild, build = (jshor_circuit_mhigh, shor_circuit_mhigh) if layout == "m_high" else (jshor_circuit, shor_circuit)
    reg = jengine.Register(L=L, M=M)
    want = jengine.StateVectorEngine(reg, dtype=jdtype, backend="pallas", layout=layout).run(jbuild(C, a, L, M))
    want = np.asarray(want).astype(np.float32) if dtype == "complex32" else np.asarray(want)
    want = want[0] + 1j * want[1] if want.ndim == 2 else want
    m_eff = 0 if layout == "m_high" else M
    circuit = build(C, a, L, M)
    plan = engine.plan_circuit(circuit, m_eff, n, planes, "cpu")
    # the plan groups where the plane dtype groups (fused.GROUP_DTYPES)
    assert any(segment_products(s[1], m_eff, planes, n) for s in plan if s[0] == "fused") == (planes in fused.GROUP_DTYPES)
    state = sv.initial_planar(n, planes, (1 << L) if layout == "m_high" else 1)
    got = engine.apply_circuit_fused_(state, circuit, m_eff, plan).float().numpy().astype(np.float64)
    amps = got[0] + 1j * got[1]
    if dtype == "complex64":
        assert np.abs(amps - want).max() < CIRCUIT64_TOL
    else:
        assert np.abs(amps - want).max() < CIRCUIT32_TOL
        assert abs(np.vdot(amps, amps).real - 1.0) < NORM32_TOL


@pytest.mark.parametrize("n,c_phys", [(17, 0), (17, 3), (21, 14)])
def test_row_gather_bf16_plain_equals_the_pallas_kernel(n, c_phys):
    """The row-gather oracle only moves data: its plain version on bf16
    planes equals the JAX kernel's bf16 instance bit for bit."""
    C, A, M = 33, 29, 6
    x = np.random.default_rng(n + c_phys).standard_normal((2, 1 << n)).astype(ml_dtypes.bfloat16)
    ore, oim = po.apply_camodc_high_planar(jnp.asarray(x[0]), jnp.asarray(x[1]), C, A, c_phys, M)
    want = np.stack([np.asarray(ore), np.asarray(oim)]).view(np.uint16)
    state = interop.state_from_numpy(x)
    got = oracle.apply_camodc_high_planar(state, torch.empty_like(state), C, A, c_phys, M)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(interop.state_to_numpy(got), want)
