"""The port's fused-segment module (quantumcomputer_tpu_torch/ops/fused.py)
against the JAX package's pallas_fused, on the same seeded inputs.

The JAX kernel runs in interpret mode on the CPU, as tests/test_pallas_fused.py
runs it; the port runs its plain segment (the CUDA kernel's spec).  f32 is
held to the JAX suite's ATOL; f64 to 1e-12 against the JAX package's x64 XLA
gate ops.  The CUDA kernel is held against the plain segment on the card by
chip_smoke.py and quantumcomputer_tpu_torch/utils/kernel_checks.py."""

import math

import jax.numpy as jnp
import mpmath
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
from tests.torch_matmul_spec import tf32_parts, unpack_product, unpack_xtable

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


# ---------------------------------------------------------------------------
# The kernel's split iQFT angle and register groups (host_descriptor), held
# on the CPU: the tables against the exact phase, and a numpy emulation of
# the kernel's arithmetic against the plain segment and the JAX package.


def _exact_phase(idx: int, l: int, M: int) -> complex:
    """exp(i*pi*(idx & mask)/2^l) at 50 digits, rounded once to complex128."""
    mask = (1 << l) - (1 << M) if l > M else 0
    with mpmath.workdps(50):
        x = mpmath.mpf(idx & mask) / (1 << l)
        return complex(float(mpmath.cospi(x)), float(mpmath.sinpi(x)))


def _cdiff(a, b) -> float:
    return max(abs(a.real - b.real), abs(a.imag - b.imag))


def _split_case(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 32))
    t = int(rng.integers(1, min(n, 12) + 1))
    k = int(rng.integers(0, min(5, n - t) + 1))
    high = tuple(sorted(int(a) for a in rng.choice(np.arange(t, n), size=k, replace=False)))
    l = int(rng.integers(1, n))
    return n, t, high, l, rng


@pytest.mark.parametrize("M", [0, 3, 13])
@pytest.mark.parametrize("seed", range(12))
def test_split_iqft_tables_give_the_exact_phase(M, seed):
    """F_low times a reference F_tile (the exact phase of the index with its
    low bits zero) is exp(i*pi*(idx & mask)/2^l), and F_base * F_axes is
    that F_tile; F_low is all ones when M >= t."""
    n, t, high, l, rng = _split_case(seed * 3 + M)
    f_low = fused.iqft_low_phases(l, M, t)
    f_axes = fused.iqft_axis_phases(l, M, high)
    assert len(f_low) == 1 << min(l, t) and len(f_axes) == 1 << len(high)
    if M >= t:
        np.testing.assert_array_equal(f_low, np.ones_like(f_low))
    for idx in (int(v) for v in rng.integers(0, 1 << n, size=64)):
        low = idx & ((1 << t) - 1)
        c = sum(((idx >> q) & 1) << a for a, q in enumerate(high))
        tile_idx = idx - low
        base = tile_idx & ~sum(1 << q for q in high)
        want = _exact_phase(idx, l, M)
        f_tile = _exact_phase(tile_idx, l, M)
        got = f_low[low & ((1 << min(l, t)) - 1)] * f_tile
        assert _cdiff(got, want) <= 4e-16
        assert _cdiff(fused.iqft_phases([base], l, M)[0] * f_axes[c], f_tile) <= 4e-16  # F_base * F_axes
        low32 = np.complex64(f_low[low & ((1 << min(l, t)) - 1)])
        assert _cdiff(complex(low32 * np.complex64(f_tile)), want) <= 3e-7


def _insert_zero(x, p):
    return ((x >> p) << (p + 1)) | (x & ((1 << p) - 1))


def _emulate_matrix(tile, rec, mtab):
    """One matrix op (record rec) on a 2^13-element tile, from its packed
    table in mtab (the record's chunks at its byte offset; the layout undone
    by tests/torch_matmul_spec's unpackers): the float32 planes through
    3xTF32, the activations split as the kernel splits them and the table's
    TF32 hi / lo parts as packed, hi*hi + hi*lo + lo*hi."""
    kind, chunks, off, real = int(rec[0]), int(rec[4]), int(rec[5]), bool(rec[6])
    buf = mtab[off: off + chunks * fused.MAT_CHUNK]
    if kind == 8:
        tab = unpack_xtable(buf)
        return tile * (tab[0].astype(np.float64) + 1j * tab[1].astype(np.float64)).reshape(-1)
    parts = unpack_product(buf, "rowmat" if kind == 7 else "lanemat", real, bf16=False).astype(np.float64)
    xr, xi = tile.real.astype(np.float32), tile.imag.astype(np.float32)

    def prod(x, p):  # X B (lanemat) or (X^T B)^T (rowmat), B = parts p (hi), p + 1 (lo)
        x = x.reshape(-1, 128) if kind == 6 else x.reshape(64, 128).T
        hi, lo = (v.astype(np.float64) for v in tf32_parts(x))
        y = hi @ parts[p] + hi @ parts[p + 1] + lo @ parts[p]
        return (y if kind == 6 else y.T).reshape(-1)

    yr, yi = prod(xr, 0), prod(xi, 0)
    if not real:
        yr, yi = yr - prod(xi, 2), yi + prod(xr, 2)
    return yr + 1j * yi


def _emulate_kernel(psi, ops, axes, n, M, dtype, tables=()):
    """The CUDA kernel's arithmetic on a complex128 state, tile by tile and
    register group by group, from host_descriptor's arrays (the tables in
    the plane dtype, products in complex128; a grouped segment's matrix ops
    through _emulate_matrix, from matrix_tables' bytes)."""
    t, high, vb, ne, ops_i, ops_f, grp, ftab = fused.host_descriptor(ops, axes, n, M, dtype, tables)
    ptab = fused.camodc_tables(ops, M).astype(np.int64)
    mtab = fused.matrix_tables(ops, tables, dtype)
    ft = ftab[0::2].astype(np.float64) + 1j * ftab[1::2].astype(np.float64)
    of = ops_f.astype(np.float64)
    k, s = len(high), 1 / math.sqrt(2)
    tb = t + k
    out = psi.copy()
    c = np.arange(1 << k)
    for tau in range(1 << (n - tb)):
        base = tau << t
        for a in high:
            base = _insert_zero(base, a)
        hi = base | (np.zeros(1 << k, np.int64) + sum(((c >> a) & 1) << q for a, q in enumerate(high)))
        j = np.arange(1 << tb)
        gidx = hi[j >> t] | (j & ((1 << t) - 1))
        tile = out[gidx]
        for b, e, *extra in grp:
            if ops_i[b, 0] >= 6:  # a matrix op: its own group, over the whole tile
                tile = _emulate_matrix(tile, ops_i[b], mtab)
                continue
            if ops_i[b, 0] == 5:  # camodc: its own group, a gather of each work block
                _, cq, m, cpos, _, off, _, _ = (int(v) for v in ops_i[b])
                on = (j >> cpos) & 1 if cpos >= 0 else np.full(len(j), (base >> cq) & 1)
                w = (1 << m) - 1
                src = np.where(on == 1, (j & ~w) | ptab[off + (j & w)], j)
                tile = tile[src]
                continue
            extra = [int(p) for p in extra[: ne - vb]]
            j0 = np.arange(1 << (tb - ne)) << vb
            for p in extra:
                j0 = _insert_zero(j0, p)
            off = [(x & ((1 << vb) - 1)) | sum(((x >> (vb + i)) & 1) << p for i, p in enumerate(extra)) for x in range(1 << ne)]
            J = j0[:, None] | np.array(off)[None, :]
            X = tile[J]
            g0 = hi[j0 >> t] | (j0 & ((1 << t) - 1))
            for o in range(b, e):
                kind, q1, q2, s1, s2, oax, olow, oe = (int(v) for v in ops_i[o])
                f = of[o]
                slot = lambda sl, x: ((x >> sl) & 1) if sl >= 0 else 0  # noqa: E731
                pairs = [(x, x | (1 << s1)) for x in range(1 << ne) if not (x >> s1) & 1] if kind in (0, 3) else []
                if kind == 0:
                    u = f[:4].reshape(2, 2) + 1j * f[4:8].reshape(2, 2)
                    for x0, x1 in pairs:
                        a_, b_ = X[:, x0].copy(), X[:, x1].copy()
                        X[:, x0], X[:, x1] = u[0, 0] * a_ + u[0, 1] * b_, u[1, 0] * a_ + u[1, 1] * b_
                elif kind == 1:
                    for x in range(1 << ne):
                        bit = ((g0 >> q1) & 1) | slot(s1, x)
                        X[:, x] *= np.where(bit == 1, f[2] + 1j * f[3], f[0] + 1j * f[1])
                elif kind == 2:
                    for x in range(1 << ne):
                        d = 2 * (((g0 >> q1) & 1) | slot(s1, x)) + (((g0 >> q2) & 1) | slot(s2, x))
                        X[:, x] *= f[d] + 1j * f[4 + d]
                elif kind == 3:
                    P = np.full(len(j0), s, complex)
                    if oe > 0:
                        P = P * fused.iqft_phases([base], q1, M)[0]  # F_base, which the kernel forms per tile
                        if oax >= 0:
                            P = P * ft[oax + (j0 >> t)]
                        if olow >= 0:
                            P = P * ft[olow + (j0 & ((1 << min(q1, t)) - 1))]
                    for x0, x1 in pairs:
                        a_, b_ = X[:, x0].copy(), X[:, x1].copy()
                        X[:, x0] = s * (a_ + b_)
                        w = f[0 : 2 * ne : 2] + 1j * f[1 : 2 * ne : 2]  # one factor per slot bit
                        E = np.prod([w[b] for b in range(ne) if (x1 >> b) & 1]) if oe > 0 else 1.0
                        X[:, x1] = (a_ - b_) * (P * E if oe > 0 else s)
                else:
                    m4 = f[:16].reshape(4, 4) + 1j * f[16:].reshape(4, 4)
                    hb, lb = 1 << s1, 1 << s2
                    for x in range(1 << ne):
                        if x & (hb | lb) == 0:
                            idx = [x, x | lb, x | hb, x | hb | lb]
                            X[:, idx] = X[:, idx] @ m4.T
            tile[J] = X
        out[gidx] = tile
    return out


@pytest.mark.parametrize("n,M", [(12, 0), (12, 3), (13, 4), (14, 0), (14, 13)])
def test_split_angle_emulation_matches_jax_iqft(n, M):
    """The kernel's split-angle iQFT over tiles with exposed axes, emulated
    from its f64 tables, equals the JAX package's iQFT stages (XLA,
    complex128) within 1e-12."""
    rng = np.random.default_rng(n * 31 + M)
    jgates = tuple(jcir.IQFT_STAGE(l) for l in range(n - 1, -1, -1))
    circuit = interop.circuit_from_reference(jgates)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi /= np.linalg.norm(psi)
    plan = fused.plan_circuit(circuit, n, M, fused.TILE_BITS[torch.float64])
    assert any(fused.tile_geometry(n, axes, fused.TILE_BITS[torch.float64])[1] for _, _, axes in plan)
    got = psi
    for _, ops, axes in plan:
        got = _emulate_kernel(got, ops, axes, n, M, torch.float64)
    want = jnp.asarray(psi)
    for g in jgates:
        want = jengine.apply_gate(want, g, M, backend="xla")
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("n,M", [(1, 0), (2, 3), (3, 0), (4, 13), (5, 3), (9, 0), (13, 3), (15, 0), (16, 13)])
def test_kernel_emulation_matches_plain_segment(dtype, n, M):
    """Every op kind through the kernel's register groups (edge form for the
    smallest states) equals plain_segment: within 1e-12 from f64 tables,
    3e-5 from f32 ones (bf16 segments: their descriptor, 2^5 amplitudes a
    thread and float32 tables, before any bf16 rounding)."""
    rng = np.random.default_rng(n * 7 + M)
    circuit = _random_circuit(rng, n, 30) if n > 1 else (cir.H(0), cir.IQFT_STAGE(0), cir.RZ(0, 0.3), cir.IQFT_STAGE(0))
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi /= np.linalg.norm(psi)
    want = interop.state_from_numpy(np.stack([psi.real, psi.imag]))
    got = psi
    for _, ops, axes in fused.plan_circuit(circuit, n, M, fused.TILE_BITS[dtype]):
        want = fused.plain_segment(want, ops, M)
        got = _emulate_kernel(got, ops, axes, n, M, dtype)
    np.testing.assert_allclose(got, want[0].numpy() + 1j * want[1].numpy(), atol=ATOL64 if dtype == torch.float64 else ATOL32)


MATRIX_EMULATION = [
    ("m_high H layer", 14, 0, tuple(cir.H(q) for q in range(14))),
    ("m_high iQFT", 14, 0, tuple(cir.IQFT_STAGE(l) for l in range(13, -1, -1))),
    ("row stages M=8", 15, 8, tuple(cir.IQFT_STAGE(l) for l in range(14, 7, -1)) + (cir.H(2), cir.CPHASE(6, 1, 0.4))),
    ("random", 14, 3, None),
    ("lanemat beside axes", 16, 0, (cir.H(0), cir.RZ(1, 0.3), cir.H(15), cir.CPHASE(14, 3, 0.5), cir.H(13), cir.H(2))),
]


@pytest.mark.parametrize("case", MATRIX_EMULATION, ids=[c[0] for c in MATRIX_EMULATION])
def test_matrix_group_emulation_matches_plain_segment(case):
    """The kernel's matrix groups (lanemat, rowmat, xtable), emulated from
    host_descriptor's records and matrix_tables with the 3xTF32 split of
    its float32 mma, equal the grouped plain version (plain_ops of group_ops)
    within 3e-5, segment by segment of the grouping planner's plan."""
    name, n, M, circuit = case
    rng = np.random.default_rng(n * 11 + M)
    circuit = _random_circuit(rng, n, 30) if circuit is None else circuit
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi = (psi / np.linalg.norm(psi)).astype(np.complex64).astype(np.complex128)
    plan = fused.plan_circuit(circuit, n, M, fused.TILE_BITS[torch.float32], group=True)
    grouped = 0
    for _, ops, axes in plan:
        planes = torch.from_numpy(np.stack([psi.real, psi.imag]).astype(np.float32))
        gops, tables = fused.group_ops(ops, M)
        want = fused.plain_ops(planes, gops, M, tables)
        grouped += any(op[0] in fused.MATRIX_KINDS for op in gops)
        got = _emulate_kernel(psi, gops, axes, n, M, torch.float32, tables)
        np.testing.assert_allclose(got, want[0].numpy() + 1j * want[1].numpy(), atol=ATOL32)
        psi = want[0].numpy().astype(np.float64) + 1j * want[1].numpy()
    assert grouped


CAMODC_EMULATION = [
    ("base control", 14, 4, (cir.CAMODC(15, 7, 13),)),
    ("two ops", 14, 4, (cir.CAMODC(15, 7, 13), cir.CAMODC(15, 13, 12))),
    ("axis control", 14, 6, (cir.X(12), cir.CAMODC(33, 29, 12), cir.CAMODC(33, 7, 13))),
    ("low control", 14, 4, (cir.CAMODC(15, 7, 6), cir.CAMODC(15, 13, 13))),
    ("M=13", 16, 13, (cir.CAMODC(8191, 3, 15), cir.CAMODC(8191, 9, 14))),
    ("whole state", 5, 4, (cir.CAMODC(15, 7, 4),)),
    ("edge form", 3, 2, (cir.CAMODC(3, 2, 2),)),
    ("mixed with H", 15, 6, (cir.H(14), cir.H(13), cir.CAMODC(33, 29, 12), cir.H(2), cir.CAMODC(33, 7, 14))),
]


def _emulate_permute(psi, ops, n, M):
    """The camodc permutation kernel (csrc/camodc_permute.cu) on a complex
    state, from permute_descriptor: item by item, the changed work block and
    its case found as the kernel finds them (case m = (d >> log_q) + 1, the
    bits of m inserted at the control positions into d's low log_q bits),
    each plane of the block gathered through case table m - 1.  Asserts that
    the items reach every block whose controls are not all 0, once a plane."""
    positions, log_q, items, tables = fused.permute_descriptor(ops, n, M)
    out = psi.copy()
    reached = []
    for item in range(items):
        d, plane = item >> 1, item & 1
        m = (d >> log_q) + 1
        block = d & ((1 << log_q) - 1)
        for j, p in enumerate(positions):
            block = ((block >> p) << (p + 1)) | (((m >> j) & 1) << p) | (block & ((1 << p) - 1))
        assert m == sum(((block >> p) & 1) << j for j, p in enumerate(positions))
        reached.append((block, plane))
        rows = slice(block << M, (block + 1) << M)
        src = (psi.imag if plane else psi.real)[rows][tables[m - 1, : 1 << M].astype(np.int64)]
        if plane:
            out.imag[rows] = src
        else:
            out.real[rows] = src
    blocks = np.arange(1 << (n - M))
    changed = [b for b in blocks if any((b >> p) & 1 for p in positions)]
    assert sorted(reached) == [(b, pl) for b in changed for pl in (0, 1)]
    return out


def _jax_camodc_state(planes, circuit, n, M, dtype):
    """The JAX kernel (interpret mode) on the circuit's fused plan, planes of
    `dtype` (float32, float64 or bfloat16), as a complex128 state."""
    jdtype = {torch.float32: jnp.float32, torch.float64: jnp.float64, torch.bfloat16: jnp.bfloat16}[dtype]
    jgates = tuple(jcir.Gate(g.name, g.qubits, g.params, g.meta, g.matrix) for g in circuit)
    re, im = jnp.asarray(planes[0], jdtype), jnp.asarray(planes[1], jdtype)
    for _, ops, axes in pf.plan_circuit(jgates, n, M, fuse_oracle=True):
        re, im = pf.apply_fused(re, im, ops, axes, n, M)
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("case", CAMODC_EMULATION, ids=[c[0] for c in CAMODC_EMULATION])
def test_camodc_kernel_emulation_matches_plain_segment(dtype, case):
    """Each segment of the plan, emulated as the kernel that kernel_body
    picks for it runs it (the camodc permutation through its descriptor, or
    the fused kernel's gather of each work block through the inverse
    permutation), equals the plain Benes stages (plain_segment) on the same
    input: exactly where the segment only moves data.  There the plain
    case-table gather (plain_permute) equals both, and, where the JAX
    kernel's layout takes the state (n >= 14), so does the JAX kernel in
    interpret mode on the whole circuit, at float32, float64 and bf16
    planes."""
    name, n, M, circuit = case
    rng = np.random.default_rng(n * 3 + M)
    planes = torch.from_numpy(rng.standard_normal((2, 1 << n))).to(dtype)  # values the planes hold exactly
    plan = fused.plan_circuit(circuit, n, M, fused.TILE_BITS[dtype], fuse_oracle=True)
    assert all(s[0] == "fused" for s in plan) and any(op[0] == "camodc" for s in plan for op in s[1])
    moves_only = all(op[0] == "camodc" for s in plan for op in s[1])
    state = planes
    for _, ops, axes in plan:
        psi = state[0].double().numpy() + 1j * state[1].double().numpy()
        want = fused.plain_segment(state, ops, M)
        if fused.kernel_body(ops, M, dtype, aligned=True) == "permute":
            got = _emulate_permute(psi, ops, n, M)
            assert torch.equal(fused.plain_permute(state, ops, M), want)
        else:
            got = _emulate_kernel(psi, ops, axes, n, M, dtype)
        state = want
        want = want[0].double().numpy() + 1j * want[1].double().numpy()
        if moves_only:
            np.testing.assert_array_equal(got, want)
        elif dtype == torch.bfloat16:  # the kernel rounds once a pass, as plain_segment does
            rounded = torch.from_numpy(np.stack([got.real, got.imag])).to(torch.bfloat16).double().numpy()
            np.testing.assert_allclose(rounded[0] + 1j * rounded[1], want, rtol=2.0 ** -8, atol=2.0 ** -16)
        else:
            np.testing.assert_allclose(got, want, atol=ATOL64 if dtype == torch.float64 else ATOL32)
    if moves_only and n >= 14:
        final = state[0].double().numpy() + 1j * state[1].double().numpy()
        np.testing.assert_array_equal(final, _jax_camodc_state(planes.float().numpy() if dtype == torch.bfloat16 else planes.numpy(), circuit, n, M, dtype))


def test_register_groups_of_the_flagship_segments():
    """At n = 28 every target of a group is one of its slots, and the
    segments take 3-5 register groups (one shared-memory pass each)."""
    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh
    from quantumcomputer_tpu_torch.sim.engine import fuse_oracles

    C, a, L, M = 8191, 3, 15, 13
    n = L + M
    for circuit, m in ((shor_circuit(C, a, L, M), M), (shor_circuit_mhigh(C, a, L, M), 0)):
        for seg in fused.plan_circuit(fuse_oracles(circuit, m, n, 4, True), n, m, 12):
            if seg[0] != "fused":
                continue
            t, high, vb, ne, ops_i, _, grp, _ = fused.host_descriptor(seg[1], seg[2], n, m, torch.float32)
            assert (vb, ne) == (2, 4)
            assert 1 <= len(grp) <= 5
            for b, e, *extra in grp:
                for o in range(b, e):
                    if ops_i[o, 0] in (0, 3, 4):
                        assert ops_i[o, 3] >= 0 and (ops_i[o, 0] != 4 or ops_i[o, 3] > ops_i[o, 4] >= 0)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
