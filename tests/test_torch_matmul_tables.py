"""The host side of the matrix-group kernel (csrc/fused_matmul.cu): the
tables that ops/fused.matrix_tables packs for the tensor-core products,
held against the JAX package's tables (pallas_fused.matmul_group_ops and
its bf16 staging), and a numpy emulation of the kernel's 3xTF32 and bf16
products read back from the packed bytes.  The layout and the TF32
rounding are stated apart from ops/fused.py, in tests/torch_matmul_spec.py."""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.models import circuit as jcir
from quantumcomputer_tpu.models.shor_circuit import shor_circuit_mhigh as jshor_circuit_mhigh
from quantumcomputer_tpu.ops import pallas_fused as pf
from quantumcomputer_tpu_torch.ops import fused
from tests.torch_matmul_spec import LANE, k_order, tf32_parts, tf32_rna, unpack_product, unpack_xtable

def _cases():
    """(name, ops, axes, n, M) of segments that group: the JAX plan of the m_high
    flagship, the full iQFT at M = 3 and 8, and seeded random segments."""
    cases = []
    for name, circuit, n, M in (
        ("m_high flagship", jshor_circuit_mhigh(8191, 3, 15, 13), 28, 0),
        ("iQFT M=3", tuple(jcir.IQFT_STAGE(l) for l in range(15, 2, -1)), 16, 3),
        ("iQFT M=8", tuple(jcir.IQFT_STAGE(l) for l in range(15, 7, -1)), 16, 8),
    ):
        segs = fused.plan_circuit(circuit, n, M, fused.TILE_BITS[torch.float32], group=True)
        cases += [(f"{name} {i}", seg[1], seg[2], n, M) for i, seg in enumerate(segs) if seg[0] == "fused"]
    rng = np.random.default_rng(41)
    for seed in range(3):
        gates = []
        for _ in range(16):
            q, p = (int(v) for v in rng.choice(13, 2, replace=False))
            gates.append((jcir.H(q), jcir.RY(q, 0.3 + seed), jcir.CPHASE(q, p, 0.9), jcir.IQFT_STAGE(q))[int(rng.integers(4))])
        cases.append((f"random {seed}", pf.compose_ops(tuple(pf.gate_to_op(g, 0) for g in gates)), (), 16, 0))
    return [c for c in cases if any(op[0] in fused.MATRIX_KINDS for op in pf.matmul_group_ops(c[1], c[4])[0])]


CASES = _cases()


def _packed(case, dtype):
    """[(op, the JAX table, its packed bytes)] of a segment's matrix ops."""
    _, ops, axes, n, M = case
    gops, mats = pf.matmul_group_ops(ops, M)
    _, _, _, _, ops_i, *_ = fused.host_descriptor(gops, axes, n, M, dtype, mats)
    mtab = fused.matrix_tables(gops, mats, dtype)
    out = []
    for k, op in enumerate(gops):
        if op[0] in fused.MATRIX_KINDS:
            off, chunks = int(ops_i[k, 5]), int(ops_i[k, 4])
            out.append((op, mats[op[1]], mtab[off: off + chunks * fused.MAT_CHUNK]))
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tf32_parts_reconstruct_the_jax_table(case):
    """At float32 each product table's packed hi is TF32-exact (13 low bits
    zero) and within 2^-11 relative of the JAX table (round to nearest with
    10 mantissa bits: half an ulp), and hi + lo within 2^-22 relative (lo is
    the remainder, itself rounded to TF32); element for element, after the
    stated layout is undone."""
    products = 0
    for op, tab, buf in _packed(case, torch.float32):
        if op[0] == "xtable":
            continue
        products += 1
        parts = unpack_product(buf, op[0], op[2], bf16=False)
        for reim in range(1 if op[2] else 2):
            hi, lo, want = parts[2 * reim], parts[2 * reim + 1], tab[reim].astype(np.float64)
            assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
            assert np.all(np.abs(hi - want) <= 2.0 ** -11 * np.abs(want))
            assert np.all(np.abs(hi.astype(np.float64) + lo - want) <= 2.0 ** -22 * np.abs(want))
            np.testing.assert_array_equal(hi, tf32_rna(tab[reim]))
            np.testing.assert_array_equal(lo, tf32_rna(tab[reim] - hi))
        if op[2]:
            assert not np.abs(tab[1]).any()  # a real table has no imaginary part to stage
    assert products


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bf16_parts_are_the_jax_staging(case):
    """At bf16 each product table's packed parts, read back through the
    stated layout, are the JAX package's staged hi / lo bf16 values
    (pallas_fused.py:1114-1119) bit for bit; xtables stay float32."""
    for op, tab, buf in _packed(case, torch.bfloat16):
        if op[0] == "xtable":
            np.testing.assert_array_equal(unpack_xtable(buf), tab)
            continue
        hi = tab.astype(ml_dtypes.bfloat16)
        lo = (tab - hi.astype(np.float32)).astype(ml_dtypes.bfloat16)
        parts = unpack_product(buf, op[0], op[2], bf16=True)
        for reim in range(1 if op[2] else 2):
            np.testing.assert_array_equal(parts[2 * reim], hi[reim].astype(np.float32))
            np.testing.assert_array_equal(parts[2 * reim + 1], lo[reim].astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_xtable_and_descriptor_records(case):
    """Every xtable's chunks hold the JAX (64, 128) cos / sin table, each
    element once; host_descriptor's records give each matrix op its chunk
    count and the byte offset of its first chunk in op order, and mark a
    rowmat and the xtable right after it as fused."""
    _, ops, axes, n, M = case
    gops, mats = pf.matmul_group_ops(ops, M)
    for dtype in (torch.float32, torch.bfloat16):
        _, _, _, _, ops_i, *_ = fused.host_descriptor(gops, axes, n, M, dtype, mats)
        mtab = fused.matrix_tables(gops, mats, dtype)
        off = 0
        for k, op in enumerate(gops):
            if op[0] not in fused.MATRIX_KINDS:
                continue
            size = LANE if op[0] == "lanemat" else 64
            nbytes = 2 * 64 * LANE * 4 if op[0] == "xtable" else (2 if op[2] else 4) * size * size * (2 if dtype == torch.bfloat16 else 4)
            assert (ops_i[k, 4], ops_i[k, 5]) == (nbytes // fused.MAT_CHUNK, off)
            fused_x = (op[0] == "rowmat" and k + 1 < len(gops) and gops[k + 1][0] == "xtable") or (
                op[0] == "xtable" and gops[k - 1][0] == "rowmat")
            assert ops_i[k, 7] == int(fused_x)
            if op[0] == "xtable":
                np.testing.assert_array_equal(unpack_xtable(mtab[off: off + nbytes]), mats[op[1]])
            off += nbytes
        assert mtab.nbytes == off


def _emulate_3xtf32(x, parts, order):
    """Y = X B as the kernel's 3xTF32 products: the activations split into
    TF32 hi + lo (cvt.rna), the K index in the products' order, each k-step
    of 8 adding lo*B_hi + hi*B_lo + hi*B_hi to a float32 accumulator
    (the products exact, as the tensor cores form them)."""
    hi, lo = tf32_parts(x)
    acc = np.zeros((x.shape[0], parts[0].shape[1]), np.float32)
    b_hi, b_lo = parts[0][order].astype(np.float64), parts[1][order].astype(np.float64)
    a_hi, a_lo = hi[:, order].astype(np.float64), lo[:, order].astype(np.float64)
    for k0 in range(0, len(order), 8):
        s = slice(k0, k0 + 8)
        for a, b in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            acc = (acc.astype(np.float64) + a[:, s] @ b[s]).astype(np.float32)
    return acc


@pytest.mark.parametrize("kind", ["lanemat", "rowmat"])
@pytest.mark.parametrize("seed", range(3))
def test_3xtf32_emulation_within_its_bound(kind, seed):
    """The kernel's float32 arithmetic spec on the CPU: a unit-variance
    64 x 128 tile through a packed random table (lanemat X W; rowmat
    (V X)^T = X^T B), emulated from the packed TF32 parts in the products'
    K order, against the float64 product of the float32 operands.  Bound,
    per output: the dropped and residual terms of the splits (each operand
    is hi + lo within 2^-22 relative, so 3 * 2^-22 of sum |x_k| |w_kn|) plus
    float32 accumulation (one rounding of 2^-24 an add, 3 K / 8 adds of
    partial sums below that sum), i.e. (3 * 2^-22 + 3 K / 8 * 2^-24) sum |x_k| |w_kn|;
    and within the kernel's 3e-5 against the plain version."""
    rng = np.random.default_rng(seed)
    size = LANE if kind == "lanemat" else 64
    tab = rng.standard_normal((2, size, size)).astype(np.float32) / np.sqrt(size)
    tile = rng.standard_normal((64, LANE)).astype(np.float32)
    x = tile if kind == "lanemat" else tile.T.copy()  # rowmat: A = X^T (128 x 64)
    parts = unpack_product(_pack(tab, kind), kind, real=False, bf16=False)
    order = k_order(kind, bf16=False)
    for reim in range(2):
        got = _emulate_3xtf32(x, parts[2 * reim: 2 * reim + 2], order)
        w = tab[reim].astype(np.float64)
        want = x.astype(np.float64) @ w
        scale = np.abs(x).astype(np.float64) @ np.abs(w)
        bound = (3 * 2.0 ** -22 + 3 * size / 8 * 2.0 ** -24) * scale
        assert np.all(np.abs(got - want) <= bound)
        assert np.abs(got - want).max() <= 3e-5


def _pack(tab, kind):
    op = (kind, 0, False)
    return fused.matrix_tables((op,), (tab,), torch.float32)


@pytest.mark.parametrize("kind", ["lanemat", "rowmat"])
def test_bf16_emulation_matches_the_plain_version(kind):
    """The kernel's bf16 arithmetic from the packed bytes: activations
    rounded to bf16, products against the hi and lo parts with float32
    accumulation, equal within 2^-16 of sum |x_k| |w_kn| to the JAX
    kernel's mxu_dot (pallas_fused.py:594-609, its bf16 dots with float32
    accumulation against the JAX staging of the table, here in jnp) and
    to the port's plain version (_matrix_planes at bf16): all form the
    same exact products, the references sum them in float32 (K adds of
    2^-24 each, 2^-17 of that sum at K = 128)."""
    rng = np.random.default_rng(7)
    size = LANE if kind == "lanemat" else 64
    tab = (rng.standard_normal((2, size, size)) / np.sqrt(size)).astype(np.float32)
    tile = rng.standard_normal((2, 64, LANE)).astype(np.float32)
    buf = fused.matrix_tables(((kind, 0, False),), (tab,), torch.bfloat16)
    parts = unpack_product(buf, kind, real=False, bf16=True).astype(np.float64)
    xb = torch.from_numpy(tile).to(torch.bfloat16).float().numpy().astype(np.float64)
    if kind == "rowmat":
        xb = xb.transpose(0, 2, 1)
    yr = xb[0] @ (parts[0] + parts[1]) - xb[1] @ (parts[2] + parts[3])
    yi = xb[0] @ (parts[2] + parts[3]) + xb[1] @ (parts[0] + parts[1])
    hi = tab.astype(ml_dtypes.bfloat16)
    lo = (tab - hi.astype(np.float32)).astype(ml_dtypes.bfloat16)
    x = jnp.asarray(tile).astype(jnp.bfloat16)

    def mxu_dot(v, reim):  # x @ W, or W @ x with W = V = table^T for a rowmat
        if kind == "rowmat":
            return sum(jnp.dot(jnp.asarray(p[reim].T), v, preferred_element_type=jnp.float32) for p in (hi, lo))
        return sum(jnp.dot(v, jnp.asarray(p[reim]), preferred_element_type=jnp.float32) for p in (hi, lo))

    jax_r = np.asarray(mxu_dot(x[0], 0) - mxu_dot(x[1], 1))
    jax_i = np.asarray(mxu_dot(x[0], 1) + mxu_dot(x[1], 0))
    port_r, port_i = fused._matrix_planes(torch.from_numpy(tile[0]), torch.from_numpy(tile[1]), tab, False, True,
                                          kind == "rowmat")
    scale = (np.abs(xb[0]) + np.abs(xb[1])) @ (np.abs(tab[0]) + np.abs(tab[1])).astype(np.float64)
    if kind == "rowmat":
        yr, yi, scale = yr.T, yi.T, scale.T
    for want_r, want_i in ((jax_r, jax_i), (port_r.numpy(), port_i.numpy())):
        assert np.all(np.abs(yr - want_r) <= 2.0 ** -16 * scale)
        assert np.all(np.abs(yi - want_i) <= 2.0 ** -16 * scale)


@pytest.mark.parametrize("seed", range(2))
def test_port_tf32_split_is_the_stated_rounding(seed):
    """ops/fused.tf32_split, which packs the float32 tables, equals the
    stated cvt.rna rounding (tf32_rna: 11 significant bits, ties away from
    zero) on random normal values of both signs and on exact ties."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4096) * np.exp2(rng.integers(-20, 20, 4096))).astype(np.float32)
    ties = (np.float32(1) + np.float32(2.0 ** -11) * np.arange(1, 64, 2, dtype=np.float32)) * np.float32(1 - 2 * seed)
    x = np.concatenate([x, ties])
    hi, lo = fused.tf32_split(x)
    want_hi, want_lo = tf32_parts(x)
    np.testing.assert_array_equal(hi, want_hi)
    np.testing.assert_array_equal(lo, want_lo)
    assert np.all(np.abs(want_hi[-32:]) > np.abs(x[-32:]))  # ties go away from zero


def test_k_order_is_a_permutation_of_the_activations():
    """Each product's K order visits every lane (row) once: the lanemat's
    permutation at both precisions and the rowmat's identity, as the kernel
    and ops/fused.mat_k_order state them."""
    for kind in ("lanemat", "rowmat"):
        for dtype in (torch.float32, torch.bfloat16):
            order = fused.mat_k_order(kind, dtype)
            np.testing.assert_array_equal(order, k_order(kind, dtype == torch.bfloat16))
            assert sorted(order) == list(range(len(order)))
