"""The port's structured stride permutation (quantumcomputer_tpu_torch/ops/
modperm.py, ops/transpose.py, ops/chunkgather.py and the on-device
modular multiply of ops/gates.py) against the JAX package's, on the same
seeded inputs.

Everything here only moves data or does integer arithmetic, so every
comparison is exact (tolerance 0).  The JAX transpose and chunk-gather
kernels run in Pallas interpret mode, as the JAX suite runs them on the CPU.
Plans must equal the JAX planner's under the accelerator's factor floor
(min_factor=256), field for field.  The CUDA kernels are held against their
plain versions on the card by chip_smoke.py and
quantumcomputer_tpu_torch/utils/kernel_checks.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.ops import gates as xops
from quantumcomputer_tpu.ops import modperm as jmodperm
from quantumcomputer_tpu.ops import pallas_chunkgather as jcg
from quantumcomputer_tpu.ops.pallas_transpose import tiled_transpose_padded as jtranspose
from quantumcomputer_tpu_torch import interop
from quantumcomputer_tpu_torch.ops import chunkgather, modperm, transpose
from quantumcomputer_tpu_torch.ops import gates as tops


def _x(rng, B, P, dtype=np.float32):
    return rng.standard_normal((B, P)).astype(dtype)


def _element_map(x, C, a_inv, M):
    j = np.arange(1 << M)
    return x[..., np.where(j < C, (a_inv * j) % C, j)]


# ---------------------------------------------------------------------------
# The on-device modular multiply.


@pytest.mark.parametrize("C", [15, 8191, (1 << 20) - 3, 268435453, 1060314373, (1 << 30) - 35])
def test_modmul_onchip_matches_jax(C):
    rng = np.random.default_rng(C % 1000)
    j = rng.integers(0, C, 4096).astype(np.int32)
    for a in [1, 2, C - 1] + [int(v) for v in rng.integers(2, C, 6)]:
        want = np.asarray(xops.modmul_onchip(a, jnp.asarray(j), C, max(1, C.bit_length())))
        np.testing.assert_array_equal(tops.modmul_onchip(a, torch.from_numpy(j), C).numpy(), want)
        jj = np.concatenate([j, np.arange(C, C + 64, dtype=np.int64).clip(max=(1 << 31) - 1).astype(np.int32)])
        want = np.asarray(xops.modmul_permute_onchip(a, jnp.asarray(jj), C, max(1, C.bit_length())))
        np.testing.assert_array_equal(tops.modmul_permute_onchip(a, torch.from_numpy(jj), C).numpy(), want)


@pytest.mark.parametrize("C,A,M", [(15, 7, 4), (33, 29, 6), (8191, 3, 13), ((1 << 18) - 3, 12345, 18)])
def test_onchip_map_is_the_host_table(C, A, M):
    want = xops.modmul_inverse_permutation(C, A, M)
    got = tops.modmul_permute_onchip(pow(A, -1, C), torch.arange(1 << M), C)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The transpose: plain version against the JAX kernel (interpret mode).


@pytest.mark.parametrize(
    "shape,extra_rows",
    [((2, 300, 523), 0), ((1, 257, 129), 0), ((3, 8, 128), 0), ((2, 256, 384), 0), ((1, 300, 523), 1), ((2, 256, 128), 1)],
)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_transpose_matches_jax(shape, extra_rows, dtype):
    x = np.random.default_rng(shape[1]).standard_normal(shape).astype(dtype)
    want = np.asarray(jtranspose(jnp.asarray(x), block=(128, 128), extra_rows=extra_rows))
    got = transpose.tiled_transpose_padded(torch.from_numpy(x), extra_rows)
    assert tuple(got.shape) == want.shape
    rows = want.shape[1] - extra_rows  # the extra rows are undefined in both
    np.testing.assert_array_equal(got[:, :rows].numpy(), want[:, :rows])
    assert transpose.padded_shape(shape[1], shape[2], extra_rows) == want.shape[1:]


# ---------------------------------------------------------------------------
# The chunk gather: each plain form against the JAX kernel (interpret mode),
# in-contract starts.


@pytest.mark.parametrize("B", [1, 2])
def test_chunk_gather_matches_jax(B):
    rng = np.random.default_rng(10 + B)
    P, W, NC = 128 * 64, 512, 11
    x = _x(rng, B, P)
    starts = rng.integers(0, P - W + 1, NC)
    starts[:3] = (0, P - W, P - W - 1)
    want = np.asarray(jcg.chunk_gather(jnp.asarray(x), jnp.asarray(starts, jnp.int32), W))
    got = chunkgather.chunk_gather(torch.from_numpy(x), torch.from_numpy(starts), W)
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunk_gather_src2_matches_jax():
    rng = np.random.default_rng(12)
    P, P2, W, NC = 128 * 40, 128 * 8, 256, 13
    x, x2 = _x(rng, 2, P), _x(rng, 2, P2)
    flags = rng.integers(0, 2, NC)
    starts = np.where(flags == 1, rng.integers(0, P2 - W + 1, NC), rng.integers(0, P - W + 1, NC))
    want = np.asarray(
        jcg.chunk_gather_src2(jnp.asarray(x), jnp.asarray(x2), jnp.asarray(starts, jnp.int32), jnp.asarray(flags, jnp.int32), W)
    )
    got = chunkgather.chunk_gather_src2(torch.from_numpy(x), torch.from_numpy(x2), torch.from_numpy(starts), torch.from_numpy(flags), W)
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunk_gather_blend_matches_jax():
    rng = np.random.default_rng(13)
    P, W, NC = 128 * 48, 384, 9
    x = _x(rng, 2, P)
    s0, s1 = rng.integers(0, P - W + 1, NC), rng.integers(0, P - W + 1, NC)
    istar = rng.integers(0, W + 1, NC)
    istar[:2] = (0, W)
    args = [jnp.asarray(a, jnp.int32) for a in (s0, s1, istar)]
    want = np.asarray(jcg.chunk_gather_blend(jnp.asarray(x), *args, W))
    got = chunkgather.chunk_gather_blend(torch.from_numpy(x), *(torch.from_numpy(a) for a in (s0, s1, istar)), W)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("v,rows", [(300, 20), (899, 9), (1000, 12)])
def test_chunk_gather_rowlaw_matches_jax(v, rows):
    """Chunks run past the live rows, where the law's clamps decide."""
    rng = np.random.default_rng(v)
    vpad = -(-v // 128) * 128
    Wt = (v // 128) * 128
    x = _x(rng, 2, rows * vpad)
    NC = -(-(rows * v) // Wt) + 3
    want = np.asarray(jcg.chunk_gather_blend_rowlaw(jnp.asarray(x), NC, v, vpad, Wt))
    got = chunkgather.chunk_gather_blend_rowlaw(torch.from_numpy(x), NC, v, vpad, Wt)
    np.testing.assert_array_equal(got.numpy(), want)


def test_out_of_range_starts_clamp_into_the_buffer():
    """The port's stated semantics for the deal leg's boundary rows: every
    start is clamped into [0, P - W] of the buffer it reads."""
    rng = np.random.default_rng(14)
    P, W = 1024, 256
    x = torch.from_numpy(_x(rng, 2, P))
    starts = torch.tensor([-128, -1, 0, P - W, P - W + 1, P, 5 * P])
    got = chunkgather.chunk_gather(x, starts, W)
    for c, s in enumerate(starts.clamp(0, P - W).tolist()):
        assert torch.equal(got[:, c], x[:, s : s + W])
    x2 = torch.from_numpy(_x(rng, 2, 512))
    flags = torch.tensor([1, 0, 1, 0, 1, 0, 1])
    got = chunkgather.chunk_gather_src2(x, x2, starts, flags, W)
    for c, s in enumerate(starts.tolist()):
        src = x2 if flags[c] else x
        t = min(max(s, 0), src.shape[1] - W)
        assert torch.equal(got[:, c], src[:, t : t + W])


# ---------------------------------------------------------------------------
# Plans and the permutation.


def _planned_multipliers(M, want, seed):
    """Random multipliers of C = 2^M - 3 until `want` of them plan."""
    C = (1 << M) - 3
    rng = np.random.default_rng(seed)
    out = []
    for a in rng.integers(2, C - 1, 4000):
        a = int(a)
        if math.gcd(a, C) != 1:
            continue
        if modperm.plan_stride_permute(C, a, M) is not None:
            out.append(a)
            if len(out) == want:
                break
    return C, out


@pytest.mark.parametrize("M", [18, 20])
def test_plans_match_jax_under_the_factor_floor(M):
    C = (1 << M) - 3
    rng = np.random.default_rng(M)
    planned = 0
    for a in rng.integers(2, C - 1, 300):
        a = int(a)
        jp = jmodperm.plan_stride_permute(C, a, M, min_factor=256)
        tp = modperm.plan_stride_permute(C, a, M)
        assert (tp is None) == (jp is None), a
        if tp is not None:
            planned += 1
            assert interop.plan_from_reference(jp) == tp
            assert min(f for f in (tp.u, tp.v) if f > 1) >= modperm.MIN_FACTOR
        assert modperm.rational_split(a, C) == jmodperm.rational_split(a, C, 256)
    assert planned >= 30  # about 1 in 4 plans at M = 18, 3 in 4 at M = 20


def test_collect_chunking_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(300):
        C = int(rng.integers(1 << 10, 1 << 30)) | 1
        v = int(rng.integers(256, 1 << 16))
        if (C - 1) // v + 1 < 128:
            continue
        assert modperm.collect_chunking(C, v) == jmodperm.collect_chunking(C, v, True)
    assert modperm.collect_chunking((1 << 28) - 3, 1543) == (4096, 176128, 43)


@pytest.mark.parametrize("M", [18, 20])
def test_apply_stride_permute_matches_jax(M):
    """Several planned multipliers of C = 2^M - 3 (C % W != 0: the last deal
    chunk straddles C), run under the JAX plan, against the JAX function and
    the element map.  Two planes, as the JAX function takes them."""
    C, mults = _planned_multipliers(M, 3, seed=M + 1)
    assert len(mults) == 3
    rng = np.random.default_rng(M + 2)
    for a_inv in mults:
        jplan = jmodperm.plan_stride_permute(C, a_inv, M, min_factor=256)
        assert C % jplan.W != 0
        x = _x(rng, 2, 1 << M)
        got = modperm.apply_stride_permute(torch.from_numpy(x), interop.plan_from_reference(jplan)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jmodperm.apply_stride_permute(jnp.asarray(x), jplan)))
        np.testing.assert_array_equal(got, _element_map(x, C, a_inv, M))


def test_apply_stride_permute_f64_single_plane():
    C, mults = _planned_multipliers(18, 2, seed=3)
    x = np.random.default_rng(4).standard_normal((1, 1 << 18))
    for a_inv in mults:
        got = modperm.modmul_stride_permute(torch.from_numpy(x), C, a_inv, 18)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), _element_map(x, C, a_inv, 18))


def test_collect_row_split_matches_jax(monkeypatch):
    """Collect rows wider than the row cap split into chunks; shrink the cap
    (in both packages) so the split runs at this size, and sweep until a row
    width not divisible by the cap shows up."""
    monkeypatch.setattr(modperm, "_ROW_W_CAP", 256)
    monkeypatch.setattr(modperm, "_ROW_SPLIT_W", 128)
    monkeypatch.setattr(jmodperm, "_ROW_W_CAP", 256)
    monkeypatch.setattr(jmodperm, "_ROW_SPLIT_W", 128)
    M = 18
    C, mults = _planned_multipliers(M, 40, seed=9)
    rng = np.random.default_rng(9)
    split = nondivisible = 0
    for a_inv in mults:
        plan = modperm.plan_stride_permute(C, a_inv, M)
        Wc, Qpr, K = modperm.collect_chunking(C, plan.v)
        assert (Wc, Qpr, K) == jmodperm.collect_chunking(C, plan.v, True)
        if plan.v <= 1 or K == 1:
            continue
        split += 1
        nondivisible += -(-((C - 1) // plan.v + 1) // 128) * 128 % 256 != 0
        x = _x(rng, 1, 1 << M)
        got = modperm.apply_stride_permute(torch.from_numpy(x), plan).numpy()
        np.testing.assert_array_equal(got, _element_map(x, C, a_inv, M))
        jplan = jmodperm.plan_stride_permute(C, a_inv, M, min_factor=256)
        np.testing.assert_array_equal(got, np.asarray(jmodperm.apply_stride_permute(jnp.asarray(x), jplan)))
        if split >= 4 and nondivisible:
            break
    assert split >= 4 and nondivisible >= 1, (split, nondivisible)


@pytest.mark.parametrize(
    "M,C,u,W", [(16, 65533, 509, 128), (16, 65280, 131, 256), (17, 131063, 257, 256), (15, 32765, 129, 128)]
)
def test_deal_leg_matches_jax_junk_lane_view(M, C, u, W):
    """The deal leg's overlapping row view with its clamped boundary rows
    rewritten, at the JAX suite's shapes (C % W != 0 straddles, C % W == 0)."""
    x = np.random.default_rng(u).standard_normal((2, 1 << M)).astype(np.float32)
    got = modperm._deal_leg(torch.from_numpy(x), C, u, M, W).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmodperm._deal_leg(jnp.asarray(x), C, u, M, W)))
    np.testing.assert_array_equal(got, _element_map(x, C, u, M))


def test_row_compact_reads_the_slack_row_only_into_discarded_positions():
    """v = 899, 128 live rows (Qpv % 128 == 0): the last live chunk straddles
    the final row boundary.  The slack row is NaN, as undefined memory may
    be; no live position may see it."""
    v, rows, dim, vpad = 899, 128, 1 << 17, 1024
    w2 = np.full((1, rows + 1, vpad), np.nan, np.float32)
    w2[0, :rows] = -1.0
    w2[0, :rows, :v] = (np.arange(rows)[:, None] * v + np.arange(v)[None, :]).astype(np.float32)
    got = modperm._row_compact(torch.from_numpy(w2), v, dim).numpy()
    want = np.asarray(jmodperm._row_compact(jnp.asarray(w2), v, dim))
    live = rows * v
    np.testing.assert_array_equal(got[0, :live], np.arange(live, dtype=np.float32))
    np.testing.assert_array_equal(got[0, :live], want[0, :live])


def test_negation_and_single_leg_plans():
    M = 16
    C = (1 << M) - 3
    x = np.random.default_rng(2).standard_normal((2, 1 << M)).astype(np.float32)
    plan = modperm.StridePlan(C=C, M=M, eps=-1, u=1, v=1, vinv=1, W=16384)
    np.testing.assert_array_equal(modperm.apply_stride_permute(torch.from_numpy(x), plan).numpy(), _element_map(x, C, C - 1, M))
    plan = modperm.plan_stride_permute(C, 509, M)
    assert (plan.u, plan.v, plan.eps) == (509, 1, 1)
    np.testing.assert_array_equal(modperm.apply_stride_permute(torch.from_numpy(x), plan).numpy(), _element_map(x, C, 509, M))
    assert modperm.plan_stride_permute(C, 1, M) is None
    assert modperm.plan_stride_permute(C, 3, M) is None  # 3 = 3 * 1^-1: below the floor
    with pytest.raises(ValueError, match="unsupported"):
        modperm.modmul_stride_permute(torch.from_numpy(x), C, 3, M)


# ---------------------------------------------------------------------------
# The two-pass route: one offset transpose a leg (ops/transpose.py), ε folded
# into the last leg; the plain versions here, the kernel on the card
# (utils/kernel_checks.offset_transpose_legs).

# (C, a_inv, B) at M = 17, chosen for the shape of their plan: (eps, u, v).
TWO_PASS_M = 17
TWO_PASS_CASES = {
    "both legs, eps -1": (131069, 69643, 2, (-1, 280, 303)),
    "both legs, eps +1": (131069, 40664, 1, (1, 341, 332)),
    "u = 1, eps -1 in the collect leg": (131069, 3713, 2, (-1, 1, 353)),
    "u = 1, C = 2^M - 301": (130771, 40256, 1, (1, 1, 536)),
    "v = 1, the deal leg alone": (131069, 360, 2, (1, 360, 1)),
    "both legs, eps -1, C = 2^M - 301": (130771, 106689, 1, (-1, 269, 429)),
    "both legs, eps -1, identity tail": (78643, 39470, 2, (-1, 266, 263)),
    "v = 1, identity tail": (78643, 422, 1, (1, 422, 1)),
    "the reversal alone": (78643, 78642, 2, (-1, 1, 1)),
}


def _wraps_inside_a_tile(C, R, m, sign, tile=64):
    """Whether some column t's run wraps past C at a q that is not a
    multiple of 64, the kernel's narrowest tile along q (so the wrap falls
    inside a tile at every tile width)."""
    Q = (C - 1) // R + 1
    for t in range(R):
        s = (m * t) % C
        q_wrap = C - s if sign > 0 else s + 1  # the first q whose index wraps
        if 0 < q_wrap < Q and q_wrap % tile:
            return True
    return False


def _planes(rng, B, M, dtype):
    x = rng.standard_normal((B, 1 << M))
    return torch.from_numpy(x).to(dtype) if dtype == torch.float64 else torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("case", list(TWO_PASS_CASES))
def test_two_pass_route_matches_three_references(case, dtype):
    """apply_stride_permute (the offset transpose's plain version, one call
    a leg) against the on-device modular multiply's gather, the old
    composition (_collect_leg, _deal_leg, _negate_mod) and the JAX
    package's apply_stride_permute: equal element for element, at every
    dtype (bf16 moves are exact)."""
    C, a_inv, B, shape = TWO_PASS_CASES[case]
    M = TWO_PASS_M
    plan = modperm.plan_stride_permute(C, a_inv, M)
    jplan = jmodperm.plan_stride_permute(C, a_inv, M, min_factor=256)
    assert (plan.eps, plan.u, plan.v) == shape and interop.plan_from_reference(jplan) == plan
    steps = modperm.legs(plan)
    assert len(steps) == max(1, (plan.u > 1) + (plan.v > 1))
    assert [s[3] for s in steps] == [1] * (len(steps) - 1) + [plan.eps]
    if plan.u > 1 or plan.v > 1:
        assert any(_wraps_inside_a_tile(C, R, m, sign) for R, m, _, sign in steps)
    x = _planes(np.random.default_rng(a_inv), B, M, dtype)
    before = transpose.OFFSET_LAUNCHES
    got = modperm.apply_stride_permute(x, plan)
    assert transpose.OFFSET_LAUNCHES == before  # the CPU runs the plain version
    assert got.dtype == dtype and got.shape == x.shape

    idx = tops.modmul_permute_onchip(a_inv, torch.arange(1 << M), C)
    assert torch.equal(got, x[:, idx])
    old = x
    if plan.v > 1:
        old = modperm._collect_leg(old, C, plan.v, plan.vinv, M)
    if plan.u > 1:
        old = modperm._deal_leg(old, C, plan.u, M, plan.W)
    if plan.eps < 0:
        old = modperm._negate_mod(old, C)
    assert torch.equal(got, old)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else x.numpy().dtype
    want = jmodperm.apply_stride_permute(jnp.asarray(x.float().numpy() if dtype == torch.bfloat16 else x.numpy(), jdtype), jplan)
    np.testing.assert_array_equal(got.float().numpy() if dtype == torch.bfloat16 else got.numpy(), np.asarray(want, np.float32 if dtype == torch.bfloat16 else want.dtype))


@pytest.mark.parametrize("leg", [transpose.COLLECT, transpose.DEAL])
@pytest.mark.parametrize("sign", [1, -1])
def test_offset_leg_is_its_multiplier_permutation(leg, sign):
    """One leg alone: collect with (m, R) is F_{sign m}, deal with (m, R) is
    F_{sign R} (F_k(x)[j] = x[(k j) mod C]), identity above C; R = 1 and
    R near C too."""
    M, C = 14, 12289
    x = _planes(np.random.default_rng(7), 2, M, torch.float32)
    for R in (1, 2, 300, 4093, C - 1):
        m = pow(R, -1, C)
        k = (sign * (m if leg == transpose.COLLECT else R)) % C
        got = transpose.offset_transpose(x, C, R, m, sign, leg)
        assert torch.equal(got, x[:, tops.modmul_permute_onchip(k, torch.arange(1 << M), C)]), R


@pytest.mark.parametrize(
    "what,x,args,error",
    [
        ("float16", torch.zeros((1, 64), dtype=torch.float16), (61, 2, 31, 1, 0), TypeError),
        ("int32", torch.zeros((1, 64), dtype=torch.int32), (61, 2, 31, 1, 0), TypeError),
        ("meta device", torch.empty((1, 64), device="meta"), (61, 2, 31, 1, 0), ValueError),
        ("1-D", torch.zeros(64), (61, 2, 31, 1, 0), ValueError),
        ("not contiguous", torch.zeros((64, 2)).t(), (61, 2, 31, 1, 0), ValueError),
        ("C past the plane", torch.zeros((1, 64)), (65, 2, 33, 1, 0), ValueError),
        ("m R != 1 mod C", torch.zeros((1, 64)), (61, 2, 30, 1, 0), ValueError),
        ("sign 0", torch.zeros((1, 64)), (61, 2, 31, 0, 0), ValueError),
        ("leg 2", torch.zeros((1, 64)), (61, 2, 31, 1, 2), ValueError),
    ],
)
def test_offset_transpose_rejects(what, x, args, error):
    with pytest.raises(error):
        transpose.offset_transpose(x, *args)
