"""The camodc permutation (a fused segment whose every op is a camodc op,
--oracle benes) on the CPU: its case tables against the composition of the
inverse tables, the router (fused.kernel_body) on the Shor plans and on the
shapes it must send elsewhere, and the wrapper's plain version.  The
kernel's descriptor is emulated against the plain Benes stages and the JAX
kernel in tests/test_torch_fused.py (test_camodc_kernel_emulation_matches_
plain_segment); the kernel itself is held on the card by chip_smoke.py and
utils/kernel_checks.py.  Everything here is data movement: held exactly."""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from quantumcomputer_tpu.models.shor_circuit import shor_circuit as jshor_circuit
from quantumcomputer_tpu.ops import pallas_fused as pf
from quantumcomputer_tpu_torch import interop, shor_circuit
from quantumcomputer_tpu_torch.models import circuit as cir
from quantumcomputer_tpu_torch.ops import fused
from quantumcomputer_tpu_torch.ops import gates as tops

DTYPES = (torch.float32, torch.float64, torch.bfloat16)


@st.composite
def camodc_pairs(draw):
    """(M, n, ops): one or two camodc ops on a work register of M in [2, 13]
    bits, each with its own modulus 2^(M-1) < C <= 2^M and multiplier
    coprime to it, controls in either order or on one bit."""
    M = draw(st.integers(2, 13))
    n = M + draw(st.integers(1, 4))
    ops = []
    for _ in range(draw(st.integers(1, 2))):
        C = draw(st.integers(max(3, (1 << (M - 1)) + 1), 1 << M))
        A = draw(st.integers(1, C - 1).filter(lambda a, C=C: math.gcd(a, C) == 1))
        ops.append(("camodc", draw(st.integers(M, n - 1)), C, A))
    return M, n, tuple(ops)


@settings(max_examples=60, deadline=None, database=None)
@given(camodc_pairs())
def test_case_tables_compose_the_inverse_tables(case):
    """Table m - 1 is the gather that applying, in op order, each op whose
    control is bit j of m set makes of a work block; the other rows are
    untouched, and the enumeration counts every changed block once."""
    M, n, ops = case
    positions, log_q, items, tables = fused.permute_descriptor(ops, n, M)
    controls = sorted({op[1] for op in ops})
    assert positions == tuple(c - M for c in controls) and log_q == n - M - len(controls)
    assert tables.shape == ((1 << len(controls)) - 1, max(8, 1 << M)) and tables.dtype == np.uint16
    assert items == 2 * sum(any((b >> p) & 1 for p in positions) for b in range(1 << (n - M)))
    x = np.random.default_rng(M).permutation(1 << M)
    for m in range(1, 1 << len(controls)):
        y = x
        for op in ops:
            if (m >> controls.index(op[1])) & 1:
                y = y[tops.modmul_inverse_permutation(op[2], op[3], M)]
        np.testing.assert_array_equal(x[tables[m - 1, : 1 << M]], y)
        assert not tables[m - 1, 1 << M :].any()


def test_permute_descriptor_takes_camodc_ops_only():
    with pytest.raises(ValueError, match="camodc ops only"):
        fused.permute_descriptor((("camodc", 9, 15, 7), ("u1q", 2, (1.0,) * 8)), 10, 4)
    with pytest.raises(ValueError, match="L register"):
        fused.permute_descriptor((("camodc", 3, 15, 7),), 10, 4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,a,L,M", [(8191, 3, 15, 13), (8187, 13, 17, 13)])
def test_router_sends_every_benes_oracle_segment_to_the_permutation(dtype, C, a, L, M):
    """Every oracle segment of the n = 28 flagship and the n = 30 attempt
    with --oracle benes holds camodc ops only and goes to the camodc
    permutation; the plan's op order is still the JAX package's."""
    n = L + M
    plan = fused.plan_circuit(shor_circuit(C, a, L, M), n, M, fused.TILE_BITS[dtype], fuse_oracle=True,
                              group=fused.groups(dtype, n))
    oracle = [ops for kind, ops, _ in plan if kind == "fused" and any(op[0] == "camodc" for op in ops)]
    assert len(oracle) == (L + 1) // 2
    for ops in oracle:
        assert fused.kernel_body(fused.segment_ops(ops, M, dtype, n)[0], M, dtype, aligned=True) == "permute"
    jplan = pf.plan_circuit(jshor_circuit(C, a, L, M), n, M, fuse_oracle=True)
    assert [op for s in plan for op in s[1]] == [op for s in jplan for op in s[1]]


def test_router_sends_other_shapes_to_the_fused_kernel():
    """Mixed segments (the camodc cases mixed with H gates), planes that are
    not 16-byte aligned and work blocks under 16 bytes take the fused
    kernel's camodc op; a matrix group takes the matrix instance."""
    n = 20
    for M, high, (C, A1, A2) in ((6, (n - 1, n - 2), (33, 29, 7)), (13, (10, 8), (8191, 3, 9))):
        gates = tuple(cir.H(q) for q in high) + (cir.CAMODC(C, A1, n - 3), cir.H(2), cir.CAMODC(C, A2, n - 1))
        for dtype in DTYPES:
            plan = fused.plan_circuit(gates, n, M, fused.TILE_BITS[dtype], fuse_oracle=True)
            assert all(s[0] == "fused" for s in plan)
            assert [fused.kernel_body(ops, M, dtype, aligned=True) for _, ops, _ in plan] == ["segment"] * len(plan)
    pair = (("camodc", 13, 8191, 3), ("camodc", 14, 8191, 9))
    assert [fused.kernel_body(pair, 13, d, aligned=True) for d in DTYPES] == ["permute"] * 3
    assert [fused.kernel_body(pair, 13, d, aligned=False) for d in DTYPES] == ["segment"] * 3
    tiny = (("camodc", 5, 3, 2),)
    assert [fused.kernel_body(tiny, 2, d, aligned=True) for d in DTYPES] == ["permute", "permute", "segment"]
    assert fused.kernel_body((("camodc", 1, 2, 1),), 1, torch.float32, aligned=True) == "segment"
    three = pair + (("camodc", 15, 8191, 27),)
    assert fused.kernel_body(three, 13, torch.float32, aligned=True) == "segment"
    assert fused.kernel_body((("lanemat", 0, True),), 0, torch.bfloat16, aligned=True) == "matmul"
    assert fused.kernel_body((), 0, torch.float32, aligned=True) == "segment"


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_wrapper_takes_the_plain_permutation(dtype):
    """apply_fused on a CPU tensor runs the permutation's plain version in
    place, launches nothing, and equals the plain Benes stages; on planes
    one element into their buffer it takes plain_segment, the same values."""
    n, M = 16, 13
    ops = (("camodc", 13, 8191, 3), ("camodc", 15, 8191, 9))
    planes = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 1 << n))).to(dtype)
    want = fused.plain_segment(planes, ops, M)
    launches = (fused.LAUNCHES, fused.CAMODC_LAUNCHES, fused.PERMUTE_LAUNCHES)
    state = planes.clone()
    assert fused.apply_fused(state, ops, (), M) is state
    assert torch.equal(state, want) and torch.equal(fused.plain_permute(planes, ops, M), want)
    buf = torch.empty(2 * (1 << n) + 1, dtype=dtype)
    shifted = buf[1:].view(2, -1)
    shifted.copy_(planes)
    assert torch.equal(fused.apply_segment(shifted, ops, (), M), want)
    assert (fused.LAUNCHES, fused.CAMODC_LAUNCHES, fused.PERMUTE_LAUNCHES) == launches
    gather = tops.apply_c_amodc_planes_(interop.state_from_numpy(planes.double().numpy()), 8191, 3, 13, M)
    gather = tops.apply_c_amodc_planes_(gather, 8191, 9, 15, M)
    assert torch.equal(want.double(), gather)
