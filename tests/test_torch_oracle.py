"""The port's m_high oracle module (quantumcomputer_tpu_torch/ops/oracle.py
and the plain ops in ops/gates.py) against the JAX package's
ops/pallas_oracle.py and ops/gates.py, on the same seeded inputs.

Schedules, multipliers and eligibility must be equal, value for value, so
the port plans what the JAX package plans.  The plain versions are held to
the JAX XLA ops at 1e-12 in complex128; each JAX Pallas oracle kernel runs
once in interpret mode, as the JAX suite runs it, and the port's wrapper
(its plain version, on a CPU tensor) must equal it within that suite's
1e-6 at f32.  The CUDA kernels are held against their plain versions on the
card by chip_smoke.py and quantumcomputer_tpu_torch/utils/kernel_checks.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.ops import gates as xops
from quantumcomputer_tpu.ops import pallas_oracle as po
from quantumcomputer_tpu_torch import interop
from quantumcomputer_tpu_torch.algorithms import _native
from quantumcomputer_tpu_torch.ops import gates as tops
from quantumcomputer_tpu_torch.ops import oracle

ATOL_PALLAS = 1e-6  # tests/test_mhigh_layout.py


def _psi(rng, n):
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return psi / np.linalg.norm(psi)


def _planes32(psi):
    return np.stack([psi.real, psi.imag]).astype(np.float32)


# (C, A, M): fixed points (0 and j >= C), short cycles (C = 15) and long
# ones (3 has order 910 mod 8191, 3^512 order 455).
SCHEDULE_CASES = [(15, 7, 4), (21, 2, 5), (33, 29, 6), (35, 12, 6), (8191, 3, 13), (8191, 3 ** 512 % 8191, 13)]


@pytest.mark.parametrize("C,A,M", SCHEDULE_CASES)
def test_cycle_schedule_matches_jax(C, A, M, monkeypatch):
    ginv = np.asarray(xops.modmul_inverse_permutation(C, A, M), np.int32)
    want = po.cycle_schedule(ginv)
    for arr, ref in zip(oracle.cycle_schedule(ginv), want):
        np.testing.assert_array_equal(arr, ref)
    monkeypatch.setattr(_native, "available", lambda: False)  # the Python walk
    for arr, ref in zip(oracle.cycle_schedule(ginv), want):
        np.testing.assert_array_equal(arr, ref)


@pytest.mark.parametrize("C,A_list", [(21, (2, 4, 16)), (15, (7, 4, 1, 1)), (8191, tuple(pow(3, 1 << j, 8191) for j in range(8)))])
def test_combo_multipliers_match_jax(C, A_list, monkeypatch):
    want = xops.modexp_combo_multipliers(C, A_list)
    np.testing.assert_array_equal(tops.modexp_combo_multipliers(C, A_list), want)
    monkeypatch.setattr(_native, "available", lambda: False)
    np.testing.assert_array_equal(tops.modexp_combo_multipliers(C, A_list), want)


def test_mask_multipliers_are_the_pair_schedules_of_jax():
    C, A_pair, M = 33, (29, 7), 6
    combos = xops.modexp_combo_multipliers(C, list(A_pair))
    f = np.arange(1 << M, dtype=np.int32)
    want = [np.where(f < C, (int(combos[m]) * f) % C, f) for m in (1, 2, 3)]
    np.testing.assert_array_equal(oracle.mask_multipliers(C, A_pair, M), np.stack(want))
    np.testing.assert_array_equal(
        oracle.mask_multipliers(C, (29,), M)[0], xops.modmul_inverse_permutation(C, 29, M)
    )


def test_predicates_match_jax():
    for itemsize in (2, 4, 8):
        for M in (2, 3, 4, 6, 13, 16):
            for n in range(M + 1, M + 19):
                for c in range(0, n - M):
                    assert oracle.perm_supported(c, M, n, itemsize) == po.perm_supported(c, M, n, itemsize)
                    assert oracle.pair_member_supported(c, M, n, itemsize) == po.pair_member_supported(c, M, n, itemsize)
                    for controls in ((c,), (c, c + 1), (c, c + 3, c + 1), tuple(range(c, c + 9))):
                        assert oracle.ladder_high_supported(controls, M, n, itemsize) == po.ladder_high_supported(
                            controls, M, n, itemsize
                        )
                    for pair in ((c, c + 1), (c + 2, c), (c, c)):
                        assert oracle.pair_inplace_supported(pair, M, n, itemsize) == po.pair_inplace_supported(
                            pair, M, n, itemsize
                        )


@pytest.mark.parametrize("c_phys", [0, 1, 3, 6, 9, 10])
def test_plain_camodc_high_matches_xla(c_phys):
    C, A, M, n = 33, 29, 6, 17
    psi = _psi(np.random.default_rng(c_phys), n)
    want = np.asarray(xops.apply_camodc_high(jnp.asarray(psi), C, A, c_phys, M))
    got = tops.apply_camodc_high(torch.from_numpy(psi), C, A, c_phys, M)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
    planar = interop.state_from_numpy(np.stack([psi.real, psi.imag]))
    out = tops.apply_camodc_high_planes_(planar, C, A, c_phys, M)
    assert out is planar
    np.testing.assert_allclose(out[0].numpy() + 1j * out[1].numpy(), want, atol=1e-12)


@pytest.mark.parametrize("controls", [(0, 1, 2), (3, 5), (9, 10, 11, 12, 13, 14, 15, 16), (16, 2)])
def test_plain_ladder_matches_xla(controls):
    C, a, M, n = 33, 7, 6, 17
    A_list = tuple(pow(a, 1 << k, C) for k in range(len(controls)))
    psi = _psi(np.random.default_rng(len(controls)), n)
    want = np.asarray(xops.apply_camodc_ladder_high(jnp.asarray(psi), C, A_list, controls, M))
    got = tops.apply_camodc_ladder_high(torch.from_numpy(psi), C, A_list, controls, M)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
    planar = interop.state_from_numpy(np.stack([psi.real, psi.imag]))
    out = tops.apply_camodc_ladder_high_planes_(planar, C, A_list, controls, M)
    np.testing.assert_allclose(out[0].numpy() + 1j * out[1].numpy(), want, atol=1e-12)


def test_cycle_matches_pallas_interpret():
    C, A, c_phys, M, n = 33, 29, 3, 6, 16
    psi = _psi(np.random.default_rng(31), n)
    planes = _planes32(psi)
    jre, jim = po.apply_camodc_high_cycle_planar(jnp.asarray(planes[0]), jnp.asarray(planes[1]), C, A, c_phys, M)
    got = oracle.apply_camodc_high_cycle_planar(interop.state_from_numpy(planes), C, A, c_phys, M)
    np.testing.assert_allclose(interop.state_to_numpy(got), np.stack([jre, jim]), atol=ATOL_PALLAS)


def test_perm_matches_pallas_interpret():
    C, A, c_phys, M, n = 33, 29, 13, 6, 20
    assert oracle.perm_supported(c_phys, M, n)
    psi = _psi(np.random.default_rng(32), n)
    planes = _planes32(psi)
    jre, jim = po.apply_camodc_high_perm_planar(jnp.asarray(planes[0]), jnp.asarray(planes[1]), C, A, c_phys, M)
    got = oracle.apply_camodc_high_perm_planar(interop.state_from_numpy(planes), C, A, c_phys, M)
    np.testing.assert_allclose(interop.state_to_numpy(got), np.stack([jre, jim]), atol=ATOL_PALLAS)


def test_pair_matches_pallas_interpret():
    C, A_pair, controls, M, n = 33, (29, 7), (13, 14), 6, 21
    assert oracle.pair_inplace_supported(controls, M, n)
    psi = _psi(np.random.default_rng(33), n)
    planes = _planes32(psi)
    jre, jim = po.apply_camodc_pair_inplace_planar(
        jnp.asarray(planes[0]), jnp.asarray(planes[1]), C, A_pair, controls, M
    )
    got = oracle.apply_camodc_pair_inplace_planar(interop.state_from_numpy(planes), C, A_pair, controls, M)
    np.testing.assert_allclose(interop.state_to_numpy(got), np.stack([jre, jim]), atol=ATOL_PALLAS)


def test_ladder_matches_pallas_interpret():
    C, A_list, controls, M, n = 15, (7, 4), (11, 12), 4, 17
    assert oracle.ladder_high_supported(controls, M, n)
    psi = _psi(np.random.default_rng(34), n)
    planes = _planes32(psi)
    jre, jim = po.apply_camodc_ladder_high_planar(
        jnp.asarray(planes[0]), jnp.asarray(planes[1]), C, A_list, controls, M
    )
    state = interop.state_from_numpy(planes)
    before = state.clone()
    out = torch.empty_like(state)
    got = oracle.apply_camodc_ladder_high_planar(state, out, C, A_list, controls, M)
    assert got is out
    assert torch.equal(state, before)  # out of place: the input is untouched
    np.testing.assert_allclose(interop.state_to_numpy(got), np.stack([jre, jim]), atol=ATOL_PALLAS)


def test_wrappers_take_plain_versions_only_on_cpu():
    C, M, n = 15, 4, 12
    planes = _planes32(_psi(np.random.default_rng(35), n))
    before = dict(oracle.LAUNCHES)
    calls = [
        lambda s: oracle.apply_camodc_high_cycle_planar(s, C, 7, 2, M),
        lambda s: oracle.apply_camodc_high_perm_planar(s, C, 7, 5, M),
        lambda s: oracle.apply_camodc_pair_inplace_planar(s, C, (7, 4), (5, 1), M),
    ]
    for call in calls:
        state = interop.state_from_numpy(planes)
        assert call(state) is state  # in place
    out = torch.empty((2, 1 << n))
    oracle.apply_camodc_ladder_high_planar(interop.state_from_numpy(planes), out.float(), C, (7, 4), (5, 1), M)
    assert oracle.LAUNCHES == before  # no kernel launched for CPU tensors
    meta = torch.empty((2, 1 << n), device="meta")
    for call in calls:
        with pytest.raises(ValueError, match="no .* path for device meta"):
            call(meta)


def test_wrappers_validate_their_arguments():
    state = interop.state_from_numpy(_planes32(_psi(np.random.default_rng(36), 10)))
    with pytest.raises(ValueError, match="1..8 gates"):
        oracle.apply_camodc_ladder_high_planar(state, torch.empty_like(state), 2, (1,) * 9, tuple(range(9)), 1)
    with pytest.raises(ValueError, match="not unitary"):
        oracle.apply_camodc_high_cycle_planar(state, 33, 7, 0, 4)  # 2^4 < 33
    with pytest.raises(ValueError, match="column bits"):
        oracle.apply_camodc_high_cycle_planar(state, 15, 7, 6, 4)  # bit 6 is a work-register bit
    with pytest.raises(ValueError, match="distinct controls"):
        oracle.apply_camodc_pair_inplace_planar(state, 15, (7, 4), (2, 2), 4)
    with pytest.raises(ValueError, match="distinct contiguous buffer"):
        oracle.apply_camodc_ladder_high_planar(state, state, 15, (7, 4), (1, 2), 4)


# ---------------------------------------------------------------------------
# The segmented walk (csrc/oracle_cycle.cu), emulated on the CPU from the
# host's schedules and segments: the cut rows copied first, then whole
# segments in any order, must give x[ginv] on the moved columns exactly.


def _emulate_walk(x, cols, sched, segs, order):
    """Walk each segment of `segs` in `order` over the columns `cols` of the
    (rows, rest) array x, in place, as a kernel thread does."""
    out_row, src_row, kind = sched
    cut = {s: (x[a, cols].copy() if a >= 0 else None, x[b, cols].copy() if b >= 0 else None)
           for s, (_, _, a, b, *_r) in enumerate(segs)}
    for s in order:
        t0, t1, a_row, _, head_row = (int(v) for v in segs[s][:5])
        pending, pending_row = cut[s][1], head_row
        for t in range(t0, t1):
            if kind[t] == 2:
                continue
            val = cut[s][0] if (t == t1 - 1 and a_row >= 0) else x[src_row[t], cols].copy()
            if kind[t] == 1:
                pending, pending_row = val, out_row[t]
                continue
            x[out_row[t], cols] = val
            if kind[t] == 3:
                x[pending_row, cols] = pending


def _perm(name, rows):
    j = np.arange(rows)
    if name == "fixed_points":  # a few swaps, the rest fixed
        g = j.copy()
        g[[1, 5]], g[[9, 2]] = g[[5, 1]], g[[2, 9]]
        return g
    if name == "two_cycles":
        return j ^ 1
    return (j + 1) % rows  # one cycle through all rows


WALK_PERMS = [
    ("fixed_points", None), ("two_cycles", None), ("one_cycle", None),
    ("flagship", (3,)), ("flagship", (3 ** 512 % 8191,)), ("flagship_pair", (3, 9)),
]


@pytest.mark.parametrize("S", [1, 2, 3, 7, 16, "rows"])
@pytest.mark.parametrize("perm,A", WALK_PERMS, ids=[f"{p}-{a}" for p, a in WALK_PERMS])
def test_segmented_walk_is_exact_in_any_order(perm, A, S):
    """Forward, reversed and three seeded random segment orders all give
    x[:, ginv] on the moved columns exactly and leave the others alone: the
    single-gate form (one mask) and the pair (three masks) alike."""
    if perm.startswith("flagship"):
        C, M = 8191, 13
        ginvs = oracle.mask_multipliers(C, A, M)
    else:
        M = 6
        ginvs = [_perm(perm, 1 << M)]
    rows, rest = 1 << M, 8
    controls = (1, 2) if len(ginvs) == 3 else (1,)
    col = np.arange(rest)
    mask = sum(((col >> c) & 1) << k for k, c in enumerate(controls))
    S = rows if S == "rows" else S
    rng = np.random.default_rng(rows + S)
    x0 = rng.standard_normal((rows, rest))
    want = x0.copy()
    for m, g in enumerate(ginvs, start=1):
        want[:, mask == m] = x0[g][:, mask == m]
    scheds = [oracle.cycle_schedule(np.asarray(g, np.int32)) for g in ginvs]
    segs = [oracle.walk_segments(*sched, S) for sched in scheds]
    for seg in segs:
        assert [int(v) for v in seg[:, 0]] == [s * rows // S for s in range(S)]
    orders = [range(S), range(S - 1, -1, -1)] + [np.random.default_rng(seed).permutation(S) for seed in range(3)]
    for order in orders:
        x = x0.copy()
        for m, (sched, seg) in enumerate(zip(scheds, segs), start=1):  # masks move disjoint columns
            _emulate_walk(x, mask == m, sched, seg, order)
        np.testing.assert_array_equal(x, want)


def test_walk_segment_count_fills_the_card():
    # n = 28, M = 13: a lone gate moves 2^14 columns a plane, 4 per thread in f32.
    assert oracle.walk_segment_count(1 << 13, 1 << 14, 1, 4) == 32
    assert oracle.walk_segment_count(1 << 13, 1 << 13, 3, 4) == 16  # the pair
    assert oracle.walk_segment_count(1 << 13, 1 << 14, 1, 1) == 8  # control 0 or 1: one column a thread
    assert oracle.walk_segment_count(1 << 13, 1 << 16, 1, 4) == 8  # n = 30
    assert oracle.walk_segment_count(1 << 4, 1 << 3, 1, 1) == 1  # too few steps to cut
    state = torch.zeros((2, 1 << 10))
    assert oracle.walk_vector(state, (3,)) == 4 and oracle.walk_vector(state, (2,)) == 1  # runs of 32 / 16 bytes
    assert oracle.walk_vector(state.double(), (2, 5)) == 2 and oracle.walk_vector(state.double(), (1, 5)) == 1
