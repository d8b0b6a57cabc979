"""The port's sharded semiclassical attempt
(quantumcomputer_tpu_torch/parallel/sharded_semiclassical.py) against the
JAX package's run_semiclassical_sharded on the 8 forced host devices and
against the port's single-device attempt, with the same draws.

Bits equal; branch probabilities within 5e-6 at complex64 and 1e-4 at
complex32 (tests/test_sharded_semiclassical.py's bounds); the host lattice
counts and capacities exactly equal to the JAX package's and to brute
force."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.algorithms import semiclassical as jsc
from quantumcomputer_tpu.parallel import mesh as jmesh
from quantumcomputer_tpu.parallel import sharded_semiclassical as jss
from quantumcomputer_tpu_torch.algorithms import number_theory as nt
from quantumcomputer_tpu_torch.algorithms import semiclassical as sc
from quantumcomputer_tpu_torch.parallel import sharded_semiclassical as ss
from quantumcomputer_tpu_torch.parallel.mesh import build_mesh

TOL = {torch.complex64: 5e-6, "complex32": 1e-4}
JAX_DTYPE = {torch.complex64: jnp.complex64, "complex32": "complex32"}


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


def _brute_max_bin_load(b, C, M, d):
    D, ls = 1 << d, 1 << (M - d)
    s = np.arange(1 << M)
    w = np.where(s < C, (np.int64(b) * s) % C, s)
    best = 0
    for e in range(D):
        blk = slice(e * ls, (e + 1) * ls)
        mask = s[blk] < C
        best = max(best, int(np.bincount(w[blk][mask] >> (M - d), minlength=D).max()))
    return best


@pytest.mark.parametrize(
    "b,C,M,d",
    [(2, 21, 5, 2), (7, 21, 5, 2), (20, 21, 5, 2), (1, 15, 4, 1), (3, 8191, 13, 3), (8190, 8191, 13, 3),
     (16, 1019 * 1021, 20, 3), (2, 33, 6, 3), (65536, 1019 * 1021, 20, 2)],
)
def test_lattice_counts_are_exact_and_match_jax(b, C, M, d):
    got = ss.max_bin_load(b, C, M, d)
    assert got == jss.max_bin_load(b, C, M, d) == _brute_max_bin_load(b, C, M, d)


def test_exchange_capacity_covers_smooth_multipliers():
    C, M, d = 1019 * 1021, 20, 3
    ls = 1 << (M - d)
    pows = [pow(2, 1 << j, C) for j in range(8)]
    cap = ss.exchange_capacity(pows, C, M, d)
    assert cap == jss.exchange_capacity(pows, C, M, d)
    assert cap >= ss.max_bin_load(2, C, M, d) >= ls // 2 and cap & (cap - 1) == 0
    assert ss.exchange_capacity([1, 1], 15, 4, 2) == jss.exchange_capacity([1, 1], 15, 4, 2)


def _jax_draws(key, L):
    return np.asarray(jax.random.uniform(key, (L,), dtype=jnp.float32))


@pytest.mark.parametrize(
    "C,a,L,M,d",
    [(15, 2, 6, 4, 2), (15, 7, 5, 4, 1), (21, 2, 7, 5, 3), (33, 29, 6, 6, 3), (8191, 3, 10, 13, 3)],
    ids=["multiplier_one_steps", "minimal_mesh", "smooth_multipliers", "identity_region", "prime_13_bits"],
)
@pytest.mark.parametrize("dtype", [torch.complex64, "complex32"])
def test_sharded_matches_jax_and_the_single_device(C, a, L, M, d, dtype):
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        want = jss.run_semiclassical_sharded(C, a, L, M, key, jmesh.build_mesh(1 << d), dtype=JAX_DTYPE[dtype])
        rs = _jax_draws(key, L)
        got = ss.run_semiclassical_sharded(C, a, L, M, rs, build_mesh(1 << d), dtype=dtype)
        single = sc.run_semiclassical(C, a, L, M, rs, dtype=dtype, device="cpu")
        assert got.bits == want.bits == single.bits
        assert (got.x_tilde, got.omega) == (want.x_tilde, want.omega)
        np.testing.assert_allclose(got.branch_probs, want.branch_probs, atol=TOL[dtype])
        np.testing.assert_allclose(got.branch_probs, single.branch_probs, atol=TOL[dtype])
        assert got.overflow == 0 and len(got.exchange_bytes) == L
        assert got.capacity == jss.exchange_capacity([pow(a, 1 << j, C) for j in range(L)], C, M, d)


def test_forced_branches_match_jax():
    C, a, L, M = 21, 2, 6, 5
    for forced in ([0] * 6, [1] * 6, [1, 0, 1, 1, 0, 1]):
        want = jss.run_semiclassical_sharded(C, a, L, M, jax.random.PRNGKey(0), jmesh.build_mesh(4), forced_bits=forced)
        got = ss.run_semiclassical_sharded(C, a, L, M, np.zeros(L, np.float32), build_mesh(4), forced_bits=forced)
        assert got.bits == want.bits == forced
        np.testing.assert_allclose(got.branch_probs, want.branch_probs, atol=5e-6)


def test_exchange_moves_amplitudes_only_at_bf16_half_the_bytes():
    """One all_to_all a step whose multiplier is not 1 (none where it is),
    of D * cap slots a shard, bf16 at complex32: half the complex64 bytes."""
    C, a, L, M, d = 15, 2, 6, 4, 2
    r64 = ss.run_semiclassical_sharded(C, a, L, M, np.full(L, 0.5, np.float32), build_mesh(4))
    r32 = ss.run_semiclassical_sharded(C, a, L, M, np.full(L, 0.5, np.float32), build_mesh(4), dtype="complex32")
    D, cap = 1 << d, r64.capacity
    pows = [pow(a, 1 << (L - 1 - s), C) for s in range(L)]
    # The psums of p0 and p1 each step, then the exchange where b != 1.
    psums = 2 * (D - 1) * D * 4
    assert r64.exchange_bytes == [psums + (D * (D - 1) * 2 * cap * 4 if b != 1 else 0) for b in pows]
    assert [x - psums for x in r32.exchange_bytes] == [(x - psums) // 2 for x in r64.exchange_bytes]
    assert r64.oracles.count("identity") == pows.count(1) > 0


def test_large_modulus_factors_through_the_mesh():
    C, a, L, M = 1019 * 1021, 2, 40, 20
    rs = _jax_draws(jax.random.PRNGKey(0), L)
    rec = ss.run_semiclassical_sharded(C, a, L, M, rs, build_mesh(8))
    period = nt.find_period_from_omega(rec.omega, a, C)
    assert period is not None and pow(a, period, C) == 1
    f = np.gcd(pow(a, period // 2, C) - 1, C)
    assert 1 < f < C and C % f == 0


@pytest.mark.parametrize(
    "args",
    [(33, 2, 4, 5, 4), ((1 << 30) + 1, 2, 4, 31, 4), (15, 7, 53, 4, 4), (15, 5, 4, 4, 4), (5, 2, 4, 3, 8)],
    ids=["not_unitary", "shift_add", "mantissa", "coprime", "too_small"],
)
def test_bounds_raise_the_jax_messages(args):
    C, a, L, M, D = args
    with pytest.raises(ValueError) as want:
        jss.run_semiclassical_sharded(C, a, L, M, jax.random.PRNGKey(0), jmesh.build_mesh(D))
    with pytest.raises(ValueError) as got:
        ss.run_semiclassical_sharded(C, a, L, M, np.zeros(L, np.float32), build_mesh(D))
    assert str(got.value) == str(want.value)


def test_memory_gate_counts_the_shards_on_one_device(monkeypatch):
    monkeypatch.setenv("QC_TPU_HBM_BYTES", str(1 << 20))  # a 1 MiB device
    assert not ss.sharded_attempt_fits(20, torch.float32, build_mesh(4))
    assert ss.sharded_attempt_fits(12, torch.float32, build_mesh(4))
    # 4 shards of (2, 2^14) float32 = 128 KiB each, 6 buffers each: 3 MiB on the one
    # device, which the JAX gate, one shard a device, would pass (768 KiB).
    assert jss.sharded_attempt_fits(16, jnp.float32, 2)
    assert not ss.sharded_attempt_fits(16, torch.float32, build_mesh(4))
    assert ss.sharded_attempt_fits(14, torch.float32, build_mesh(1))  # 6 x 128 KiB
    with pytest.raises(ValueError, match="exceeds the .* device budget"):
        ss.run_semiclassical_sharded(64901, 2, 4, 17, np.zeros(4, np.float32), build_mesh(4))


def test_find_period_semiclassical_on_a_mesh():
    """mesh= runs the sharded attempt; checkpointing and dd64 on a mesh
    raise the JAX package's messages."""
    rs = _jax_draws(jax.random.PRNGKey(3), 4)
    period, rec = sc.find_period_semiclassical(15, 7, 4, 4, rs, mesh=build_mesh(4))
    want = ss.run_semiclassical_sharded(15, 7, 4, 4, rs, build_mesh(4))
    assert rec.bits == want.bits and period == nt.find_period_from_omega(rec.omega, 7, 15)
    for kw in ({"checkpoint_dir": "ck"}, {"dtype": "dd64"}):
        with pytest.raises(ValueError) as w:
            jsc.find_period_semiclassical(15, 7, 4, 4, jax.random.PRNGKey(0), mesh=jmesh.build_mesh(4), **kw)
        with pytest.raises(ValueError) as g:
            sc.find_period_semiclassical(15, 7, 4, 4, rs, mesh=build_mesh(4), **kw)
        assert str(g.value) == str(w.value)
