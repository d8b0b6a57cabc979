"""The port's measurement module (quantumcomputer_tpu_torch/ops/measure.py)
against the JAX package's pallas_measure, on the same seeded states and the
same draws.

The JAX block-sum kernel runs in interpret mode on the CPU, as
tests/test_pallas_measure.py runs it; the port runs its plain block sums (the
CUDA kernel's spec).  The CUDA kernel is held against it on the card by
chip_smoke.py and quantumcomputer_tpu_torch/utils/kernel_checks.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.ops import gates as xops
from quantumcomputer_tpu.ops import pallas_measure as pm
from quantumcomputer_tpu_torch import interop
from quantumcomputer_tpu_torch.ops import gates as tops
from quantumcomputer_tpu_torch.ops import measure

ATOL = 1e-6  # tests/test_pallas_measure.py block-sum tolerance
EDGE = 1e-5  # a draw this close to a cumulative boundary is knife-edge


def _planes(n, seed, decay=False):
    """Seeded state: low noise plus 48 spikes that carry most of the
    probability, so most draws land well inside one spike's band."""
    rng = np.random.default_rng(seed)
    psi = 1e-2 * rng.standard_normal((2, 1 << n))
    psi[:, rng.choice(1 << n, 48, replace=False)] += rng.standard_normal((2, 48))
    if decay:  # uneven block weights, so the block pick matters
        psi *= np.exp(-np.arange(1 << n) / float(1 << (n - 2)))
    return (psi / np.sqrt(np.sum(psi * psi))).astype(np.float32)


@pytest.mark.parametrize("n", [16, 17])
def test_block_sums_match_pallas(n):
    planes = _planes(n, n, decay=True)
    want = np.asarray(pm.block_prob_sums_planes(jnp.asarray(planes[0]), jnp.asarray(planes[1])))
    got = measure.block_sums_plain(interop.state_from_numpy(planes))
    assert measure.block_geom(1 << n) == pm._block_geom(1 << n)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _clear_draws(planes, draws):
    """Draws whose f64 inverse-CDF index is not knife-edge, with that index."""
    cum = np.cumsum(planes[0].astype(np.float64) ** 2 + planes[1].astype(np.float64) ** 2)
    out = []
    for r in draws:
        target = r * cum[-1]
        i = int(np.searchsorted(cum, target, side="left"))
        lo = cum[i - 1] if i > 0 else 0.0
        if target - lo > EDGE and cum[i] - target > EDGE:
            out.append((float(r), i))
    return out


@pytest.mark.parametrize("n", [16, 17])
def test_hierarchical_sample_matches_pallas(n):
    planes = _planes(n, 100 + n, decay=True)
    draws = np.random.default_rng(n).uniform(size=24)
    clear = _clear_draws(planes, draws)
    assert len(clear) >= 12
    state = interop.state_from_numpy(planes)
    jax_sample = jax.jit(pm.sample_index_planes)
    for r, want in clear:
        got_jax = int(jax_sample(jnp.asarray(planes[0]), jnp.asarray(planes[1]), jnp.float32(r)))
        got = measure.sample_index_planes(state, r)
        assert got == got_jax == want, (r, got, got_jax, want)
        assert measure.sample_index(state, r) == want  # the engine's switch takes this path


def test_flat_path_below_hierarchical_size():
    n = 12
    planes = _planes(n, 5)
    state = interop.state_from_numpy(planes)
    for r, want in _clear_draws(planes, np.random.default_rng(1).uniform(size=16)):
        assert measure.sample_index_flat(state, r) == want
        assert measure.sample_index(state, r) == want
        z = planes[0] + 1j * planes[1]
        jax_idx = int(xops.sample_index(jnp.asarray(z, jnp.complex64), jnp.float32(r)))
        assert tops.sample_index(torch.from_numpy(z.astype(np.complex64)), r) == jax_idx == want


def test_float64_states_sample_flat():
    planes = _planes(16, 9).astype(np.float64)
    state = interop.state_from_numpy(planes)
    before = measure.LAUNCHES
    for r, want in _clear_draws(planes, np.random.default_rng(2).uniform(size=8)):
        assert measure.sample_index(state, r) == want
    assert measure.LAUNCHES == before


def test_draw_is_scaled_by_the_total():
    """A norm-deficient state: an unscaled draw above the total would fall
    through to the last index; both samplers scale it by the total."""
    planes = _planes(16, 3) * np.float32(0.5)
    state = interop.state_from_numpy(planes)
    r, want = _clear_draws(planes, np.linspace(0.6, 0.99, 40))[-1]
    assert measure.sample_index_planes(state, r) == want
    assert measure.sample_index_flat(state, r) == want
    assert want < (1 << 16) - 1


def test_block_geom_index_budget():
    """Up to the JAX package's 2^31 budget both packages cut the same
    blocks; past it (where the JAX package raises) the port keeps the rule:
    1024 blocks of 2^22 amplitudes at n = 32, indices past int32."""
    for n in range(16, 32):
        assert measure.block_geom(1 << n) == pm._block_geom(1 << n)
    with pytest.raises(ValueError):
        pm._block_geom(1 << 32)
    assert measure.block_geom(1 << 32) == (1 << 15, 1 << 22)
    assert (1 << 32) // measure.block_geom(1 << 32)[1] == measure.MAX_BLOCKS


def test_wrapper_takes_plain_version_only_on_cpu():
    state = interop.state_from_numpy(_planes(16, 4))
    before = measure.LAUNCHES
    torch.testing.assert_close(measure.block_sums(state), measure.block_sums_plain(state), rtol=0, atol=0)
    assert measure.LAUNCHES == before
    with pytest.raises(ValueError, match="no block-sum path"):
        measure.block_sums(torch.empty((2, 1 << 16), device="meta"))


@pytest.mark.parametrize("n", [16, 17])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_float64_scan_past_the_index_budget(n, dtype):
    """The path a state past 2^31 amplitudes takes (block sums taken to
    float64, the draw, the block pick and the in-block scan in float64),
    driven at n = 16, 17 through float64_above: every clear draw gets the
    plain float64 inverse CDF's index, alone and in a batch, at float32 and
    bf16 planes."""
    planes = _planes(n, 200 + n, decay=True)
    state = interop.state_from_numpy(planes)
    if dtype == "bf16":
        state = state.to(torch.bfloat16)
        planes = state.to(torch.float64).numpy()
    clear = _clear_draws(planes, np.random.default_rng(n + 7).uniform(size=40))
    assert len(clear) >= 20
    draws, want = [r for r, _ in clear], [i for _, i in clear]
    got = measure.sample_indices_planes(state, draws, float64_above=1 << 12)
    assert got.dtype == torch.int64 and got.tolist() == want
    assert [int(measure.sample_indices_planes(state, [r], float64_above=1 << 12)[0]) for r in draws] == want


def test_float64_scan_only_past_the_budget():
    """At the default bound a state of 2^n <= 2^31 amplitudes keeps the
    float32 scan: a knife-edge draw of the float32 block scan keeps its
    float32 index, which the float64 path moves."""
    planes = _planes(16, 31, decay=True)
    state = interop.state_from_numpy(planes)
    sums = measure.block_sums_plain(state)
    cum32 = torch.cumsum(sums, 0)
    moved = 0
    for b in range(cum32.shape[0] - 1):
        r = float(cum32[b] / cum32[-1])
        lo, hi = np.nextafter(np.float32(r), np.float32(0)), np.nextafter(np.float32(r), np.float32(1))
        for x in (float(lo), r, float(hi)):
            f32 = int(measure.sample_indices_planes(state, [x])[0])
            assert int(measure.sample_index(state, x)) == f32
            moved += f32 != int(measure.sample_indices_planes(state, [x], float64_above=1 << 12)[0])
    assert moved > 0


def test_sample_geometry():
    assert measure.sample_geometry(torch.zeros((2, 1 << 16))) == (1 << 16 >> 13, 1 << 13)
    assert measure.sample_geometry(torch.zeros((2, 1 << 12))) == (1, 1 << 12)
    assert measure.sample_geometry(torch.zeros((2, 1 << 16), dtype=torch.float64)) == (1, 1 << 16)
