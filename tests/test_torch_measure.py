"""The port's measurement module (quantumcomputer_tpu_torch/ops/measure.py)
against the JAX package's pallas_measure, on the same seeded states and the
same draws.

The JAX block-sum kernel runs in interpret mode on the CPU, as
tests/test_pallas_measure.py runs it; the port runs its plain block sums (the
CUDA kernel's spec).  The CUDA kernel itself is tested only on a card."""

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
    assert measure.block_geom(1 << 31) == pm._block_geom(1 << 31)
    with pytest.raises(ValueError):
        measure.block_geom(1 << 32)


def test_wrapper_takes_plain_version_only_on_cpu():
    state = interop.state_from_numpy(_planes(16, 4))
    before = measure.LAUNCHES
    torch.testing.assert_close(measure.block_sums(state), measure.block_sums_plain(state), rtol=0, atol=0)
    assert measure.LAUNCHES == before
    with pytest.raises(ValueError, match="no block-sum path"):
        measure.block_sums(torch.empty((2, 1 << 16), device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the block-sums kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    state = interop.state_from_numpy(_planes(20, 6, decay=True), cuda_device).to(dtype)
    before = measure.LAUNCHES
    got = measure.block_sums(state)
    assert measure.LAUNCHES == before + 1
    torch.testing.assert_close(got, measure.block_sums_plain(state), rtol=0, atol=ATOL)
