"""The port's out-of-place row-gather oracle (ops/oracle.apply_camodc_high_planar,
csrc/oracle_gather.cu) against the JAX package's blocked row gather
(ops/pallas_oracle.apply_camodc_high_planar, its _kernel in interpret mode).

The JAX kernel only moves data, so the port's plain version must equal it
exactly at f32.  The JAX suite's geometry (n = 17, M = 6, rest = 2048) only
reaches the kernel's mixed blocks: a pure block needs 2^c >= cb2 * 128, which
at rest = 2048 no column bit reaches.  n = 21 (rest = 2^15, cb2 = 128) with
c = 14 takes the pure path, c = 13 the mixed one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.ops import pallas_oracle as po
from quantumcomputer_tpu_torch import interop
from quantumcomputer_tpu_torch.ops import oracle

C, A, M = 33, 29, 6


def _planes32(rng, n):
    psi = rng.standard_normal((2, 1 << n))
    return (psi / np.linalg.norm(psi)).astype(np.float32)


def _jax_gather(planes, c_phys):
    ore, oim = po.apply_camodc_high_planar(jnp.asarray(planes[0]), jnp.asarray(planes[1]), C, A, c_phys, M)
    return np.stack([np.asarray(ore), np.asarray(oim)])


@pytest.mark.parametrize(
    "n,c_phys", [(17, 0), (17, 3), (17, 6), (17, 9), (17, 10), (21, 13), (21, 14)]
)
def test_plain_gather_equals_the_pallas_kernel(n, c_phys):
    cb2 = min(po.MAX_CB2, (1 << (n - M)) // po.LANE)
    assert ((1 << c_phys) >= cb2 * po.LANE) == (n == 21 and c_phys == 14)  # the pure path, once
    planes = _planes32(np.random.default_rng(100 * n + c_phys), n)
    want = _jax_gather(planes, c_phys)
    state = interop.state_from_numpy(planes)
    before = state.clone()
    out = torch.empty_like(state)
    got = oracle.apply_camodc_high_planar(state, out, C, A, c_phys, M)
    assert got is out
    assert torch.equal(state, before)  # out of place: the input is untouched
    np.testing.assert_array_equal(interop.state_to_numpy(got), want)


def test_gather_on_cpu_launches_nothing():
    planes = _planes32(np.random.default_rng(7), 17)
    before = dict(oracle.LAUNCHES)
    state = interop.state_from_numpy(planes)
    oracle.apply_camodc_high_planar(state, torch.empty_like(state), C, A, 4, M)
    assert oracle.LAUNCHES == before
    meta = torch.empty((2, 1 << 17), device="meta")
    with pytest.raises(ValueError, match="no gather path for device meta"):
        oracle.apply_camodc_high_planar(meta, torch.empty_like(meta), C, A, 4, M)


def test_gather_validates_its_arguments():
    state = interop.state_from_numpy(_planes32(np.random.default_rng(8), 15))
    out = torch.empty_like(state)
    with pytest.raises(ValueError, match="M too small"):
        oracle.apply_camodc_high_planar(state, out, 3, 2, 0, 2)  # 2^2 = 4 rows < 8
    with pytest.raises(ValueError, match="too short"):
        oracle.apply_camodc_high_planar(state, out, C, A, 0, M)  # rest = 512 < 1024
    state = interop.state_from_numpy(_planes32(np.random.default_rng(9), 17))
    out = torch.empty_like(state)
    with pytest.raises(ValueError, match="column bits"):
        oracle.apply_camodc_high_planar(state, out, C, A, 11, M)  # bit 11 is a work-register bit
    with pytest.raises(ValueError, match="not unitary"):
        oracle.apply_camodc_high_planar(state, out, C, A, 0, 5)  # 2^5 < 33
    with pytest.raises(ValueError, match="distinct contiguous buffer"):
        oracle.apply_camodc_high_planar(state, state, C, A, 0, M)
    with pytest.raises(ValueError, match="match the state"):
        oracle.apply_camodc_high_planar(state, out.double(), C, A, 0, M)
