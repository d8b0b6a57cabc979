"""The port's batched sampler (ops/measure.sample_indices) and planar
mcphase (ops/gates.apply_mcphase_planes_), the glue the generic algorithms
run on.

Tolerances: the batched sampler gives, draw for draw, exactly the index the
per-draw sampler gives, knife-edge draws at block and element boundaries
included, from ONE block-sum call; against the JAX package's sample_indices
(its Pallas block sums in interpret mode) on draws clear of any cumulative
boundary.  The planar mcphase equals the JAX apply_mcphase bit for bit at
bf16 (widened, multiplied in float32, rounded once, as the JAX package's
complex64 path rounds) and within 4 ulps of order-1 values at float32
(1e-6) and float64 (1e-15): the JAX package's complex multiply contracts
into fused multiply-adds on the CPU."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.models.circuit import MCPHASE as JMCPHASE
from quantumcomputer_tpu.ops import pallas_measure as pm
from quantumcomputer_tpu.sim.engine import apply_gate_planes as japply_gate_planes
from quantumcomputer_tpu_torch import Register, StateVectorEngine, interop
from quantumcomputer_tpu_torch.models import circuit as tcir
from quantumcomputer_tpu_torch.ops import gates as tops
from quantumcomputer_tpu_torch.ops import measure
from quantumcomputer_tpu_torch.sim import engine as tengine
from quantumcomputer_tpu_torch.utils import kernel_checks

PLANES = {torch.float32: np.float32, torch.float64: np.float64, torch.bfloat16: ml_dtypes.bfloat16}
MCPHASE_TOL = {torch.float32: 1e-6, torch.float64: 1e-15, torch.bfloat16: 0.0}
CONTROLS = [(0,), (3,), (0, 1), (2, 5, 7), tuple(range(10)), (9,), (1, 8), (0, 4, 5, 6, 9)]


def _planes(n, seed, dtype=np.float32, decay=False):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((2, 1 << n))
    if decay:
        p *= np.exp(-np.arange(1 << n) / (1 << (n - 3)))
    return (p / np.sqrt((p * p).sum())).astype(dtype)


def _boundary_draws(planes: np.ndarray) -> list:
    """Draws at and one float32 step beside the cumulative boundaries the
    sampler of this state scans (kernel_checks.boundary_draws for the
    hierarchical path, every seventh element for the flat one)."""
    state = interop.state_from_numpy(planes)
    if state.dtype == torch.float64 or state.shape[1] < measure.HIERARCHICAL_MIN_DIM:
        cum = torch.cumsum(tengine.sv.probabilities(state), 0)  # the flat path's one scan
        return [float((t / cum[-1]).to(state.dtype)) for t in cum[:-1:7]]
    return kernel_checks.boundary_draws(state)


@pytest.mark.parametrize("n,dtype", [(16, np.float32), (17, np.float32), (16, ml_dtypes.bfloat16), (12, np.float32),
                                     (16, np.float64)])
def test_batched_sampler_equals_the_per_draw_sampler(n, dtype, monkeypatch):
    planes = _planes(n, 40 + n, dtype, decay=True)
    state = interop.state_from_numpy(planes)
    draws = _boundary_draws(planes) + list(np.random.default_rng(n).random(64))
    calls = []
    sums = measure.block_sums
    monkeypatch.setattr(measure, "block_sums", lambda p: calls.append(1) or sums(p))
    batched = measure.sample_indices(state, draws)
    assert len(calls) == (1 if state.dtype != torch.float64 and n >= 16 else 0)
    single = [measure.sample_index(state, r) for r in draws]
    assert batched.dtype == torch.int64 and batched.tolist() == single


def test_every_scan_has_one_shape(monkeypatch):
    """Every local scan of the batched sampler, a lone draw's included, is a
    one-dimensional scan of one block: the CUDA scan's algorithm and thread
    layout follow the number of rows (found on the card: scans of 32 and 2
    rows picked different indices at knife edges)."""
    planes = _planes(17, 3, decay=True)
    state = interop.state_from_numpy(planes)
    nblocks, block = measure._nblocks_block(state)
    shapes = []
    cumsum = torch.cumsum
    monkeypatch.setattr(torch, "cumsum", lambda x, d: shapes.append(tuple(x.shape)) or cumsum(x, d))
    for draws in ([0.3], list(np.linspace(0.01, 0.99, 7))):
        shapes.clear()
        measure.sample_indices(state, draws)
        assert shapes == [(nblocks,)] + [(block,)] * len(draws)


def test_batched_sampler_matches_jax_on_clear_draws():
    n = 17
    planes = _planes(n, 5, decay=True)
    cum = np.cumsum(planes[0].astype(np.float64) ** 2 + planes[1].astype(np.float64) ** 2)
    draws = np.random.default_rng(3).random(300).astype(np.float32)
    clear = [r for r in draws if np.min(np.abs(cum - float(r) * cum[-1])) > 1e-6]
    assert len(clear) > 150
    rs = np.asarray(clear, np.float32)
    want = np.asarray(jax.jit(pm.sample_indices)(jnp.asarray(planes), jnp.asarray(rs)))
    got = measure.sample_indices(interop.state_from_numpy(planes), rs)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_sample_one_pass_for_many_shots(monkeypatch):
    eng = StateVectorEngine(Register(L=16, M=0), dtype=torch.complex64, backend="torch")
    state = eng.run(tuple(tcir.H(q) for q in range(16)), eng.zero_state())
    calls = []
    plain = measure.block_sums_plain
    monkeypatch.setattr(measure, "block_sums_plain", lambda p: calls.append(1) or plain(p))
    rs = eng.draws((100,), 3)
    got = eng.sample(state, rs)
    assert len(calls) == 1 and got.shape == (100,)
    assert got.tolist() == [eng.measure(state.clone(), float(r))[0] for r in rs]
    assert eng.draws((4,), 3).dtype == torch.float32
    assert StateVectorEngine(Register(L=3, M=0), dtype=torch.complex128, backend="torch").draws((2,), 0).dtype == torch.float64


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("theta", [0.73, np.pi, -2.1])
def test_planar_mcphase_matches_jax(dtype, theta):
    n = 10
    rng = np.random.default_rng(int(theta * 100) % 97)
    for controls in CONTROLS:
        planes = rng.standard_normal((2, 1 << n)).astype(PLANES[dtype])
        re, im = japply_gate_planes(jnp.asarray(planes[0]), jnp.asarray(planes[1]), JMCPHASE(controls, theta), 0)
        want = np.stack([np.asarray(re), np.asarray(im)]).astype(np.float64)
        state = interop.state_from_numpy(planes)
        ptr = state.data_ptr()
        out = tops.apply_mcphase_planes_(state, controls, theta)
        assert out is state and state.data_ptr() == ptr and state.dtype == dtype
        got = state.double().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=MCPHASE_TOL[dtype])
        mask = sum(1 << q for q in controls)
        untouched = (np.arange(1 << n) & mask) != mask
        np.testing.assert_array_equal(got[:, untouched], planes.astype(np.float64)[:, untouched])


def test_engine_routes_mcphase_in_place_and_counts_it():
    n = 8
    planar = interop.state_from_numpy(_planes(n, 2))
    ptr, before = planar.data_ptr(), tops.MCPHASE_CALLS
    circ = (tcir.H(0), tcir.MCZ(*range(n)), tcir.H(1), tcir.MCPHASE((2, 5), 0.4))
    want = tengine.apply_circuit_plain_(planar.clone(), circ, 0)
    out = tengine.apply_circuit_fused_(planar, circ, 0)
    assert out.data_ptr() == ptr and tops.MCPHASE_CALLS == before + 2
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6)


def test_mcphase_view_and_complex_form():
    x = torch.arange(1 << 6)
    assert tops.mcphase_view(x, (0, 1, 2, 3, 4, 5)).item() == 63
    assert tops.mcphase_view(x, (1, 4)).flatten().tolist() == [i for i in range(64) if i & 0b10010 == 0b10010]
    assert sorted(tops.mcphase_view(x, (5,)).flatten().tolist()) == list(range(32, 64))
    z = torch.from_numpy((_planes(6, 1)[0] + 1j * _planes(6, 1)[1]).astype(np.complex128))
    got = tops.apply_mcphase(z, (0, 3), 1.1)
    idx = np.arange(64)
    want = z.numpy() * np.where((idx & 9) == 9, np.exp(1.1j), 1.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-15)
