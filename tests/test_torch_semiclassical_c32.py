"""The port's semiclassical engine at complex32 (bf16 work state, float32
angles, draws and branch sums) against the JAX package's, on the CPU.

Tolerances, from the JAX suite's complex32 semiclassical tests: each forced
branch's joint probability within 3e-2 of the full-register distribution
and the branches summing to 1 within 5e-2 (tests/test_semiclassical.py:
444-464); the structured oracle against the gather at rtol 2e-2
(tests/test_semiclassical_structured.py:71-76).  Where both packages take
the same draws, the bits are equal wherever every draw lies farther than
SAMPLE_MARGIN from its step's branch probability (bf16 rounds at other
places in the two frameworks: XLA may keep float32 between fused bf16 ops).
The transpose and chunk gather only move data: exact at bf16."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.algorithms import semiclassical as jsc
from quantumcomputer_tpu.models.shor_circuit import shor_circuit as jshor_circuit
from quantumcomputer_tpu.ops import pallas_chunkgather as jcg
from quantumcomputer_tpu.ops.pallas_transpose import tiled_transpose_padded as jtranspose
from quantumcomputer_tpu.sim.engine import Register as JRegister
from quantumcomputer_tpu.sim.engine import StateVectorEngine as JEngine
from quantumcomputer_tpu_torch import cli
from quantumcomputer_tpu_torch.algorithms import semiclassical as sc
from quantumcomputer_tpu_torch.ops import chunkgather, transpose
from quantumcomputer_tpu_torch.utils import logging as tlog

JOINT_TOL = 3e-2
TOTAL_TOL = 5e-2
STRUCTURED_RTOL = 2e-2
SAMPLE_MARGIN = 2e-2


@pytest.fixture(autouse=True)
def _reset_verbosity():
    yield
    tlog.configure(False, False)


def _full_register_omega_distribution(C, a, L, M):
    """P(x_tilde) of the JAX package's full-register complex128 circuit
    (tests/test_semiclassical.py:26-41)."""
    eng = JEngine(JRegister(L=L, M=M), dtype=jnp.complex128)
    probs = np.abs(eng.to_numpy(eng.run(jshor_circuit(C, a, L, M)))) ** 2
    p_count = probs.reshape(1 << L, 1 << M).sum(axis=1)
    p_xt = np.zeros(1 << L)
    for c in range(1 << L):
        p_xt[int(format(c, f"0{L}b")[::-1], 2) if L > 1 else c] += p_count[c]
    return p_xt


def _joint(rec) -> float:
    p = 1.0
    for cond in rec.branch_probs:
        if not np.isfinite(cond) or cond < 1e-6:
            return 0.0
        p *= float(cond)
    return p


def test_every_forced_branch_c32_matches_the_full_register_and_jax():
    C, a, L, M = 15, 7, 3, 4
    p_xt = _full_register_omega_distribution(C, a, L, M)
    total = 0.0
    for branch in range(1 << L):
        forced = [(branch >> k) & 1 for k in range(L)]
        got = sc.run_semiclassical(C, a, L, M, np.zeros(L, np.float32), dtype="complex32", forced_bits=forced)
        want = jsc.run_semiclassical(C, a, L, M, jax.random.PRNGKey(0), dtype="complex32", forced_bits=forced)
        assert got.bits == forced and got.x_tilde == want.x_tilde
        p = _joint(got)
        assert abs(p - p_xt[branch]) < JOINT_TOL, (branch, p, p_xt[branch])
        assert abs(p - _joint(want)) < JOINT_TOL
        total += p
    assert abs(total - 1.0) < TOTAL_TOL


def _planned_multiplier(C, L, M, need):
    for a in range(2, 400):
        if np.gcd(a, C) != 1:
            continue
        a_invs = [pow(pow(a, 1 << (L - 1 - s), C), -1, C) for s in range(L)]
        if sum(p is not None for p in sc._structured_plans(C, a_invs, M)) >= need:
            return a
    raise AssertionError("no multiplier with enough planned steps")


def test_structured_c32_matches_the_gather():
    """The structured permutation only moves data, and both oracles round
    the rotation once: the complex32 attempts agree at the JAX bound."""
    C, L, M = (1 << 18) - 3, 6, 18
    a = _planned_multiplier(C, L, M, 2)
    forced = [1, 0, 1, 1, 0, 1]
    s = sc.run_semiclassical(C, a, L, M, np.zeros(L, np.float32), dtype="complex32", forced_bits=forced, structured=True)
    g = sc.run_semiclassical(C, a, L, M, np.zeros(L, np.float32), dtype="complex32", forced_bits=forced, structured=False)
    assert s.oracles.count("structured") >= 2 and g.oracles == ["gather"] * L
    assert s.bits == g.bits == forced
    np.testing.assert_allclose(s.branch_probs, g.branch_probs, rtol=STRUCTURED_RTOL)


@pytest.mark.parametrize("C,a,L,M", [(15, 7, 3, 4), (21, 2, 4, 5), (391, 3, 10, 9)])
def test_sampled_bits_c32_match_jax_on_shared_draws(C, a, L, M):
    checked = 0
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        rs = np.asarray(jax.random.uniform(key, (L,), dtype=jnp.float32))
        want = jsc.run_semiclassical(C, a, L, M, key, dtype="complex32")
        got = sc.run_semiclassical(C, a, L, M, rs, dtype="complex32")
        # p0 of each step from the port's record: the branch taken and its probability.
        p0 = [p if b == 0 else 1.0 - p for b, p in zip(got.bits, got.branch_probs)]
        if min(abs(r - p) for r, p in zip(rs, p0)) <= SAMPLE_MARGIN:
            continue
        assert got.bits == want.bits, (seed, got.bits, want.bits)
        np.testing.assert_allclose(got.branch_probs, want.branch_probs, rtol=0, atol=JOINT_TOL)
        checked += 1
    assert checked >= 2


def test_one_step_c32_rounds_the_rotation_once():
    """a1 = ct * g - st * g' in float32, rounded to bf16 once: the port's
    rotation equals the float32 rotation of the same bf16 operands rounded
    once, bit for bit (a 0-d float32 tensor does not promote bf16 in torch,
    which would round three times)."""
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32)).to(torch.bfloat16)
    ct, st = torch.tensor(0.6, dtype=torch.float32), torch.tensor(0.8, dtype=torch.float32)
    a1 = torch.empty_like(g)
    sc._rotate(a1, g[0], g[1], ct, st, torch.float32)
    gf = g.float().numpy().astype(np.float32)
    want = np.stack([np.float32(0.6) * gf[0] - np.float32(0.8) * gf[1], np.float32(0.8) * gf[0] + np.float32(0.6) * gf[1]])
    np.testing.assert_array_equal(a1.float().numpy(), want.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_transpose_and_chunk_gather_bf16_are_exact_against_jax():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 300, 523)).astype(ml_dtypes.bfloat16)
    want = np.asarray(jtranspose(jnp.asarray(x), block=(128, 128), extra_rows=1))
    got = transpose.tiled_transpose_padded(torch.from_numpy(x.view(np.int16)).view(torch.bfloat16), 1)
    rows = want.shape[1] - 1
    np.testing.assert_array_equal(got[:, :rows].view(torch.int16).numpy(), want[:, :rows].view(np.int16))
    P, W, NC = 128 * 48, 384, 9
    x = rng.standard_normal((2, P)).astype(ml_dtypes.bfloat16)
    xt = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    s0, s1, istar = rng.integers(0, P - W + 1, NC), rng.integers(0, P - W + 1, NC), rng.integers(0, W + 1, NC)
    cases = [
        (chunkgather.chunk_gather(xt, torch.from_numpy(s0), W), jcg.chunk_gather(jnp.asarray(x), jnp.asarray(s0, jnp.int32), W)),
        (
            chunkgather.chunk_gather_blend(xt, *(torch.from_numpy(v) for v in (s0, s1, istar)), W),
            jcg.chunk_gather_blend(jnp.asarray(x), *(jnp.asarray(v, jnp.int32) for v in (s0, s1, istar)), W),
        ),
        (chunkgather.chunk_gather_blend_rowlaw(xt, 30, 300, 384, 256), jcg.chunk_gather_blend_rowlaw(jnp.asarray(x), 30, 300, 384, 256)),
    ]
    x2 = rng.standard_normal((2, 128 * 8)).astype(ml_dtypes.bfloat16)
    flags = rng.integers(0, 2, NC)
    starts = np.where(flags == 1, rng.integers(0, 128 * 8 - W + 1, NC), s0)
    cases.append((
        chunkgather.chunk_gather_src2(xt, torch.from_numpy(x2.view(np.int16)).view(torch.bfloat16), torch.from_numpy(starts), torch.from_numpy(flags), W),
        jcg.chunk_gather_src2(jnp.asarray(x), jnp.asarray(x2), jnp.asarray(starts, jnp.int32), jnp.asarray(flags, jnp.int32), W),
    ))
    for got, want in cases:
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))


def test_cli_semiclassical_complex32_factors_15_on_the_cpu(capsys):
    rc = cli.main(["-C", "15", "-L", "3", "-M", "4", "-a", "7", "--semiclassical", "--dtype", "complex32", "--seed", "0", "-v"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert " --- Factors of 15 found: (5, 3)." in out


def test_default_device_is_the_card_when_one_is_present(monkeypatch):
    """run_semiclassical / find_period_semiclassical with no device take the
    CUDA device when one is present (StateVectorEngine's rule), the CPU
    otherwise; the card is not touched here: the first use of the resolved
    device (the memory check) is intercepted."""
    seen = []

    class Resolved(Exception):
        pass

    def capture(M, rdtype, device):
        seen.append(torch.device(device))
        raise Resolved

    monkeypatch.setattr(sc, "step_program_fits", capture)
    for available, want in ((True, "cuda"), (False, "cpu")):
        monkeypatch.setattr(torch.cuda, "is_available", lambda available=available: available)
        with pytest.raises(Resolved):
            sc.run_semiclassical(15, 7, 3, 4, np.zeros(3, np.float32))
        with pytest.raises(Resolved):
            sc.find_period_semiclassical(15, 7, 3, 4, np.zeros(3, np.float32), dtype="complex32")
        assert [d.type for d in seen[-2:]] == [want, want]
    with pytest.raises(Resolved):
        sc.run_semiclassical(15, 7, 3, 4, np.zeros(3, np.float32), device="cpu")
    assert seen[-1].type == "cpu"  # an explicit device is kept
