"""The port's semiclassical engine (quantumcomputer_tpu_torch/algorithms/
semiclassical.py) against the JAX package's, on the CPU.

Tolerances: branch probabilities within 1e-6 at complex64 and 1e-12 at
complex128 (the JAX suite's semiclassical bounds); one step's collapsed
state within 1e-6 at complex64; sampled bits equal when both packages take
the same draws.  The structured oracle only moves data, so a structured
attempt equals the gather attempt exactly."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.algorithms import semiclassical as jsc
from quantumcomputer_tpu.ops import modperm as jmodperm
from quantumcomputer_tpu_torch import cli
from quantumcomputer_tpu_torch.algorithms import semiclassical as sc
from quantumcomputer_tpu_torch.algorithms import shor
from quantumcomputer_tpu_torch.ops import modperm
from quantumcomputer_tpu_torch.utils import logging as tlog
from quantumcomputer_tpu_torch.utils import memory

TOL = {torch.complex64: 1e-6, torch.complex128: 1e-12}
JAX_DTYPE = {torch.complex64: jnp.complex64, torch.complex128: jnp.complex128}
CASES = [(15, 7, 3, 4), (21, 2, 4, 5), (33, 29, 3, 6)]


@pytest.fixture(autouse=True)
def _reset_verbosity():
    yield
    tlog.configure(False, False)


@pytest.mark.parametrize("C,a,L,M", CASES)
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_every_forced_branch_matches_jax(C, a, L, M, dtype):
    """Each branch's conditional probabilities, step by step, until the
    branch dies (a forced zero-probability outcome leaves a meaningless
    state by construction, in both packages)."""
    zeros = np.zeros(L, np.float64)
    for branch in range(1 << L):
        forced = [(branch >> k) & 1 for k in range(L)]
        want = jsc.run_semiclassical(C, a, L, M, jax.random.PRNGKey(0), dtype=JAX_DTYPE[dtype], forced_bits=forced)
        got = sc.run_semiclassical(C, a, L, M, zeros, dtype=dtype, forced_bits=forced)
        assert got.bits == forced and got.x_tilde == want.x_tilde and got.omega == want.omega
        for p_got, p_want in zip(got.branch_probs, want.branch_probs):
            assert abs(p_got - p_want) <= TOL[dtype], (branch, got.branch_probs, want.branch_probs)
            if p_want < 1e-9:
                break


@pytest.mark.parametrize("C,a,L,M", CASES + [(391, 3, 10, 9)])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_sampled_bits_match_jax_with_its_draws(C, a, L, M, dtype):
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        jdt = JAX_DTYPE[dtype]
        rs = np.asarray(jax.random.uniform(key, (L,), dtype=jnp.float32 if jdt == jnp.complex64 else jnp.float64))
        want = jsc.run_semiclassical(C, a, L, M, key, dtype=jdt)
        got = sc.run_semiclassical(C, a, L, M, rs, dtype=dtype)
        assert got.bits == want.bits, (seed, got.bits, want.bits)
        np.testing.assert_allclose(got.branch_probs, want.branch_probs, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("force", [-1, 0, 1])
def test_one_step_matches_jax_step_fn(force):
    C, M = 391, 9
    a_inv = pow(3, -1, C)
    rng = np.random.default_rng(7)
    psi = rng.standard_normal((2, 1 << M))
    w = (psi / np.sqrt(np.sum(psi * psi))).astype(np.float32)
    phi, r = 0.375, 0.4
    jbit, jp, jout, jphi = jsc._step_fn(M, jnp.float32)(
        jnp.asarray(w), jnp.asarray(phi, jnp.float32), jnp.asarray(C, jnp.int32),
        jnp.asarray(a_inv, jnp.int32), jnp.asarray(r, jnp.float32), jnp.asarray(force, jnp.int32),
    )
    bit, p, out, phi2 = sc._step(
        torch.from_numpy(w), torch.tensor(phi, dtype=torch.float32), M, torch.float32, C, a_inv, None,
        torch.tensor(r, dtype=torch.float32), force,
    )
    assert int(bit) == int(jbit)
    assert abs(float(p) - float(jp)) <= 1e-6
    assert float(phi2) == float(jphi)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-6)


def _ladder_with_planned_steps(C, L, M, need):
    """A multiplier whose L-step ladder has at least `need` planned steps."""
    for a in range(2, 400):
        if math.gcd(a, C) != 1:
            continue
        a_invs = [pow(pow(a, 1 << (L - 1 - s), C), -1, C) for s in range(L)]
        plans = sc._structured_plans(C, a_invs, M)
        if sum(p is not None for p in plans) >= need:
            return a, plans
    raise AssertionError("no multiplier with enough planned steps")


def test_structured_attempt_equals_the_gather_attempt():
    C, L, M = (1 << 18) - 3, 6, 18
    a, plans = _ladder_with_planned_steps(C, L, M, 2)
    n_planned = sum(p is not None for p in plans)
    rs = np.random.default_rng(1).random(L).astype(np.float32)
    forced = [1, 0, 1, 1, 0, 1]
    for kw in ({}, {"forced_bits": forced}):
        s = sc.run_semiclassical(C, a, L, M, rs, structured=True, **kw)
        g = sc.run_semiclassical(C, a, L, M, rs, structured=False, **kw)
        assert s.oracles.count("structured") == n_planned >= 2
        assert g.oracles == ["gather"] * L
        assert s.bits == g.bits
        assert s.branch_probs == g.branch_probs  # the permutation is exact
    # The same plans as the JAX package's planner under the 256 floor.
    a_invs = [pow(pow(a, 1 << (L - 1 - s), C), -1, C) for s in range(L)]
    for ai, p in zip(a_invs, plans):
        jp = jmodperm.plan_stride_permute(C, ai, M, min_factor=256)
        assert (p is None) == (jp is None)


def test_auto_selection_and_env_override(monkeypatch):
    C, L, M = (1 << 18) - 3, 6, 18
    a, _ = _ladder_with_planned_steps(C, L, M, 2)
    rs = np.full(L, 0.5, np.float32)
    assert sc.run_semiclassical(C, a, L, M, rs).oracles == ["gather"] * L  # CPU: gather
    assert not sc._use_structured(None, 28, torch.float32, torch.device("cpu"))
    monkeypatch.setenv("QC_SC_STRUCTURED", "1")
    assert "structured" in sc.run_semiclassical(C, a, L, M, rs).oracles
    monkeypatch.setenv("QC_SC_STRUCTURED", "0")
    assert not sc._use_structured(None, 28, torch.float32, torch.device("cuda"))
    assert sc._use_structured(True, 10, torch.float32, torch.device("cpu"))


def test_memory_envelopes_match_jax(monkeypatch):
    for M in (5, 9):
        state_bytes = 2 * (1 << M) * 4
        for k in range(2, 6):
            monkeypatch.setenv("QC_TPU_HBM_BYTES", str(k * state_bytes))
            assert memory.fused_attempt_fits(M, torch.float32, "cpu") == jsc.fused_attempt_fits(M, jnp.float32)
            assert memory.step_program_fits(M, torch.float32, "cpu") == jsc.step_program_fits(M, jnp.float32)
    monkeypatch.setenv("QC_TPU_HBM_BYTES", str(2 * (2 * (1 << 5) * 4)))
    with pytest.raises(ValueError, match="memory budget"):
        sc.run_semiclassical(21, 2, 4, 5, np.zeros(4, np.float32))
    monkeypatch.delenv("QC_TPU_HBM_BYTES")
    assert memory.fused_attempt_fits(30, torch.float64, "cpu")  # no budget on the CPU


def test_argument_checks_match_jax():
    for args in ((15, 7, 4, 3), (15, 7, 4, 31), (15, 7, 53, 4), (1 << 30, 3, 4, 30), (15, 5, 4, 4)):
        with pytest.raises(ValueError) as want:
            jsc.run_semiclassical(*args, jax.random.PRNGKey(0))
        with pytest.raises(ValueError) as got:
            sc.run_semiclassical(*args, np.zeros(args[2], np.float32))
        assert str(got.value) == str(want.value)
    for forced in ([1, 0, 1], [0, 2, 0, 1]):
        with pytest.raises(ValueError) as want:
            jsc.validate_forced_bits(forced, 4)
        with pytest.raises(ValueError) as got:
            sc.validate_forced_bits(forced, 4)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="rs must hold"):
        sc.run_semiclassical(15, 7, 4, 4, np.zeros(3, np.float32))
    # Ported: checkpoint_dir runs (tests/test_torch_checkpoint.py); its refusals match the JAX package's.
    for kw in ({"dtype": "dd64", "checkpoint_dir": "ck"}, {"checkpoint_dir": "ck", "checkpoint_every": 0}):
        with pytest.raises(ValueError) as want:
            jsc.run_semiclassical(15, 7, 4, 4, jax.random.PRNGKey(0), **kw)
        with pytest.raises(ValueError) as got:
            sc.run_semiclassical(15, 7, 4, 4, np.zeros(4, np.float32), **kw)
        assert str(got.value) == str(want.value)
    c32 = sc.run_semiclassical(15, 7, 4, 4, np.full(4, 0.5, np.float32), dtype="complex32")  # ported
    assert len(c32.bits) == 4 and all(0.0 < p <= 1.0 + 1e-6 for p in c32.branch_probs)
    rs = np.full(4, 0.5)
    dd, c128 = (sc.run_semiclassical(15, 7, 4, 4, rs, dtype=d) for d in ("dd64", torch.complex128))
    assert (dd.bits, dd.branch_probs) == (c128.bits, c128.branch_probs)  # dd64 runs complex128
    # Ported: mesh= runs the sharded attempt (tests/test_torch_sharded_semiclassical.py); with
    # a checkpoint directory it raises the JAX package's message.
    from quantumcomputer_tpu.parallel.mesh import build_mesh as jbuild_mesh
    from quantumcomputer_tpu_torch.parallel.mesh import build_mesh

    with pytest.raises(ValueError) as want:
        jsc.find_period_semiclassical(15, 7, 4, 4, jax.random.PRNGKey(0), mesh=jbuild_mesh(2), checkpoint_dir="ck")
    with pytest.raises(ValueError) as got:
        sc.find_period_semiclassical(15, 7, 4, 4, np.zeros(4, np.float32), mesh=build_mesh(2), checkpoint_dir="ck")
    assert str(got.value) == str(want.value)


def test_record_readout_matches_jax():
    rng = np.random.default_rng(3)
    for L in (1, 5, 17, 45):
        bits = [int(b) for b in rng.integers(0, 2, L)]
        probs = [float(p) for p in rng.random(L)]
        got, want = sc.SemiclassicalRecord.from_bits(bits, probs), jsc.SemiclassicalRecord.from_bits(bits, probs)
        assert (got.x_tilde, got.omega, got.probability) == (want.x_tilde, want.omega, want.probability)


def test_find_period_semiclassical_matches_jax():
    C, a, L, M = 391, 3, 14, 9
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        rs = np.asarray(jax.random.uniform(key, (L,), dtype=jnp.float32))
        jp, jrec = jsc.find_period_semiclassical(C, a, L, M, key)
        tp, trec = sc.find_period_semiclassical(C, a, L, M, rs)
        assert (tp, trec.x_tilde) == (jp, jrec.x_tilde)


def test_shors_algorithm_semiclassical_draws_from_the_generator():
    runs = [shor.shors_algorithm(15, 8, 4, seed=3, semiclassical=True, max_attempts_per_a=2) for _ in range(2)]
    assert [r.measured_index for r in runs[0].attempts] == [r.measured_index for r in runs[1].attempts]
    assert runs[0].factors == (5, 3)
    rec = runs[0].attempts[0].semiclassical
    gen = torch.Generator().manual_seed(3)
    assert rec.bits == sc.run_semiclassical(15, 2, 8, 4, torch.rand((8,), generator=gen)).bits
    with pytest.raises(ValueError, match="its own engine"):
        shor.shors_algorithm(15, 8, 4, semiclassical=True, layout="m_high")


def test_cli_semiclassical_end_to_end(capsys):
    rc = cli.main(["-C", "15", "-L", "3", "-M", "4", "-a", "7", "--semiclassical", "--seed", "0", "-v"])
    out = capsys.readouterr().out
    assert rc in (0, 3)
    assert " --- Forced trial integer a = 7, finding period ..." in out
    assert " --- Time to run Shor's Algorithm: " in out
    assert (" --- Factors of 15 found: (5, 3)." in out) if rc == 0 else ("could not be factorised" in out)
