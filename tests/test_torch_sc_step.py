"""The semiclassical step's two passes (quantumcomputer_tpu_torch/ops/
sc_step.py) on the CPU: their plain versions against the step's PyTorch
composition (the 1/sqrt2 scale of the permuted planes, the rotation,
_branch_sums and collapse_from_a1), the fixed order of the sums, and the
wrapper's input check.  The kernels themselves run only on a card
(utils/kernel_checks.sc_step_kernels).

Tolerances: given the same p0 and p1 the collapsed state, the bit and
p_cond are equal bit for bit (every op rounds once, in the same order);
the sums, taken in float64 here and in the plane dtype by _branch_sums,
agree to rtol 1e-6 (float32) and 1e-13 (float64)."""

import math

import numpy as np
import pytest
import torch

from quantumcomputer_tpu_torch.algorithms import semiclassical as sc
from quantumcomputer_tpu_torch.ops import modperm, sc_step

SUM_RTOL = {torch.float32: 1e-6, torch.float64: 1e-13}


def _inputs(M: int, dtype, seed: int) -> tuple:
    """A normalized work state, a permutation of its indices, and the
    step's cos / sin of pi * phi as _step forms them."""
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((2, 1 << M))
    w = torch.from_numpy(psi / np.sqrt(np.sum(psi * psi))).to(dtype)
    perm = torch.from_numpy(rng.permutation(1 << M))
    phi = torch.tensor(float(rng.random()), dtype=dtype)
    theta = phi * torch.tensor(math.pi, dtype=dtype)
    return w, perm, torch.cos(theta), torch.sin(theta)


@pytest.mark.parametrize("plain_block", [None, 1 << 8])
@pytest.mark.parametrize("force", [-1, 0, 1])
@pytest.mark.parametrize("M", [10, 13, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_passes_equal_the_steps_composition(dtype, M, force, plain_block, monkeypatch):
    if plain_block is not None:
        monkeypatch.setattr(sc_step, "_PLAIN_BLOCK", plain_block)  # many blocks at a small M
    w, perm, ct, st = _inputs(M, dtype, seed=M)
    r = torch.tensor(0.4, dtype=dtype)
    # Today's composition: the structured pass (its permutation replaced by
    # the fixed one), then the collapse.
    monkeypatch.setattr(modperm, "apply_stride_permute", lambda x, plan: x[..., perm])
    a1, p0, p1 = sc._oracle_pass_structured(w, M, dtype, dtype, object(), ct, st)
    bit, p_cond, want = sc.collapse_from_a1(w, a1.clone(), p0, p1, r, force, dtype, dtype)

    gr, gi = w[0][perm], w[1][perm]
    sums = sc_step.reduce_partials(sc_step.branch_sums_plain(w, gr, gi, ct, st))
    np.testing.assert_allclose(sums.numpy(), [float(p0), float(p1)], rtol=SUM_RTOL[dtype], atol=0)

    got = w.clone()
    same = torch.stack([p0, p1]).to(torch.float64).view(1, 2)
    got_bit, got_p = sc_step.collapse_plain(got, gr, gi, ct, st, same, r, force)
    assert int(got_bit) == int(bit)
    assert torch.equal(got_p, p_cond)
    assert torch.equal(got, want)


def _kernel_order(partials: np.ndarray, threads: int) -> np.ndarray:
    """csrc/sc_step.cu's collapse prologue, loop for loop, in Python floats."""
    acc = [[0.0, 0.0] for _ in range(threads)]
    for t in range(threads):
        for k in range(t, len(partials), threads):
            acc[t] = [acc[t][0] + float(partials[k, 0]), acc[t][1] + float(partials[k, 1])]
    s = threads // 2
    while s:
        for t in range(s):
            acc[t] = [acc[t][0] + acc[t + s][0], acc[t][1] + acc[t + s][1]]
        s //= 2
    return np.array(acc[0])


@pytest.mark.parametrize("G", [1, 255, 256, 257, 528, 1000])
def test_reduce_partials_follows_the_kernel_order(G):
    partials = np.random.default_rng(G).random((G, 2)) * np.logspace(-9, 0, G)[:, None]
    got = sc_step.reduce_partials(torch.from_numpy(partials)).numpy()
    np.testing.assert_array_equal(got, _kernel_order(partials, sc_step.THREADS))
    np.testing.assert_allclose(got, [math.fsum(partials[:, 0]), math.fsum(partials[:, 1])], rtol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrappers_take_the_plain_versions_on_cpu(dtype):
    w, perm, ct, st = _inputs(12, dtype, seed=3)
    gr, gi = w[0][perm], w[1][perm]
    r = torch.tensor(0.7, dtype=dtype)
    before = dict(sc_step.LAUNCHES)
    partials = sc_step.branch_sums(w, gr, gi, ct, st)
    assert torch.equal(partials, sc_step.branch_sums_plain(w, gr, gi, ct, st))
    got, want = w.clone(), w.clone()
    bit, p = sc_step.collapse(got, gr, gi, ct, st, partials, r, -1)
    want_bit, want_p = sc_step.collapse_plain(want, gr, gi, ct, st, partials, r, -1)
    assert int(bit) == int(want_bit) and torch.equal(p, want_p) and torch.equal(got, want)
    assert float(torch.linalg.vector_norm(got.to(torch.float64))) == pytest.approx(1.0, abs=1e-5)
    assert sc_step.LAUNCHES == before
    with pytest.raises(ValueError, match="force"):
        sc_step.collapse(got, gr, gi, ct, st, partials, r, 2)


def _good(n: int = 64, dtype=torch.float32) -> dict:
    w = torch.zeros((2, n), dtype=dtype)
    return {"w": w, "gr": torch.zeros(n, dtype=dtype), "gi": torch.zeros(n, dtype=dtype),
            "ct": torch.ones((), dtype=dtype), "st": torch.zeros((), dtype=dtype)}


def _misaligned(n: int = 64) -> torch.Tensor:
    return torch.zeros(n + 1)[1:]  # starts 4 bytes into its storage


BAD = {
    "bf16 state": (dict(_good(dtype=torch.bfloat16)), TypeError),
    "int state": (dict(_good(), w=torch.zeros((2, 64), dtype=torch.int32)), TypeError),
    "non-contiguous state": (dict(_good(), w=torch.zeros((64, 2)).t()), ValueError),
    "non-contiguous plane": (dict(_good(), gr=torch.zeros(128)[::2]), ValueError),
    "misaligned plane": (dict(_good(), gi=_misaligned()), ValueError),
    "misaligned state": (dict(_good(n=65), gr=torch.zeros(65), gi=torch.zeros(65)), ValueError),
    "plane of another dtype": (dict(_good(), gr=torch.zeros(64, dtype=torch.float64)), TypeError),
    "plane of another length": (dict(_good(), gr=torch.zeros(32)), ValueError),
    "three planes": (dict(_good(), w=torch.zeros((3, 64))), ValueError),
    "two angles": (dict(_good(), ct=torch.ones(2)), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_input_check_rejects(case):
    args, error = BAD[case]
    with pytest.raises(error):
        sc_step.check_inputs(**args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_input_check_accepts_aligned_planes(dtype):
    sc_step.check_inputs(**_good(dtype=dtype))


def test_cpu_step_runs_the_plain_composition(monkeypatch):
    """On the CPU a structured attempt still goes through _branch_sums and
    collapse_from_a1 (which the benchmark's fault tests patch), never
    through sc_step."""
    C, L, M = (1 << 18) - 3, 4, 18
    seen = {"branch_sums": 0, "collapse": 0}
    branch_sums, collapse = sc._branch_sums, sc.collapse_from_a1

    def counted_sums(*args):
        seen["branch_sums"] += 1
        return branch_sums(*args)

    def counted_collapse(*args):
        seen["collapse"] += 1
        return collapse(*args)

    def refused(*args, **kwargs):
        raise AssertionError("the CPU step reached ops/sc_step")

    monkeypatch.setattr(sc, "_branch_sums", counted_sums)
    monkeypatch.setattr(sc, "collapse_from_a1", counted_collapse)
    monkeypatch.setattr(sc_step, "branch_sums", refused)
    monkeypatch.setattr(sc_step, "collapse", refused)
    rec = sc.run_semiclassical(C, 5, L, M, np.full(L, 0.5, np.float32), structured=True, device="cpu")
    assert "structured" in rec.oracles
    assert seen["collapse"] == L and seen["branch_sums"] >= L
