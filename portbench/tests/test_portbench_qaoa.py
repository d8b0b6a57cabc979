"""The QAOA and gradient cells on the CPU at small sizes: both run through
core.run, their comparisons pass the program and fail the control
(complex32) and each planted fault, and their references agree with plain
definitions.  The limits are the committed ones."""

import numpy as np
import pytest
import torch

from portbench import core, qaoa, reference, reference_grad, reference_qaoa

QAOA_CELL, GRAD_CELL = "qaoa3reg-n30-p4.adam", "shor8191-n28.gradient"
SEED = 2**31 + 977


def _edges(n: int, seed: int = 5) -> list:
    from quantumcomputer_tpu_torch.algorithms import variational

    return [list(e) for e in variational.random_regular_graph(n, 3, seed)]


def small(cell: str, precision: str = None) -> dict:
    if cell == QAOA_CELL:
        cfg = {"n": 10, "L": 10, "edges": _edges(10)}
    else:  # the flagship's modulus and work register at L = 6: n = 19
        cfg = {"C": 8191, "a": 3, "L": 6, "M": 13}
    if precision:
        cfg["precision"] = precision
    return {"config": cfg}


def run(cell: str, precision: str = None, seconds: float = 0.4, trace: bool = False):
    return core.run(cell, SEED, seconds, trace, 0.0, device="cpu", overrides=small(cell, precision))


@pytest.mark.parametrize("cell", [QAOA_CELL, GRAD_CELL])
def test_cell_runs_and_is_correct(cell):
    r = run(cell, trace=True)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0, r["checks"]
    assert set(r["checks"]) == set(core.cell(cell)["limits"])


@pytest.mark.parametrize("cell", [QAOA_CELL, GRAD_CELL])
def test_control_is_not_correct(cell):
    r = run(cell, precision="complex32")
    assert r["failed"] == 0 and not r["correct"], r["checks"]


def _drop_one_qubit(monkeypatch):
    from quantumcomputer_tpu_torch.ops import qaoa as qops

    orig = qops.mixer_grad_plain
    monkeypatch.setattr(qops, "mixer_grad_plain", lambda psi, lam, qubits: orig(psi, lam, [q for q in qubits if q != 3]))


def _cost_sign_flipped(monkeypatch):
    from quantumcomputer_tpu_torch.ops import qaoa as qops

    orig = qops.apply_phase_plain

    def flipped(psi, table, ph):
        conj = ph.clone()
        conj[:, 1] = -conj[:, 1]
        return orig(psi, table, conj)

    monkeypatch.setattr(qops, "apply_phase_plain", flipped)


def _undo_skips_a_gate(monkeypatch):
    from quantumcomputer_tpu_torch.models import circuit as cir
    from quantumcomputer_tpu_torch.ops import fused
    from quantumcomputer_tpu_torch.ops import qaoa as qops

    orig = qops.mixer_values

    def skipping(n, betas, dtype, device):  # the undoing mixers' op 0 of each segment left as the identity
        values = orig(n, betas, dtype, device)
        identity = torch.tensor(fused.gate_to_op(cir.RX(0, 0.0))[2], dtype=values.dtype)
        for j, b in enumerate(betas):
            if b < 0:
                values[j, 0, : len(identity)] = identity
        return values

    monkeypatch.setattr(qops, "mixer_values", skipping)


def _dagger_skips_a_gate(monkeypatch):
    from quantumcomputer_tpu_torch.sim import engine

    orig = engine.dagger_circuit
    monkeypatch.setattr(engine, "dagger_circuit", lambda circuit, M: orig(circuit, M)[1:])


@pytest.mark.parametrize("cell,fault,fails", [
    (QAOA_CELL, _drop_one_qubit, "grad_gap"),
    (QAOA_CELL, _cost_sign_flipped, "cut_gap"),
    (QAOA_CELL, _undo_skips_a_gate, "grad_gap"),
    (GRAD_CELL, _dagger_skips_a_gate, "grad_gap"),
])
def test_planted_faults_fail(monkeypatch, cell, fault, fails):
    fault(monkeypatch)
    r = run(cell)
    assert not r["correct"] and r["checks"][fails]["value"] > r["checks"][fails]["limit"], r["checks"]


def test_an_altered_step_fails_param_gap(monkeypatch):
    from quantumcomputer_tpu_torch.algorithms import variational

    monkeypatch.setattr(variational.QAOAOptimizer, "step", lambda self: _beta2_step(self))
    r = run(QAOA_CELL)
    assert not r["correct"] and r["checks"]["param_gap"]["value"] > r["checks"]["param_gap"]["limit"], r["checks"]


def _beta2_step(self):
    from quantumcomputer_tpu_torch.algorithms import variational

    energy, grad = variational.qaoa_step(self.engine, self.table, self.params.detach().numpy())
    self.params.grad = torch.from_numpy(grad).to(torch.float32)
    self.opt.param_groups[0]["betas"] = (0.9, 0.99)  # another second-moment rate than the mix's
    self.opt.step()
    return energy, grad


# -- the references ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,p,slab", [(7, 1, 1 << 3), (9, 3, 1 << 4), (11, 4, 1 << 24)])
def test_qaoa64_matches_the_tape(monkeypatch, n, p, slab):
    monkeypatch.setattr(reference_qaoa, "SLAB", slab)
    edges = [e for e in _edges(n + n % 2, n) if max(e) < n] + [[0, n - 1, 2]]
    prm = np.random.default_rng(n).uniform(0.05, 0.9, (2, p))
    e, g = reference_qaoa.Qaoa64(n, edges, "cpu").cut_and_gradient(prm)
    e_t, g_t = reference_qaoa.tape_cut_and_gradient(n, edges, prm)
    assert abs(e - e_t) <= 1e-12 * e_t and np.abs(g - g_t).max() <= 1e-12


def test_adam_replay_is_torch_adam_in_float64():
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal((2, 3)) for _ in range(12)]
    params = torch.tensor(rng.standard_normal((2, 3)), dtype=torch.float64, requires_grad=True)
    start = params.detach().numpy().copy()
    opt = torch.optim.Adam([params], lr=0.05, betas=(0.9, 0.999), eps=1e-8, maximize=True)
    want = []
    for g in grads:
        want.append(params.detach().numpy().copy())
        params.grad = torch.from_numpy(g)
        opt.step()
    got = reference_qaoa.adam_replay(start, grads, 0.05)
    assert np.abs(np.array(got) - np.array(want)).max() <= 1e-14


@pytest.mark.parametrize("C,a,L,M", [(21, 2, 6, 5), (15, 7, 4, 4)])
def test_dagger_undoes_the_circuit(monkeypatch, C, a, L, M):
    monkeypatch.setattr(reference_grad, "SLAB", 1 << 5)
    psi = torch.from_numpy(reference.plain_state(C, a, L, M))
    back = reference_grad.dagger_(psi.clone(), C, a, L, M)
    e1 = torch.zeros_like(psi)
    e1[1] = 1.0
    assert float((back - e1).abs().max()) <= 1e-12
    v = torch.randn(1 << (L + M), dtype=torch.complex128, generator=torch.Generator().manual_seed(1))
    assert abs(float(reference_grad.dagger_(v.clone(), C, a, L, M).norm()) - float(v.norm())) <= 1e-12


def test_reference_gradient_is_the_adjoint_of_the_closed_form():
    C, a, L, M = 21, 2, 6, 5
    w = torch.rand(1 << (L + M), generator=torch.Generator().manual_seed(4), dtype=torch.float32)
    grad, loss = reference_grad.gradient(reference.ShorDistribution(C, a, L, M), w)
    psi = torch.from_numpy(reference.plain_state(C, a, L, M))
    assert abs(loss - float((w.double() * psi.abs() ** 2).sum())) <= 1e-12
    # the closed form's 2 w psi equals the gate-by-gate state's, so their adjoint runs agree
    want = reference_grad.dagger_(2 * w.double() * psi, C, a, L, M)
    assert float((grad - want).abs().max()) <= 1e-12


def test_byte_counts():
    s, t = 2 * 4 * 2**30, 2**30
    assert qaoa.cost_bytes(30, 4, "complex64") == 5 * (2 * s + t)
    assert qaoa.grad_bytes(30, 4, "complex64") == 3 * (4 * s + t) + 2 * s + t + 4 * 2 * s


# -- on the card ------------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("check", ["qaoa_kernels", "qaoa_adjoint"])
def test_qaoa_kernels_and_step_on_the_card(cuda_card, check):
    from quantumcomputer_tpu_torch.utils import kernel_checks

    assert getattr(kernel_checks, check)(torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [QAOA_CELL, GRAD_CELL])
def test_the_control_at_the_cells_size_is_not_correct(cuda_card, cell):
    from portbench import control

    rows = control.readings(cell, [2147483653], 2.0, ["complex32"])
    assert not rows[0]["correct"], rows
