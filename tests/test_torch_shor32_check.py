"""The closed form the card-only n = 32 check holds the m_high state to
(utils/kernel_checks.shor_mhigh_gaps), on the CPU at small registers:
against the circuit run gate by gate on the plain path, the index gap of
every index against its physical-order CDF interval, and the gaps a wrong
state or a wrong index read."""

import numpy as np
import pytest
import torch

from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit_mhigh
from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine
from quantumcomputer_tpu_torch.utils import kernel_checks as kc

CASES = [(21, 2, 6, 5), (15, 7, 4, 4), (33, 5, 5, 6), (8191, 3, 3, 13)]


def mhigh_state(C, a, L, M, dtype=torch.complex128):
    eng = StateVectorEngine(Register(L, M), dtype=dtype, layout="m_high")
    return eng, eng.run(shor_circuit_mhigh(C, a, L, M))


def test_orbit():
    r, x0, K = kc.shor_orbit(8191, 3, 19, 13)
    assert r == 910 and x0[1] == 0 and x0[3] == 1 and x0[0] == -1 and x0[8191] == -1
    assert K.max() == -(-(1 << 19) // 910) and (K > 0).sum() == 910


@pytest.mark.parametrize("C,a,L,M", CASES)
def test_closed_form_against_the_circuit(C, a, L, M):
    eng, state = mhigh_state(C, a, L, M)
    probs = (state[0] ** 2 + state[1] ** 2).numpy()
    cum = np.cumsum(probs)
    rng = np.random.default_rng(C + L)
    for phys in rng.choice(1 << (L + M), 40, replace=False).tolist() + [int(np.argmax(probs))]:
        index = eng.logical_index(phys)
        inside = float(cum[phys]) - 0.25 * float(probs[phys])  # a draw inside the index's interval
        gaps = kc.shor_mhigh_gaps(state, C, a, L, M, index, inside if probs[phys] > 0 else float(cum[phys]))
        assert gaps["state_gap"] < 1e-10 and gaps["index_gap"] < 1e-12
        assert kc.shor_mhigh_gaps(state, C, a, L, M, index, float(cum[phys]) + 1e-3)["index_gap"] > 9e-4


@pytest.mark.parametrize("C,a,L,M", CASES[:2])
def test_gaps_of_a_wrong_state(C, a, L, M):
    _, state = mhigh_state(C, a, L, M)
    std = state.view(2, 1 << M, 1 << L).transpose(1, 2).reshape(2, -1)  # the standard layout's order
    assert kc.shor_mhigh_gaps(std.contiguous(), C, a, L, M, 0, 0.0)["state_gap"] > 0.1


def test_the_check_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        kc.run_all("cpu")
