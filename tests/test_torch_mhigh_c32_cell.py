"""The port's complex32 m_high path, the path of the benchmark's
shor8189-n31-c32.mhigh cell, held to the plain reference's closed form in
physical order (portbench/mhigh.MhighDistribution) at a CPU size with the
matrix groups on the path, through the kernels' plain bf16 versions; and
the benchmark's control below bf16 storage (portbench/control_sub_bf16.py:
every plan entry rounded to fewer mantissa bits) failing the same limits."""

import contextlib

import numpy as np
import pytest
import torch

from portbench import control_sub_bf16, core, mhigh, reference
from portbench.tests.test_portbench_c32_cell import SMALL_C32, SMALL_C32_INDEX_GAP
from quantumcomputer_tpu_torch.algorithms import shor
from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit_mhigh
from quantumcomputer_tpu_torch.ops import fused
from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

CELL = "shor8189-n31-c32.mhigh"
C, A, L, M = (SMALL_C32[k] for k in ("C", "a", "L", "M"))
DRAWS = np.random.default_rng(2027).random(64)


def readings(drop=None):
    """(state_gap, widest index_gap over DRAWS, the engine) of one m_high
    complex32 run, below_bf16(drop) when `drop` is given."""
    eng = StateVectorEngine(Register(L, M), dtype="complex32", layout="m_high")
    d = mhigh.MhighDistribution(C, A, L, M)
    with control_sub_bf16.below_bf16(drop) if drop else contextlib.nullcontext():
        state = eng.run(shor_circuit_mhigh(C, A, L, M))
    picked = eng.sample(state, DRAWS.tolist())
    gap = max(d.index_gap(eng.logical_index(int(p)), float(r)) for p, r in zip(picked, DRAWS))
    return d.state_gap(state), gap, eng


def test_the_program_stays_within_the_cells_limits():
    """State and draws of the program within the cell's state_gap limit and
    this size's index_gap bound; the driver's omega and period are the
    reference's for the index it measures."""
    assert fused.groups(torch.bfloat16, L + M) and C == 13 * 17
    limits = core.cell(CELL)["limits"]
    state_gap, index_gap, eng = readings()
    assert state_gap <= limits["state_gap"]
    assert index_gap <= SMALL_C32_INDEX_GAP
    for r in DRAWS[:8]:
        rec = shor.find_period(eng, C, A, float(r))
        omega = reference.read_omega(rec.measured_index, L, M)
        assert rec.omega == omega and rec.period == reference.period_from_omega(omega, A, C)


@pytest.mark.parametrize("drop", [3, 4])
def test_the_control_below_bf16_fails_them(drop):
    """The same run with each plan entry rounded to 7 - drop mantissa bits
    fails the cell's state_gap limit and this size's index_gap bound, and
    reads worse than the program on both."""
    limits = core.cell(CELL)["limits"]
    program = readings()
    state_gap, index_gap, _ = readings(drop)
    assert state_gap > limits["state_gap"] and index_gap > SMALL_C32_INDEX_GAP
    assert state_gap > 3 * program[0] and index_gap > 3 * program[1]
