"""The plain reference against the circuit's definition and against the
port's plain path at tiny sizes."""

import numpy as np
import pytest
import torch

from portbench import reference as R


@pytest.mark.parametrize("C,a,L,M", [(15, 7, 3, 4), (15, 2, 4, 4), (21, 2, 6, 5), (33, 5, 7, 6), (8191, 3, 3, 13)])
def test_closed_form_equals_gate_by_gate(C, a, L, M):
    d = R.ShorDistribution(C, a, L, M)
    re, im = d.amplitudes(0, 1 << L)
    closed = (re + 1j * im).numpy().reshape(-1)
    assert np.abs(closed - R.plain_state(C, a, L, M)).max() < 1e-12
    p = np.abs(closed) ** 2
    cdf = np.cumsum(p)
    for i in np.random.default_rng(0).integers(0, 1 << (L + M), 64):
        assert abs(d.cdf(int(i)) - cdf[i]) < 1e-12
        assert abs(d.prob(int(i)) - p[i]) < 1e-12
    assert abs(d.total() - 1.0) < 1e-12


@pytest.mark.parametrize("C,a,L,M", [(15, 7, 3, 4), (21, 2, 6, 5)])
def test_closed_form_equals_the_ports_plain_path(C, a, L, M):
    from quantumcomputer_tpu_torch.algorithms import shor
    from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    eng = StateVectorEngine(Register(L, M), torch.complex128, backend="torch")
    d = R.ShorDistribution(C, a, L, M)
    assert d.state_gap(eng.run(shor_circuit(C, a, L, M))) < 1e-12
    for r in np.random.default_rng(1).random(50):
        rec = shor.find_period(eng, C, a, float(r))
        assert d.index_gap(rec.measured_index, float(r)) < 1e-12
        assert rec.omega == R.read_omega(rec.measured_index, L, M)
        assert rec.period == R.period_from_omega(rec.omega, a, C)


def test_index_gap_reads_how_far_a_draw_misses():
    d = R.ShorDistribution(15, 7, 3, 4)
    r = 0.3
    i = d.exact_index(r)
    assert d.index_gap(i, r) == 0.0
    j = i ^ (1 << 6)  # the counting register's top bit flipped
    assert d.index_gap(j, r) > 0.1


def test_order_and_continued_fractions():
    assert R.multiplicative_order(3, 8191) == 910
    assert R.multiplicative_order(2, 1060314373) == 622212
    assert R.multiplicative_order(7, 15) == 4
    assert R.period_from_omega(0.25, 7, 15) == 4
    assert R.period_from_omega(0.0, 7, 15) == 4  # denominator 1, multiples tried
    assert R.read_omega(0b100 << 8, 3, 8) == 0.125  # z = 0b100 reads y = 0b001, omega = 1/8


@pytest.mark.parametrize("C,a,L,M,dtype", [(15, 7, 8, 4, torch.complex64), (221, 5, 16, 8, torch.complex128),
                                           (2**16 - 3, 7, 20, 16, torch.complex64)])
def test_posterior_equals_the_ports_semiclassical_path(C, a, L, M, dtype):
    from quantumcomputer_tpu_torch.algorithms.semiclassical import find_period_semiclassical

    rs = np.random.default_rng(3).random(L, dtype=np.float32)
    period, rec = find_period_semiclassical(C, a, L, M, torch.from_numpy(rs), dtype=dtype, device="cpu")
    p0s = R.EigenphasePosterior(C, a, L).replay(rec.bits)
    assert R.sc_gap(p0s, rec.bits, rec.branch_probs, rs) < 1e-5
    assert rec.x_tilde == R.x_tilde(rec.bits)
    assert period == R.period_from_omega(R.x_tilde(rec.bits) / 2.0**L, a, C)


def test_sc_gap_reads_a_bit_against_its_draw():
    p0s, rs = [0.5, 0.9], [0.7, 0.2]
    assert R.sc_gap(p0s, [1, 0], [0.5, 0.9], rs) == 0.0
    assert R.sc_gap(p0s, [0, 0], [0.5, 0.9], rs) == pytest.approx(0.2)
    assert R.sc_gap(p0s, [1, 0], [0.5, 0.8], rs) == pytest.approx(0.1)


def test_period_search_matches_the_native_classical_layer():
    from quantumcomputer_tpu_torch.algorithms import _native, number_theory as nt

    if not _native.available():
        pytest.skip("the native classical layer did not build here (needs make and a C++ compiler)")
    for y in range(1 << 12):
        omega = y / 4096.0
        assert nt.find_period_from_omega(omega, 3, 8191) == R.period_from_omega(omega, 3, 8191)
