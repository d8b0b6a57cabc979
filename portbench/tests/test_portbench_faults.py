"""The comparison that decides `correct` fails what it has to: the control
(the program's lower-precision path, complex32) and each fault a cell can
have, planted under a run that skips the look for a card and drives the
rest, at a size a test run holds.  The limits are the committed ones.
A cell on one card has no exchange between chips to leave out."""

import pytest
import torch

from portbench.testing import run_small

FULL = ["shor8191-n28.gather", "shor8191-n28.benes", "shor8191-n28.gather-sweep"]
SC = "sc1060314373-m30.attempts"
# Registers at which the control's rounding shows: a full register of n = 19
# (the flagship's modulus and work register) and a semiclassical M = 16.
FULL_CTRL = {"C": 8191, "a": 3, "L": 6, "M": 13}
SC_CTRL = {"C": 2**16 - 3, "a": 7, "L": 20, "M": 16}


@pytest.mark.parametrize("workload", FULL + [SC])
def test_sound_runs_are_correct(workload):
    r = run_small(workload, seconds=0.3)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["shor8191-n28.gather", "shor8191-n28.gather-sweep"])
def test_control_is_not_correct_full_register(workload):
    ok = run_small(workload, seconds=0.5, config=FULL_CTRL)
    ctl = run_small(workload, seconds=0.5, config=dict(FULL_CTRL, precision="complex32"))
    assert ok["correct"], ok["checks"]
    assert not ctl["correct"], ctl["checks"]


def test_control_is_not_correct_semiclassical():
    ok = run_small(SC, seconds=0.5, config=SC_CTRL)
    ctl = run_small(SC, seconds=0.5, config=dict(SC_CTRL, precision="complex32"))
    assert ok["correct"], ok["checks"]
    assert not ctl["correct"], ctl["checks"]


def _unchanged_state(monkeypatch):
    from quantumcomputer_tpu_torch.sim.engine import StateVectorEngine

    monkeypatch.setattr(StateVectorEngine, "_run", lambda self, circuit, state, norms: self.initial_state())


def _half_left_out(monkeypatch):
    from quantumcomputer_tpu_torch.ops import measure

    orig = measure.sample_indices

    def half(planar, rs, *args, **kwargs):
        h = planar.clone()
        h[:, h.shape[1] // 2:] = 0  # the upper half left out; the draw scales by the rest's total
        return orig(h, rs, *args, **kwargs)

    monkeypatch.setattr(measure, "sample_indices", half)


def _answer_altered(monkeypatch):
    from quantumcomputer_tpu_torch.ops import measure

    orig = measure.sample_indices

    def altered(planar, rs, *args, **kwargs):
        n = planar.shape[1].bit_length() - 1
        return orig(planar, rs, *args, **kwargs) ^ (1 << (n - 1))

    monkeypatch.setattr(measure, "sample_indices", altered)


def _period_altered(monkeypatch):
    from quantumcomputer_tpu_torch.algorithms import number_theory

    orig = number_theory.find_period_from_omega
    monkeypatch.setattr(number_theory, "find_period_from_omega", lambda *a, **k: (orig(*a, **k) or 0) + 1)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_left_out, _answer_altered, _period_altered])
@pytest.mark.parametrize("workload", FULL)
def test_full_register_faults_are_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    r = run_small(workload, seconds=0.3)
    assert not r["correct"], (fault.__name__, r["checks"])


def _sc_unchanged_state(monkeypatch):
    from quantumcomputer_tpu_torch.algorithms import semiclassical

    orig = semiclassical._step

    def step(w, *args, **kwargs):
        bit, p, _, phi = orig(w.clone(), *args, **kwargs)
        return bit, p, w, phi

    monkeypatch.setattr(semiclassical, "_step", step)


def _sc_half_left_out(monkeypatch):
    from quantumcomputer_tpu_torch.algorithms import semiclassical

    orig = semiclassical._branch_sums

    def half(w, a1, s2, cdt):
        k = w.shape[1] // 2
        p0, p1 = orig(w[:, :k], a1[:, :k], s2, cdt)
        return 2 * p0, 2 * p1  # the mean over the half that is left, scaled up

    monkeypatch.setattr(semiclassical, "_branch_sums", half)


def _sc_answer_altered(monkeypatch):
    from quantumcomputer_tpu_torch.algorithms import semiclassical

    orig = semiclassical.collapse_from_a1

    def flipped(*args, **kwargs):
        bit, p, out = orig(*args, **kwargs)
        return torch.where(bit == 0, torch.ones_like(bit), torch.zeros_like(bit)), p, out

    monkeypatch.setattr(semiclassical, "collapse_from_a1", flipped)


@pytest.mark.parametrize("fault", [_sc_unchanged_state, _sc_half_left_out, _sc_answer_altered, _period_altered])
def test_semiclassical_faults_are_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = run_small(SC, seconds=0.3)
    assert not r["correct"], (fault.__name__, r["checks"])
