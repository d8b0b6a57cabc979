"""The port's debug helpers (quantumcomputer_tpu_torch/utils/debug.py) print
the same text as the JAX package's utils/debug.py for the same state, given
as a numpy vector, numpy planes or torch planes of either width."""

import numpy as np
import pytest
import torch

from quantumcomputer_tpu.utils import debug as jdebug
from quantumcomputer_tpu_torch import Register, StateVectorEngine, shor_circuit
from quantumcomputer_tpu_torch.utils import debug


def _shor_state():
    eng = StateVectorEngine(Register(L=3, M=4), dtype=torch.complex128, backend="torch")
    return eng.run(shor_circuit(15, 7, 3, 4))


def _forms(planar: torch.Tensor):
    """(port input, JAX input) pairs of one state."""
    host = planar.numpy()
    psi = host[0] + 1j * host[1]
    return [
        (psi, psi),
        (host, host),
        (planar, host),
        (planar.float(), host.astype(np.float32)),
        (torch.from_numpy(psi), psi),
    ]


@pytest.mark.parametrize("form", range(5))
def test_display_state_text_matches_jax(form, capsys):
    got_in, want_in = _forms(_shor_state())[form]
    text = debug.display_state(got_in)
    got_out = capsys.readouterr().out
    want = jdebug.display_state(want_in)
    assert text == want and got_out == capsys.readouterr().out
    assert debug.state_to_kets(got_in, 1e-9) == jdebug.state_to_kets(want_in, 1e-9)


@pytest.mark.parametrize("form", range(5))
def test_check_normalisation_text_matches_jax(form, capsys):
    got_in, want_in = _forms(_shor_state())[form]
    total = debug.check_normalisation(got_in)
    got_out = capsys.readouterr().out
    assert total == jdebug.check_normalisation(want_in)
    assert got_out == capsys.readouterr().out
    assert got_out.startswith("Total probability: ") and abs(total - 1.0) < 1e-6


def test_bad_shapes_raise_the_same_error():
    for bad in (np.zeros((3, 8)), np.zeros(6)):
        with pytest.raises(ValueError) as want:
            jdebug.state_to_kets(bad)
        with pytest.raises(ValueError) as got:
            debug.state_to_kets(torch.from_numpy(bad))
        assert str(got.value) == str(want.value)
