"""The CLI's register bound on a host with a CUDA card (cli.validate): 32
qubits, the reference's bound (qc_shor.c:68-73), run unsharded at
complex64 or complex32 when the card's budget (utils/memory.state_fits)
holds the state; anything else keeps the JAX package's answer.  The card is
faked present and its budget set through QC_TPU_HBM_BYTES, so no device is
touched."""

import pytest
import torch

from quantumcomputer_tpu import cli as jcli
from quantumcomputer_tpu_torch import cli

GIB = 1 << 30
JAX_31 = jcli.validate(jcli.build_parser().parse_args(["-C", "15", "-L", "19", "-M", "13"]))
REFERENCE_32 = "L + M > 32 qubits exceeds the index budget (the reference's own bound, qc_shor.c:68-73)."


def validate(argv):
    return cli.validate(cli.build_parser().parse_args(["-C", "8191", "-M", "13", "-a", "3"] + argv))


@pytest.fixture
def card(monkeypatch):
    """A CUDA card with `budget` usable bytes (the fixture's setter)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def budget(nbytes):
        monkeypatch.setenv("QC_TPU_HBM_BYTES", str(int(nbytes)))

    budget(73 * GIB)
    return budget


def test_jax_message_is_the_int32_bound():
    assert JAX_31.startswith("L + M > 31 qubits exceeds the int32 single-chip index budget")


@pytest.mark.parametrize("dtype", ["complex64", "complex32"])
@pytest.mark.parametrize("layout", ["m_high", "standard"])
def test_32_qubits_on_a_card_that_holds_the_state(card, dtype, layout):
    assert validate(["-L", "19", "--dtype", dtype, "--layout", layout]) is None
    assert validate(["-L", "19", "--dtype", dtype, "--layout", layout, "--backend", "cuda"]) is None


@pytest.mark.parametrize("dtype,need", [("complex64", 40 * GIB), ("complex32", 20 * GIB)])
def test_32_qubits_refused_where_the_budget_does_not_hold_the_state(card, dtype, need):
    """state_fits: the state and the oracle's half-plane temporary, 1.25
    states (40 GiB at complex64, 20 GiB at complex32)."""
    card(need)
    assert validate(["-L", "19", "--dtype", dtype, "--layout", "m_high"]) is None
    card(need - 1)
    assert validate(["-L", "19", "--dtype", dtype, "--layout", "m_high"]) == JAX_31


@pytest.mark.parametrize("extra", [
    ["--backend", "torch"],
    ["--strict-reference"],
    ["--devices", "1", "--dtype", "dd64"],
])
def test_other_routes_keep_the_jax_answer(card, extra):
    argv = ["-C", "8191", "-M", "13", "-a", "3", "-L", "19"] + extra
    theirs = [{"torch": "xla"}.get(x, x) for x in argv]  # backend names translated
    want = jcli.validate(jcli.build_parser().parse_args(theirs))
    assert want is not None
    assert cli.validate(cli.build_parser().parse_args(argv)) == want


@pytest.mark.parametrize("dtype", ["complex64", "complex32", "complex128"])
def test_33_qubits_keep_the_reference_message(card, dtype):
    card(1 << 50)
    assert validate(["-L", "20", "--dtype", dtype, "--layout", "m_high"]) == REFERENCE_32


def test_31_qubits_unchanged_on_a_card(card):
    assert validate(["-L", "18", "--layout", "m_high"]) is None


@pytest.mark.parametrize("dtype", ["complex64", "complex32"])
def test_no_card_keeps_the_jax_answer(monkeypatch, dtype):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("QC_TPU_HBM_BYTES", str(73 * GIB))
    argv = ["-C", "8191", "-M", "13", "-a", "3", "-L", "19", "--dtype", dtype, "--layout", "m_high"]
    want = jcli.validate(jcli.build_parser().parse_args(argv))
    assert cli.validate(cli.build_parser().parse_args(argv)) == want == JAX_31


def test_main_exits_2_at_33_qubits(card, capsys):
    assert cli.main(["-C", "8187", "-L", "20", "-M", "13", "--layout", "m_high", "--seed", "0"]) == 2
    assert capsys.readouterr().err.strip() == f"Error: {REFERENCE_32}"
