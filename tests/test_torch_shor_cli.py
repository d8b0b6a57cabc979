"""The port's Shor algorithm and CLI (quantumcomputer_tpu_torch/algorithms/shor.py,
cli.py) against the JAX package's: the same print lines, validation messages,
exit codes and classical post-processing."""

import numpy as np
import pytest
import torch

from quantumcomputer_tpu import cli as jcli
from quantumcomputer_tpu.algorithms import shor as jshor
from quantumcomputer_tpu_torch import Register, StateVectorEngine, cli
from quantumcomputer_tpu_torch.algorithms import shor
from quantumcomputer_tpu_torch.utils import logging as tlog

FACTOR_15 = ["-C", "15", "-L", "3", "-M", "4", "-a", "7", "-v", "--seed", "0"]


@pytest.fixture(autouse=True)
def _reset_verbosity():
    yield
    tlog.configure(False, False)


def test_cli_factors_15(capsys):
    assert cli.main(FACTOR_15) == 0
    out = capsys.readouterr().out
    assert " --- Factors of 15 found: (5, 3)." in out
    assert " --- Forced trial integer a = 7, finding period ..." in out
    assert " --- Time to run Shor's Algorithm: " in out
    assert "*WARNING*" in out  # L=3 < recommended for C=15


def test_cli_very_verbose_phase_surface(capsys):
    assert cli.main(FACTOR_15[:-3] + ["-V", "--seed", "0"]) == 0
    out = capsys.readouterr().out
    for line in (
        "      - Performing quantum computation...",
        "         - Applying Hadamard matrices.",
        "         - Applying a^x mod (C) gates.",
        "         - Performing inverse quantum Fourier transform.",
        "      - Measuring state...",
        "      - Using continued fractions to guess period...",
        " --- Factors of 15 found: (5, 3).",
    ):
        assert line in out


def test_cli_trial_loop_and_complex128(capsys):
    assert cli.main(["-C", "21", "-L", "4", "-M", "5", "--dtype", "complex128", "--seed", "1", "-v"]) == 0
    out = capsys.readouterr().out
    assert " --- Factors of 21 found: (7, 3)." in out
    assert " --- Trial integer a = 2, finding period ..." in out


@pytest.mark.parametrize(
    "argv",
    [
        ["-C", "0", "-L", "3", "-M", "4"],
        ["-C", "15", "-L", "3", "-M", "4", "-a", "1"],
        ["-C", "15", "-L", "0", "-M", "4"],
        ["-C", "15", "-L", "30", "-M", "4"],
        ["-C", "15", "-L", "3", "-M", "4", "--dtype", "dd64", "--layout", "m_high"],
    ],
)
def test_bad_arguments_exit_2_with_the_jax_message(argv, capsys):
    want = jcli.validate(jcli.build_parser().parse_args(argv))
    assert want is not None
    assert cli.validate(cli.build_parser().parse_args(argv)) == want
    assert cli.main(argv) == 2
    assert capsys.readouterr().err.strip() == f"Error: {want}"


def test_missing_M_is_an_argparse_error():
    with pytest.raises(SystemExit) as e:
        cli.main(["-C", "15", "-L", "3"])
    assert e.value.code == 2


@pytest.mark.parametrize(
    "extra,flag",
    [
        (["--layout", "m_high"], "--layout m_high"),
        (["--semiclassical"], "--semiclassical"),
        (["--devices", "2"], "--devices > 1"),
        (["--oracle", "benes"], "--oracle benes"),
        (["--checkpoint-dir", "ck"], "--checkpoint-dir"),
        (["--strict-reference"], "--strict-reference"),
        (["--dtype", "complex32"], "--dtype complex32"),
        (["--dtype", "dd64"], "--dtype dd64"),
    ],
)
def test_unported_flags_exit_2(extra, flag, capsys):
    assert cli.main(["-C", "15", "-L", "3", "-M", "4", "-a", "7"] + extra) == 2
    err = capsys.readouterr().err
    assert err.strip() == f"Error: {flag} is not yet ported to quantumcomputer_tpu_torch."


def test_backend_cuda_without_a_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(FACTOR_15 + ["--backend", "cuda"]) == 2
    assert "needs a CUDA device" in capsys.readouterr().err


def test_read_omega_matches_jax():
    rng = np.random.default_rng(4)
    for L, M in ((3, 4), (12, 13), (17, 13)):
        for idx in rng.integers(0, 1 << (L + M), size=50):
            assert shor.read_omega(int(idx), L, M) == jshor.read_omega(int(idx), L, M)


def test_validate_and_factor_matches_jax():
    for C in (15, 21, 33, 35, 39, 8187):
        for a in range(2, min(C - 1, 40)):
            for period in range(1, 70):
                assert shor._validate_and_factor(C, a, period) == jshor._validate_and_factor(C, a, period)


def test_issue_warnings_match_jax():
    for C, L, M in ((15, 3, 4), (15, 8, 4), (21, 4, 3), (22, 9, 5), (13, 8, 4)):
        assert shor.issue_warnings(C, L, M) == jshor.issue_warnings(C, L, M)


def test_find_period_with_an_injected_draw():
    eng = StateVectorEngine(Register(L=8, M=4), backend="torch")
    rec = shor.find_period(eng, 15, 7, r=0.3)
    assert rec.omega == shor.read_omega(rec.measured_index, 8, 4)
    assert rec.omega in (0.0, 0.25, 0.5, 0.75)  # period 4: peaks at k/4
    assert rec.period in (None, 2, 4)


def test_shors_algorithm_is_seeded():
    runs = [shor.shors_algorithm(15, 8, 4, seed=3, backend="torch", max_attempts_per_a=2) for _ in range(2)]
    assert [r.measured_index for r in runs[0].attempts] == [r.measured_index for r in runs[1].attempts]
    assert runs[0].factors == (5, 3)
    assert shor.shors_algorithm(3, 8, 4).outcome is shor.Outcome.BAD_ARGUMENTS
