"""The port's Shor algorithm and CLI (quantumcomputer_tpu_torch/algorithms/shor.py,
cli.py) against the JAX package's: the same print lines, validation messages,
exit codes and classical post-processing."""

import logging
import os

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


# Semiclassical argument sets the JAX package refuses: each of its
# semiclassical checks (quantumcomputer_tpu/cli.py:115-168), in its order.
SEMICLASSICAL_BAD = [
    ["-C", "15", "-L", "3", "-M", "3", "--semiclassical"],
    ["-C", "15", "-L", "3", "-M", "31", "--semiclassical"],
    ["-C", "15", "-L", "53", "-M", "4", "--semiclassical"],
    ["-C", "1073741824", "-L", "3", "-M", "30", "--semiclassical"],
    ["-C", "15", "-L", "3", "-M", "4", "--semiclassical", "--devices", "32"],
    ["-C", "15", "-L", "3", "-M", "4", "--semiclassical", "--layout", "m_high"],
    ["-C", "15", "-L", "3", "-M", "4", "--semiclassical", "--strict-reference"],
    ["-C", "15", "-L", "3", "-M", "4", "--semiclassical", "--dtype", "dd64", "--devices", "2"],
    ["-C", "15", "-L", "3", "-M", "4", "--semiclassical", "--dtype", "dd64", "--checkpoint-dir", "ck"],
    ["-C", "15", "-L", "3", "-M", "4", "--semiclassical", "--checkpoint-dir", "ck", "--devices", "2"],
    ["-C", "15", "-L", "0", "-M", "4", "--semiclassical"],
    ["-C", "15", "-L", "3", "-M", "4", "-a", "14", "--semiclassical"],
]


@pytest.mark.parametrize(
    "argv",
    [
        ["-C", "0", "-L", "3", "-M", "4"],
        ["-C", "15", "-L", "3", "-M", "4", "-a", "1"],
        ["-C", "15", "-L", "0", "-M", "4"],
        ["-C", "15", "-L", "30", "-M", "4"],
        ["-C", "15", "-L", "16", "-M", "16"],
        ["-C", "15", "-L", "3", "-M", "4", "--dtype", "dd64", "--layout", "m_high"],
        ["-C", "15", "-L", "3", "-M", "4", "--layout", "m_high", "--devices", "32"],
    ]
    + SEMICLASSICAL_BAD,
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


NEEDS_A_CARD = "Error: --backend cuda needs a CUDA device, and none is available."


@pytest.mark.parametrize(
    "extra,line",
    [
        # Ported: --devices 2 shards the state (test_devices_rows_match_the_jax_cli);
        # more shards than the host offers exits 2 as the JAX CLI does.
        (["--devices", "16"], "Error: requested 16 devices, only 8 available"),
        # Ported: the full register at complex32 runs on the cuda backend's
        # path, on the CPU here through the plain versions; --backend cuda
        # still needs a card.
        (["--dtype", "complex32", "--backend", "cuda"], NEEDS_A_CARD),
    ],
)
def test_unported_flags_exit_2(extra, line, capsys):
    assert cli.main(["-C", "15", "-L", "3", "-M", "4", "-a", "7"] + extra) == 2
    assert capsys.readouterr().err.strip() == line


@pytest.mark.parametrize("extra", [[], ["--semiclassical"]], ids=["full_register", "semiclassical"])
def test_checkpoint_dir_matches_the_jax_cli(extra, tmp_path, capsys):
    """--checkpoint-dir (the README's example) gives the JAX CLI's exit code
    and factors, and this package's own factors without the flag; the
    attempt directories are removed once the attempts complete."""
    argv = ["-C", "21", "-L", "4", "-M", "5", "-a", "2", "--seed", "1"] + extra
    want = jcli.main(argv + ["--checkpoint-dir", str(tmp_path / "jax")])
    want_out = capsys.readouterr().out
    got = cli.main(argv + ["--checkpoint-dir", str(tmp_path / "port")])
    got_out = capsys.readouterr().out
    plain = cli.main(argv)
    plain_out = capsys.readouterr().out
    assert got == want == plain == 0
    line = " --- Factors of 21 found: (7, 3)."
    assert line in got_out and line in want_out and line in plain_out
    assert not os.path.isdir(tmp_path / "port") or os.listdir(tmp_path / "port") == []


@pytest.mark.parametrize(
    "extra,flag",
    [
        (["--devices", "2"], None),  # ported: the sharded work register, on 2 CPU shards here
        (["--dtype", "complex32"], None),  # ported: runs on the CPU here
    ],
)
def test_unported_semiclassical_flags_exit_2(extra, flag, capsys):
    rc = cli.main(["-C", "15", "-L", "3", "-M", "4", "-a", "7", "--semiclassical", "--seed", "0"] + extra)
    captured = capsys.readouterr()
    assert flag is None
    assert rc == 0 and " --- Factors of 15 found: (5, 3)." in captured.out


@pytest.mark.parametrize(
    "extra,line",
    [
        (["--oracle", "benes"], "oracle='benes' requires the single-chip cuda backend; falling back to the gather oracle"),
        (["--strict-reference"], None),
        (["--dtype", "dd64"], None),
        (["--semiclassical", "--dtype", "dd64"], None),
    ],
)
def test_cli_factors_15_with_the_ported_flags(extra, line, capsys, caplog):
    """The flags this package once refused: on a CPU host --oracle benes
    logs the JAX package's warning and runs the gather; --strict-reference
    runs the warn-and-wrap oracle on the torch backend; dd64 runs complex128."""
    logger = logging.getLogger("quantumcomputer_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        assert cli.main(FACTOR_15 + extra) == 0
    finally:
        logger.removeHandler(caplog.handler)
    assert " --- Factors of 15 found: (5, 3)." in capsys.readouterr().out
    assert line is None or any(line in r.getMessage() for r in caplog.records)


def _namespace(argv):
    return cli.build_parser().parse_args(argv), jcli.build_parser().parse_args(argv)


@pytest.mark.parametrize("LM", [31, 32, 33])
@pytest.mark.parametrize("devices", [1, 2])
@pytest.mark.parametrize("dtype", ["complex64", "complex128", "complex32", "dd64"])
@pytest.mark.parametrize("semiclassical", [False, True])
def test_validate_equals_jax_over_the_grid(LM, devices, dtype, semiclassical):
    """The L + M bounds (with the --devices term), dtypes and
    --semiclassical: both packages' validate give the same answer."""
    argv = ["-C", "15", "-L", str(LM - 13), "-M", "13", "--devices", str(devices), "--dtype", dtype]
    argv += ["--semiclassical"] if semiclassical else []
    ours, theirs = _namespace(argv)
    assert cli.validate(ours) == jcli.validate(theirs)


def test_devices_2_at_32_qubits_reaches_not_ported(capsys):
    """32 qubits over 2 devices passes validation in both packages (the
    port no longer refuses --devices); asking for more devices than the
    host has then exits 2 with the JAX CLI's message, before any state."""
    argv = ["-C", "15", "-L", "16", "-M", "16", "--devices", "2"]
    assert jcli.validate(jcli.build_parser().parse_args(argv)) is None
    assert cli.validate(cli.build_parser().parse_args(argv)) is None
    argv[-1] = "16"
    assert jcli.main(argv) == 2
    want = capsys.readouterr().err.strip()
    assert cli.main(argv) == 2
    assert capsys.readouterr().err.strip() == want == "Error: requested 16 devices, only 8 available"


def test_cli_factors_15_in_the_mhigh_layout(capsys):
    assert cli.main(FACTOR_15 + ["--layout", "m_high"]) == 0
    assert " --- Factors of 15 found: (5, 3)." in capsys.readouterr().out


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


FACTOR_15_SEED = ["-C", "15", "-L", "3", "-M", "4", "-a", "7", "--seed", "0"]
DEVICES_ROWS = {
    "devices_2": ["--devices", "2"],
    "devices_4_m_high": ["--devices", "4", "--layout", "m_high"],
    "complex32_devices_2": ["--dtype", "complex32", "--devices", "2", "-v"],  # tests/test_cli.py:117
    "semiclassical_devices_4": ["--semiclassical", "--devices", "4", "-v"],  # tests/test_semiclassical.py:407
    "dd64_devices_4": ["--dtype", "dd64", "--devices", "4"],  # tests/test_sharded_dd.py:122
    "benes_devices_2": ["--oracle", "benes", "--devices", "2"],
    "strict_reference_devices_2": ["-M", "3", "--strict-reference", "--devices", "2"],  # test_strict_reference.py:99
    "semiclassical_devices_16": ["--semiclassical", "--devices", "16"],  # tests/test_semiclassical.py:405
    "devices_3": ["--devices", "3"],
}


@pytest.mark.parametrize("extra", list(DEVICES_ROWS.values()), ids=list(DEVICES_ROWS))
def test_devices_rows_match_the_jax_cli(extra, capsys):
    """--devices N on the CPU's 8 shards: the JAX CLI's exit code, its
    " --- Sharding state vector over N device(s)." and factors lines, and
    its error line."""
    argv = FACTOR_15_SEED + extra
    keep = lambda out: [line for line in out.splitlines() if "Sharding" in line or "Factors of" in line]
    want_rc = jcli.main(argv)
    want = capsys.readouterr()
    got_rc = cli.main(argv)
    got = capsys.readouterr()
    assert got_rc == want_rc
    assert keep(got.out) == keep(want.out)
    errors = lambda err: [line for line in err.splitlines() if line.startswith("Error:")]
    # Backend names translated as in cli.validate: xla -> torch.
    assert errors(got.err) == [line.replace("xla backend", "torch backend") for line in errors(want.err)]
    if want_rc == 0:
        assert " --- Factors of 15 found: (5, 3)." in got.out
        assert f" --- Sharding state vector over {extra[extra.index('--devices') + 1]} device(s)." in got.out
