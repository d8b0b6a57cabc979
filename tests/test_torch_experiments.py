"""The port's validation experiments (quantumcomputer_tpu_torch/utils/
experiments.py) against the JAX package's utils/experiments.py and
tests/test_experiments.py.

TABLE I: fed the JAX package's own draws, the port's omega histogram equals
the JAX one count for count, in both layouts.  The JAX omega_histogram draws
run k's uniform from the key chain key, sub = split(key), and
_sample_index_planes (sim/engine.py:818) draws it as
uniform(sub, dtype=re.dtype), float64 for a complex128 engine; the test
derives the same numbers and hands them to the port as `rs`.  The p-value's
closed form must equal jax.scipy.special.gammaincc(1.5, chi2/2) at 1e-12."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from quantumcomputer_tpu.sim.engine import Register as JRegister
from quantumcomputer_tpu.sim.engine import StateVectorEngine as JEngine
from quantumcomputer_tpu.utils import experiments as jex
from quantumcomputer_tpu_torch import Register, StateVectorEngine
from quantumcomputer_tpu_torch.utils import experiments as ex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_draws(seed: int, runs: int) -> list:
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(runs):
        key, sub = jax.random.split(key)
        out.append(float(jax.random.uniform(sub, dtype=jnp.float64)))
    return out


@pytest.mark.parametrize("layout", ["standard", "m_high"])
def test_omega_histogram_equals_jax_on_the_same_draws(layout):
    runs, seed = 60, 5
    jeng = JEngine(JRegister(L=3, M=4), dtype=jnp.complex128, layout=layout)
    want = jex.omega_histogram(15, 7, 3, 4, runs=runs, seed=seed, engine=jeng)
    eng = StateVectorEngine(Register(L=3, M=4), dtype=torch.complex128, backend="torch", layout=layout)
    got = ex.omega_histogram(15, 7, 3, 4, runs=runs, engine=eng, rs=_jax_draws(seed, runs))
    assert got == want
    assert set(got) <= {0.0, 0.25, 0.5, 0.75} and sum(got.values()) == runs


def test_omega_histogram_default_draws_follow_the_seed():
    eng = StateVectorEngine(Register(L=3, M=4), dtype=torch.complex128, backend="torch")
    gen = torch.Generator().manual_seed(9)
    rs = [float(torch.rand((), generator=gen, dtype=torch.float64)) for _ in range(30)]
    assert ex.omega_histogram(15, 7, 3, 4, runs=30, seed=9, engine=eng) == ex.omega_histogram(
        15, 7, 3, 4, runs=30, engine=eng, rs=rs
    )
    with pytest.raises(ValueError, match="3 draws for 4 runs"):
        ex.omega_histogram(15, 7, 3, 4, runs=4, engine=eng, rs=[0.1, 0.2, 0.3])


@pytest.mark.parametrize("chi2", [0.0, 1e-6, 0.35, 1.0, 3.0, 7.81, 11.34, 16.27, 30.0, 60.0])
def test_p_value_equals_gammaincc(chi2):
    from jax.scipy.special import gammaincc

    assert abs(ex.chi2_p_value_dof3(chi2) - float(gammaincc(1.5, chi2 / 2.0))) < 1e-12


def test_table1_scripted_chi2():
    res = ex.table1_experiment(
        runs=400, seed=11, engine=StateVectorEngine(Register(L=3, M=4), dtype=torch.complex128, backend="torch")
    )
    assert res.passed, str(res)
    assert sum(res.counts.values()) == 400
    assert res.p_value > 0.001
    assert str(res).startswith("TABLE I (400 runs): w=0.00: ")


def test_table1_detects_broken_distribution():
    class Rigged:
        layout = "standard"
        register = Register(L=3, M=4)

        def run_and_measure_index(self, circuit, r):
            return 16  # always the same index -> omega = 1/2 always

        def logical_index(self, idx):
            return idx

    res = ex.table1_experiment(runs=100, seed=0, engine=Rigged())
    assert not res.passed
    assert res.counts == {0.0: 0, 0.25: 0, 0.5: 100, 0.75: 0}  # bit 4 is the last bit read: x~ = 4

    class Stray(Rigged):
        def run_and_measure_index(self, circuit, r):
            return 64  # bit 6 read first: x~ = 1, omega = 1/8, off the harmonics

    stray = ex.table1_experiment(runs=10, engine=Stray())
    assert not stray.passed and stray.chi2 == float("inf") and stray.counts == {0.125: 10}


def test_fig2_norm_deviation_trace_is_double_roundoff():
    tr = ex.norm_deviation_trace(39, 7, 6, 6)
    assert tr.max_deviation < 1e-13
    assert len(tr.deviations) == 3 * 6 + 6 * 5 // 2


def test_fig3_scaling_rows():
    rows_L, rows_M = ex.fig3_scaling(L_range=(3, 4), M_range=(5, 6), L_fixed=3, M_fixed=5, backend="torch", iters=1)
    assert [(r[0], r[1], r[2]) for r in rows_L] == [(3, 5, 8), (4, 5, 9)]
    assert [(r[0], r[1], r[2]) for r in rows_M] == [(3, 5, 8), (3, 6, 9)]
    assert all(r[3] > 0 for r in rows_L + rows_M)


def test_experiments_cli_exit_codes(capsys):
    assert ex.main(["--runs", "100", "--seed", "3"]) == 0
    assert "-> PASS" in capsys.readouterr().out
    assert ex.main(["--runs", "40", "--min-p", "1.0"]) == 1  # no p reaches 1
    assert "-> FAIL" in capsys.readouterr().out
    c32 = ["--dtype", "complex32", "--runs", "40"]  # ported: on the CPU here, as the JAX CLI runs pallas
    assert ex.main(c32) == jex.main(c32) == 0
    assert capsys.readouterr().out.count("TABLE I (40 runs)") == 2
    qv = ["--runs", "40", "--qv", "3"]  # ported: the JAX CLI's exit code and verdict
    assert ex.main(qv) == jex.main(qv) == 0
    out = capsys.readouterr().out
    assert out.count("QV m=3: mean HOP") == 2 and out.count("-> PASS (QV=8)") == 2
    with pytest.raises(SystemExit) as e:
        ex.main(["--dtype", "complex128"])
    assert e.value.code == 2


def test_experiments_module_runs():
    res = subprocess.run(
        [sys.executable, "-m", "quantumcomputer_tpu_torch.utils.experiments", "--runs", "40", "--fig3"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "TABLE I (40 runs)" in res.stdout
    assert "FIG.3 time vs L (M=5): L=3:" in res.stdout and "FIG.3 time vs M (L=3):" in res.stdout
