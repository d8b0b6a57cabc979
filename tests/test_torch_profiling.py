"""The port's profiling layer (quantumcomputer_tpu_torch/utils/profiling.py)
and the engine's norm trace, against the JAX package's utils/profiling.py
and tests/test_profiling.py: the timing helpers, the trace wrapper, and the
FIG. 2 norm trace at complex128 (1e-12 between the packages, 1e-13 from 1,
the JAX suite's bounds).  The spans are tests/test_torch_spans.py's."""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.models.shor_circuit import shor_circuit_reference as jshor_circuit_reference
from quantumcomputer_tpu.sim.engine import Register as JRegister
from quantumcomputer_tpu.sim.engine import StateVectorEngine as JEngine
from quantumcomputer_tpu.utils import profiling as jprof
from quantumcomputer_tpu_torch import Register, StateVectorEngine
from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit, shor_circuit_mhigh, shor_circuit_reference
from quantumcomputer_tpu_torch.sim import engine as tengine
from quantumcomputer_tpu_torch.utils import profiling as prof


@pytest.mark.parametrize("fuse", [True, False])
def test_time_circuit_runs(fuse):
    eng = StateVectorEngine(Register(L=3, M=4), backend="torch", fuse=fuse)
    assert prof.time_circuit(eng, shor_circuit(15, 7, 3, 4), iters=2) > 0
    assert prof.time_circuit_folded(eng, shor_circuit(15, 7, 3, 4), iters=2) > 0
    state = eng.initial_state()
    assert abs(prof.force_completion(eng.run(shor_circuit(15, 7, 3, 4), state)) - 1.0) < 1e-6


def test_norm_trace_fig2_matches_jax_per_gate():
    """Report §IV.A / FIG. 2, factoring 39 (L=6, M=6) gate for gate at
    complex128 with fusion off: the same per-gate trace in both packages."""
    C, a, L, M = 39, 7, 6, 6
    jeng = JEngine(JRegister(L=L, M=M), dtype=jnp.complex128, fuse=False)
    want = jprof.norm_trace(jeng, jshor_circuit_reference(C, a, L, M))
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch", fuse=False)
    tr = prof.norm_trace(eng, shor_circuit_reference(C, a, L, M))
    assert len(tr.deviations) == len(want.deviations) == 3 * 6 + 6 * 5 // 2
    np.testing.assert_allclose(tr.deviations, want.deviations, rtol=0, atol=1e-12)
    assert tr.max_deviation < 1e-13
    assert tr.to_dict()["max_deviation"] == tr.max_deviation


def test_run_with_norms_returns_the_state_and_a_cpu_trace():
    C, a, L, M = 39, 7, 6, 6
    circ = shor_circuit_reference(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch")
    state, norms = eng.run_with_norms(circ)
    assert norms.dtype == torch.float64 and norms.device.type == "cpu" and norms.shape == (len(circ),)
    assert torch.equal(state, eng.run(circ))
    given = eng.initial_state()
    out, _ = eng.run_with_norms(circ, given)
    assert out is given  # consumed in place, like run()
    _, norms32 = StateVectorEngine(Register(L=L, M=M), backend="torch").run_with_norms(circ)
    assert norms32.dtype == torch.float32
    _, empty = eng.run_with_norms(())
    assert empty.shape == (0,)


@pytest.mark.parametrize("layout", ["standard", "m_high"])
def test_fused_route_norms_one_per_plan_entry(layout):
    """The cuda backend's planned route, on CPU tensors (the kernels' plain
    versions): one norm per segment or single gate of the port's own plan,
    the last equal to the per-gate trace's last at 1e-12."""
    C, a, L, M = 39, 7, 9, 6
    n = L + M
    make_circuit = shor_circuit_mhigh if layout == "m_high" else shor_circuit
    circ = make_circuit(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch", layout=layout)
    _, per_gate = eng.run_with_norms(circ)
    m_eff = 0 if layout == "m_high" else M
    plan = tengine.plan_circuit(circ, m_eff, n, torch.float64, "cpu")
    norms: list = []
    tengine.apply_circuit_fused_(eng.initial_state(), circ, m_eff, plan, norms)
    assert len(norms) == len(plan) < len(circ)
    assert len(per_gate) == len(circ)
    assert abs(float(norms[-1]) - float(per_gate[-1])) < 1e-12
    assert max(abs(float(v) - 1.0) for v in norms) < 1e-12


def test_trace_writes_a_chrome_trace_and_warns_when_nested(tmp_path, caplog):
    eng = StateVectorEngine(Register(L=3, M=4), backend="torch")
    outer, inner = tmp_path / "outer.json", tmp_path / "inner.json"
    # Once the CLI has configured the package logger it no longer propagates
    # to the root logger, so caplog's handler goes on the logger itself.
    log = logging.getLogger("quantumcomputer_tpu_torch.profiling")
    log.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger=log.name):
            with prof.trace(str(outer)):
                with prof.trace(str(inner)):
                    eng.run(shor_circuit(15, 7, 3, 4))
    finally:
        log.removeHandler(caplog.handler)
    assert "already active" in caplog.text
    assert not inner.exists()
    assert "traceEvents" in json.loads(outer.read_text())
