"""The port never imports jax: a fresh interpreter imports the package, runs
a 7-qubit circuit and checks that no jax module was loaded.  chip_smoke.py is
imported too (without running it), since it must run where jax is absent."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = """
import sys
import quantumcomputer_tpu_torch as q
import quantumcomputer_tpu_torch.cli
import quantumcomputer_tpu_torch.interop
import chip_smoke

eng = q.StateVectorEngine(q.Register(L=3, M=4), backend="torch")
state = eng.run(q.shor_circuit(15, 7, 3, 4))
assert state.shape == (2, 128), state.shape
assert abs(eng.norm(state) - 1.0) < 1e-6
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not loaded, loaded
assert "quantumcomputer_tpu" not in sys.modules
print("ok")
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", PROGRAM], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
