"""On a CUDA card: short runs of a cell through `portbench/run.py`, and the
control at the cell's own size.  Skipped without a card."""

import json
import subprocess
import sys

import pytest

from portbench.testing import CHECKOUT_ROOT


def run_py(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "portbench/run.py", *args], capture_output=True, text=True, timeout=1500, cwd=CHECKOUT_ROOT)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_on_the_card_is_correct(cuda_card, trace):
    out = run_py("--workload", "shor8191-n28.benes", "--seed", "2147483651", "--seconds", "2", "--trace", trace)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.cuda
def test_the_control_at_the_cells_size_is_not_correct(cuda_card):
    from portbench import control

    rows = control.readings("shor8191-n28.benes", [2147483652], 2.0, ["complex32"])
    assert not rows[0]["correct"], rows
