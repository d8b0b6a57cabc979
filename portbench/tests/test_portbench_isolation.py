"""Nothing the benchmark runs imports jax or the JAX package (whole
top-level names: the port's name begins with the JAX package's); the
reference imports nothing of the port; the run exits without a result
where it cannot measure."""

import json
import os
import shutil
import subprocess
import sys

from portbench.testing import CHECKOUT_ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "quantumcomputer_tpu"}


def tops_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {CHECKOUT_ROOT!r})\n{code}\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        capture_output=True, text=True, timeout=300, cwd=CHECKOUT_ROOT,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))


def test_harness_and_a_run_load_no_jax():
    tops = tops_after(
        "from portbench import core, control, layers, reference, full_register, semiclassical_runner\n"
        "from portbench.testing import run_small\n"
        "[core.load_module('generators', n) for n in core.names('generators', '.py')]\n"
        "core.metric_modules()\n"
        "run_small('shor8191-n28.gather', trace=True)\n"
        "run_small('sc1060314373-m30.attempts', seconds=0.1)"
    )
    assert "quantumcomputer_tpu_torch" in tops and "portbench" in tops
    assert not tops & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    tops = tops_after("from portbench import reference")
    assert not tops & (FORBIDDEN | {"quantumcomputer_tpu_torch"})


def run_py(cwd: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "shor8191-n28.gather", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=env,
    )


def test_run_without_a_card_prints_no_result():
    out = run_py(CHECKOUT_ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_run_with_only_the_benchmark_files_prints_no_result(tmp_path):
    shutil.copytree(os.path.join(CHECKOUT_ROOT, "portbench"), tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(CHECKOUT_ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = run_py(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
    # Past the look for a card the program itself is missing: core.run cannot set up a cell.
    code = (
        "import sys, time; sys.path.insert(0, '.')\n"
        "from portbench import core\n"
        "try:\n    core.run('shor8191-n28.gather', 1, 0.1, False, time.perf_counter(), device='cpu')\n"
        "except ImportError:\n    sys.exit(9)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 9, out.stderr[-2000:]
