"""The port as a package: what its wheel carries, one kernel build for
several processes, the names it exports, and a recorded departure from the
JAX package (semiclassical dtype strings)."""

import ast
import fnmatch
import os
import subprocess
import sys
import tomllib

import jax.numpy as jnp
import pytest

import quantumcomputer_tpu_torch as port
from quantumcomputer_tpu.algorithms import shor as jshor
from quantumcomputer_tpu_torch.algorithms import shor
from quantumcomputer_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "quantumcomputer_tpu_torch")


def test_package_data_carries_every_kernel_source():
    """Every file the kernel build compiles or hashes (``.cu`` and the
    ``.cuh`` headers they include) is matched by a package-data glob, so an
    installed port can build its kernels."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["quantumcomputer_tpu_torch"]
    sources = [os.path.relpath(p, PACKAGE) for p in _build.sources()]
    assert any(s.endswith(".cuh") for s in sources) and any(s.endswith(".cu") for s in sources)
    for src in sources:
        assert any(fnmatch.fnmatch(src, g) for g in globs), f"{src} is in no package-data glob {globs}"
    with open(os.path.join(PACKAGE, "ops", "csrc", "fused_segment.cu")) as f:
        assert '#include "fused_segment.cuh"' in f.read()


BUILDER = """
import os, sys, time
from quantumcomputer_tpu_torch.ops import _build
build_dir, me = sys.argv[1], sys.argv[2]
_build._BUILD_DIR = build_dir
def stub(out):
    t0 = time.time()
    time.sleep(1.0)
    with open(out, "w") as f:
        f.write("library")
    print("built", t0, time.time(), flush=True)
_build._build = stub
open(os.path.join(build_dir, "ready" + me), "w").close()
while not all(os.path.exists(os.path.join(build_dir, "ready" + i)) for i in "01"):
    time.sleep(0.01)
t0 = time.time()
_build._build_once(os.path.join(build_dir, "libqc_kernels_stub.so"))
print("done", t0, time.time(), flush=True)
"""


def test_build_lock_serialises_two_builders(tmp_path):
    """Two processes that need the library at once: one builds (a stub
    build of 1 s), the other waits on the lock and builds nothing."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", BUILDER, str(tmp_path), str(i)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    lines = [dict((ln.split()[0], [float(v) for v in ln.split()[1:]]) for ln in out.splitlines()) for out, _ in outs]
    builders = [i for i, d in enumerate(lines) if "built" in d]
    assert len(builders) == 1, lines
    waiter = lines[1 - builders[0]]
    built_at = lines[builders[0]]["built"][1]
    assert waiter["done"][1] >= built_at and waiter["done"][1] - waiter["done"][0] > 0.5
    assert (tmp_path / "libqc_kernels_stub.so").read_text() == "library"


def test_port_exports_the_jax_package_names():
    """The JAX package's top-level names (its __init__'s imports and
    __version__), less DDStateVectorEngine (the double-float engine is
    removed by design: the card runs complex128), are names of the port."""
    with open(os.path.join(ROOT, "quantumcomputer_tpu", "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom) for a in node.names}
    assert {"grover_search", "build_mesh", "ShardedStateVectorEngine", "run_semiclassical"} <= names
    missing = sorted(n for n in names - {"DDStateVectorEngine"} if not hasattr(port, n))
    assert not missing, missing
    assert port.__version__ == "0.3.0"


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_semiclassical_dtype_strings_depart_from_jax(dtype):
    """shors_algorithm(semiclassical=True) with dtype given as the string
    "complex64" or "complex128": the JAX package raises, the port factors
    (documented in the port's shors_algorithm)."""
    with pytest.raises(ValueError, match="semiclassical mode supports complex32/complex64/complex128/dd64"):
        jshor.shors_algorithm(15, 3, 4, forced_trial_int=7, seed=0, semiclassical=True, dtype=dtype)
    res = shor.shors_algorithm(15, 3, 4, forced_trial_int=7, seed=0, semiclassical=True, dtype=dtype)
    assert res.ok and res.factors == (5, 3)
    assert '"complex64" and "complex128", which the JAX package' in " ".join(shor.shors_algorithm.__doc__.split())
    jres = jshor.shors_algorithm(15, 3, 4, forced_trial_int=7, seed=0, semiclassical=True,
                                 dtype={"complex64": jnp.complex64, "complex128": jnp.complex128}[dtype])
    assert jres.factors == (5, 3)
