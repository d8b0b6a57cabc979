"""The port never imports jax: a fresh interpreter imports the package, its
validation layer (profiling, experiments, debug), its probe kernels and
scripts, the Benes router and the card-only kernel checks, runs a 7-qubit
circuit, a norm trace, a few TABLE I shots, a tiny semiclassical attempt
(also at complex32), the Benes oracle path (plain segments,
strict_reference, dd64, nan_checks), a complex32 plan on bf16 planes and a
complex32 m_high plan whose walks merge into one strip pass, a checkpointed
run (segments, the Shor and semiclassical attempts), each generic algorithm
(Grover, BV / DJ, Simon, QPE in both forms, amplitude estimation, quantum
volume), the multi-device layer (parallel.mesh, comm, sharded,
sharded_semiclassical and launch: the 7-qubit circuit on a 2-shard CPU
mesh, its measured index against the single-device engine's, a sharded
semiclassical attempt and the mesh's collective report; the process
mesh's domain ordering; the dryrun script, imported), the package's
top-level exports, and checks that no jax or ml_dtypes module was
loaded.
chip_smoke.py is imported too (without running it), since it must run where
jax is absent.  A second interpreter runs the variational layer: a 4-qubit
VQE and QAOA for 3 steps each, one gradient through engine.run and
expectation_on_engine."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = """
import sys
import quantumcomputer_tpu_torch as q
import quantumcomputer_tpu_torch.cli
import quantumcomputer_tpu_torch.interop
import quantumcomputer_tpu_torch.ops.modperm
import quantumcomputer_tpu_torch.ops.probes
import quantumcomputer_tpu_torch.scripts.dcn_dryrun
import quantumcomputer_tpu_torch.scripts.prof_ae_drift
import quantumcomputer_tpu_torch.scripts.prof_benes
import quantumcomputer_tpu_torch.scripts.prof_chunkgather
import quantumcomputer_tpu_torch.scripts.prof_fused
import quantumcomputer_tpu_torch.scripts.prof_grad
import quantumcomputer_tpu_torch.scripts.prof_measure
import quantumcomputer_tpu_torch.scripts.prof_rowperm
import quantumcomputer_tpu_torch.scripts.prof_sharded
import quantumcomputer_tpu_torch.scripts.prof_strip
from quantumcomputer_tpu_torch.algorithms import semiclassical
from quantumcomputer_tpu_torch.algorithms import amplitude_estimation, grover, oracle_algorithms, qpe, quantum_volume, simon
from quantumcomputer_tpu_torch.sim import checkpoint
from quantumcomputer_tpu_torch.utils import debug, experiments, kernel_checks, profiling
from quantumcomputer_tpu_torch.ops import benes
from quantumcomputer_tpu_torch.sim import engine as tengine
from quantumcomputer_tpu_torch.parallel import comm, launch, mesh, sharded, sharded_semiclassical
from quantumcomputer_tpu_torch import (amplitude_estimate, bernstein_vazirani, build_mesh, deutsch_jozsa, estimate_phase,
                                       grover_circuit, grover_search, run_quantum_volume, run_semiclassical,
                                       ShardedStateVectorEngine, simon_search, __version__)
import chip_smoke

eng = q.StateVectorEngine(q.Register(L=3, M=4), backend="torch")
state = eng.run(q.shor_circuit(15, 7, 3, 4))
assert state.shape == (2, 128), state.shape
assert abs(eng.norm(state) - 1.0) < 1e-6
assert profiling.norm_trace(eng, q.shor_circuit(15, 7, 3, 4)).max_deviation < 1e-5
assert sum(experiments.omega_histogram(15, 7, 3, 4, runs=5, engine=eng).values()) == 5
assert abs(debug.check_normalisation(state) - 1.0) < 1e-5
rec = semiclassical.run_semiclassical(15, 7, 3, 4, [0.1, 0.6, 0.3], structured=True)
assert rec.x_tilde in range(8) and len(rec.branch_probs) == 3
assert len(benes.benes_route(list(range(16))[::-1])) == 7
circuit = q.shor_circuit(15, 7, 3, 4)
plan = tengine.plan_circuit(circuit, 4, 7, eng.real_dtype, "cpu", fuse_oracle=True)
planned = tengine.apply_circuit_fused_(eng.initial_state(), circuit, 4, plan, nan_checks=True)
assert float((planned - state).abs().max()) < 1e-6
strict = q.StateVectorEngine(q.Register(L=3, M=4), strict_reference=True)
assert abs(strict.norm(strict.run(circuit)) - 1.0) < 1e-6
assert q.algorithms.shor.shors_algorithm(15, 3, 4, forced_trial_int=7, seed=0, dtype="dd64").factors == (5, 3)
assert callable(kernel_checks.run_all)
import torch
c32 = semiclassical.run_semiclassical(15, 7, 3, 4, [0.1, 0.6, 0.3], dtype="complex32")
assert len(c32.bits) == 3
bf16 = tengine.apply_circuit_fused_(q.sim.statevec.initial_planar(7, torch.bfloat16), circuit, 4,
                                    tengine.plan_circuit(circuit, 4, 7, torch.bfloat16, "cpu"))
assert bf16.dtype == torch.bfloat16 and abs(float(q.sim.statevec.norm(bf16)) - 1.0) < 5e-3
from quantumcomputer_tpu_torch.ops import oracle
runs = []
strip = oracle.apply_camodc_run_inplace_planar
oracle.apply_camodc_run_inplace_planar = lambda *a, **k: runs.append(a[3]) or strip(*a, **k)
mh = q.shor_circuit_mhigh(15, 7, 4, 4)
mh_out = tengine.apply_circuit_fused_(q.sim.statevec.initial_planar(8, torch.bfloat16, 16), mh, 0,
                                      tengine.plan_circuit(mh, 0, 8, torch.bfloat16, "cpu"))
assert runs == [[0, 1, 2, 3]] and abs(float(q.sim.statevec.norm(mh_out)) - 1.0) < 5e-3, runs
import tempfile
with tempfile.TemporaryDirectory() as ck:
    seg = checkpoint.run_with_checkpoints(eng, circuit, ck, segment_gates=4)
    assert checkpoint.latest_segment(ck) == 3 and float((seg - state).abs().max()) < 1e-6
    assert checkpoint.load_state(checkpoint._segment_path(ck, 3))[0].shape == (2, 128)
    assert q.algorithms.shor.shors_algorithm(15, 3, 4, forced_trial_int=7, seed=0, checkpoint_dir=ck).factors == (5, 3)
    assert semiclassical.run_semiclassical(15, 7, 5, 4, [0.3] * 5, checkpoint_dir=ck, checkpoint_every=2).x_tilde < 32
assert grover.grover_search(5, 9, 0.4)[0] == 9
assert oracle_algorithms.bernstein_vazirani(6, 37) == 37 and oracle_algorithms.deutsch_jozsa(4, [])
assert simon.simon_search(4, 0b0110).s == 0b0110
ph = lambda j, c: [q.models.circuit.CPHASE(c, 0, 2 * 3.141592653589793 * 5 / 8 * (1 << j))]
assert qpe.estimate_phase(ph, 3, 1).x == 5
assert qpe.run_semiclassical_qpe(lambda j: [q.models.circuit.PHASE(0, 2 * 3.141592653589793 * 3 / 8 * (1 << j))], 3, 1).x == 3
assert abs(amplitude_estimation.amplitude_estimate(2, [0, 1], 3).a_hat - 0.5) < 1e-9
assert quantum_volume.run_quantum_volume(3, q.StateVectorEngine(q.Register(L=3, M=0), backend="torch"),
                                         num_circuits=2, shots=10).num_circuits == 2
two = mesh.build_mesh(2)
sh = sharded.ShardedStateVectorEngine(q.Register(L=3, M=4), mesh=two)
sh_state = sh.run(circuit)
assert len(sh_state) == 2 and sh_state[0].shape == (2, 64)
assert float((sh.to_planar(sh_state) - state).abs().max()) < 1e-6
assert sh.run_and_measure_index(circuit, 0.3) == eng.run_and_measure_index(circuit, 0.3)
assert profiling.mesh_collective_report(sh, circuit)["ppermute"]["count"] == 2
assert sharded_semiclassical.run_semiclassical_sharded(15, 7, 3, 4, [0.1, 0.6, 0.3], two).bits == rec.bits
assert isinstance(sh.comm, comm.LocalTransport) and comm.transport_for(two).local == (0, 1)
slots = [mesh.MeshDevice(torch.device("cpu"), process_index=p, id=i) for i, p in enumerate((1, 0, 1, 0))]
assert mesh.ici_degree(mesh.Mesh(mesh.order_devices_for_ici(slots))) == 1 and callable(launch.run)
assert __version__ == "0.3.0" and build_mesh is mesh.build_mesh
loaded = sorted(m for m in sys.modules if m in ("jax", "ml_dtypes") or m.startswith(("jax.", "jaxlib", "ml_dtypes.")))
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
    assert res.stdout.strip().splitlines()[-1] == "ok"


VARIATIONAL = """
import sys
import torch
import quantumcomputer_tpu_torch as q
from quantumcomputer_tpu_torch.algorithms import variational
from quantumcomputer_tpu_torch.models.circuit import dagger_circuit

terms = variational.tfim_hamiltonian(4)
res = q.vqe(terms, 4, depth=2, steps=3, device="cpu")
assert res.energies.shape == (3,) and res.state.shape == (16,)
cut = q.qaoa_maxcut(4, [(0, 1), (1, 2), (2, 3), (3, 0)], p=1, steps=3, device="cpu")
assert cut.optimal_cut == 4.0 and cut.expectations.shape == (3,)
eng = q.StateVectorEngine(q.Register(L=3, M=4), backend="torch")
circuit = q.shor_circuit(15, 7, 3, 4)
p = eng.initial_state().requires_grad_()
w = torch.randn(2, 128)
torch.sum(eng.run(circuit, p) * w).backward()
assert torch.allclose(p.grad, eng.run(dagger_circuit(circuit, 4), w.clone()))
assert abs(q.expectation_on_engine(eng, eng.run(circuit), terms) - float(q.expectation(eng.run(circuit), terms))) < 1e-5
loaded = sorted(m for m in sys.modules if m in ("jax", "ml_dtypes") or m.startswith(("jax.", "jaxlib", "ml_dtypes.")))
assert not loaded, loaded
assert "quantumcomputer_tpu" not in sys.modules
print("ok")
"""


def test_variational_layer_imports_no_jax():
    """The variational layer (VQE, QAOA, observables) and one gradient
    through engine.run in a fresh interpreter: no jax module is loaded."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", VARIATIONAL], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
