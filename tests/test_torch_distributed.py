"""The port's process mesh (parallel/mesh.py world mesh, comm.ProcessTransport)
on CPU: gloo groups of 2 x 1, 4 x 1, 2 x 2 and 2 x 4 processes x shards.

Each layout's workers (tests/torch_mesh_worker.py) are started once, in a
module-scoped fixture, and run every case; the parametrised tests read
their shards and results.  Against LocalTransport on a one-process mesh of
the same size every case is equal bit for bit: states, norms, measured and
sampled indices, semiclassical bits and probabilities, the plan (every
rank's too), the counters (calls on every rank, bytes summed over the
ranks).  Against the JAX package (its single-device engine, or its
ShardedStateVectorEngine on the 8 forced devices) the tolerances are
tests/test_torch_sharded.py's: 1e-12 at complex128 and 3e-5 at complex64,
with equal indices; semiclassical bits equal and probabilities within
tests/test_torch_sharded_semiclassical.py's bounds.  The domain tests feed
the JAX package's test layouts to both packages."""

import json
import os
import pickle
import sys
from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumcomputer_tpu.models import circuit as jcir
from quantumcomputer_tpu.models import shor_circuit as jsc
from quantumcomputer_tpu.parallel import mesh as jmesh
from quantumcomputer_tpu.parallel import sharded_semiclassical as jss
from quantumcomputer_tpu.parallel.sharded import ShardedStateVectorEngine as JSharded
from quantumcomputer_tpu.sim.engine import Register as JRegister
from quantumcomputer_tpu.sim.engine import StateVectorEngine as JEngine
from quantumcomputer_tpu_torch import interop
from quantumcomputer_tpu_torch.parallel import comm as tcomm
from quantumcomputer_tpu_torch.parallel import launch
from quantumcomputer_tpu_torch.parallel import mesh as tmesh
from quantumcomputer_tpu_torch.parallel.sharded import ShardedStateVectorEngine
from quantumcomputer_tpu_torch.sim.engine import Register
from quantumcomputer_tpu_torch.utils.memory import mesh_fits
from tests.torch_mesh_worker import run_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
ATOL = 1e-12
C64_TOL = 3e-5
SC_TOL = {"complex64": 5e-6, "complex32": 1e-4}
LAYOUTS = [(2, 1), (4, 1), (2, 2), (2, 4)]  # processes x shards a process
WORKER_TIMEOUT_S = 420

_rng = np.random.default_rng(1234)
_U4 = np.linalg.qr(_rng.standard_normal((4, 4)) + 1j * _rng.standard_normal((4, 4)))[0]

# n = 6 (tests/test_torch_sharded.py's gate classes): qubits n - d .. 5 are
# global, and qubit 5, the top mesh bit, crosses processes in every layout.
GATE_CLASSES = {
    "hadamard_butterflies": tuple(jcir.H(q) for q in range(6)),
    "dense_1q": (jcir.H(5), jcir.X(4), jcir.RY(3, 0.7), jcir.RX(5, 1.1), jcir.Y(4)),
    "diagonals": (
        jcir.H(5), jcir.H(4), jcir.H(3), jcir.H(2), jcir.Z(5), jcir.PHASE(4, 0.33), jcir.RZ(3, -0.9),
        jcir.CPHASE(5, 4, 0.21), jcir.CPHASE(5, 1, 0.43), jcir.CPHASE(2, 0, 0.55), jcir.CZ(4, 0),
        jcir.CPHASE(1, 3, 0.66),
    ),
    "dense_2q_one_global": (
        jcir.H(5), jcir.H(2), jcir.H(0), jcir.CNOT(4, 1), jcir.CNOT(1, 4), jcir.SWAP(5, 0), jcir.U2Q(3, 2, _U4),
    ),
    "dense_2q_both_global": (
        jcir.H(5), jcir.H(3), jcir.H(1), jcir.CNOT(5, 4), jcir.CNOT(3, 5), jcir.SWAP(4, 3), jcir.U2Q(5, 3, _U4),
    ),
    "iqft_stages": tuple([jcir.H(q) for q in range(2, 6)] + [jcir.Gate("iqft_stage", (l,)) for l in (5, 4, 3, 2)]),
    "mcphase": (jcir.H(5), jcir.H(4), jcir.H(1), jcir.H(0), jcir.MCPHASE((5, 4, 1), 0.7), jcir.MCPHASE((5, 3), 0.2),
                jcir.MCPHASE((1, 0), -0.4)),
}


def _split_mhigh(C, a, L, M):
    """The m_high Shor circuit with a phase after its first oracle: a run of
    1 oracle (the packed row exchange) and a run of L - 1 >= D (a ladder)."""
    jc = jsc.shor_circuit_mhigh(C, a, L, M)
    first = next(i for i, g in enumerate(jc) if g.name == "camodc_high")
    return jc[: first + 1] + (jcir.PHASE(0, 0.3),) + jc[first + 1 :]


def _uniforms(seeds, dtype):
    return [float(jax.random.uniform(jax.random.PRNGKey(s), dtype=dtype)) for s in seeds]


@lru_cache(maxsize=None)
def _cases(D: int) -> dict:
    """Every case of a mesh of D shards: name -> spec, with "jc" the JAX
    circuit (the workers get the port's, through interop)."""
    d = D.bit_length() - 1
    cases = {f"gates_{name}": dict(kind="circuit", L=4, M=2, dtype="complex128", jc=jc)
             for name, jc in GATE_CLASSES.items()}
    cases["shor_standard"] = dict(kind="circuit", L=3, M=4, dtype="complex128", jc=jsc.shor_circuit(15, 7, 3, 4),
                                  report=True)
    cases["shor_mhigh"] = dict(kind="circuit", L=D + 1, M=6, dtype="complex128", layout="m_high",
                               jc=_split_mhigh(33, 7, D + 1, 6), report=True)
    L14 = 14 + d - 6  # n - d = 14: the fused path (the kernels' plain versions on CPU shards)
    cases["fused_c64_standard"] = dict(kind="circuit", L=L14, M=6, dtype="complex64", backend="cuda",
                                       jc=jsc.shor_circuit(33, 7, L14, 6))
    cases["fused_c64_mhigh"] = dict(kind="circuit", L=L14, M=6, dtype="complex64", backend="cuda", layout="m_high",
                                    jc=jsc.shor_circuit_mhigh(33, 7, L14, 6))
    cases["c32_standard"] = dict(kind="circuit", L=3, M=4, dtype="complex32", jc=jsc.shor_circuit(15, 7, 3, 4))
    cases["c32_mhigh"] = dict(kind="circuit", L=D + 1, M=6, dtype="complex32", layout="m_high",
                              jc=_split_mhigh(33, 7, D + 1, 6))
    cases["measure_c128"] = dict(kind="measure", L=3, M=4, dtype="complex128", jc=jsc.shor_circuit(15, 7, 3, 4),
                                 seeds=(0, 1, 2), rs=_uniforms((0, 1, 2), jnp.float64))
    L16 = 10 + d  # n - d = 16: every shard samples through its block sums
    cases["measure_c64_block_sums"] = dict(kind="measure", L=L16, M=6, dtype="complex64",
                                           jc=jsc.shor_circuit(33, 7, L16, 6), seeds=(3, 4),
                                           rs=_uniforms((3, 4), jnp.float32))
    # The gradient through the run's backward (the dagger circuit on the
    # cotangents), with qubit 6, the top mesh bit, in its exchanges.
    cases["adjoint"] = dict(kind="adjoint", L=4, M=3, dtype="complex128",
                            jc=jsc.shor_circuit(15, 7, 4, 3)[:4] + (jcir.RY(6, 0.3), jcir.CPHASE(6, 1, 0.4)),
                            w=np.random.default_rng(5).standard_normal((2, 1 << 7)))
    cases["sample"] = dict(kind="sample", L=3, M=4, dtype="complex128", jc=jsc.shor_circuit(15, 7, 3, 4), seed=9,
                           rs=np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (200,), dtype=jnp.float64)))
    for dtype in ("complex64", "complex32"):
        cases[f"semiclassical_{dtype}"] = dict(
            kind="semiclassical", args=(21, 2, 7, 5), dtype=dtype, seed=0,
            rs=np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (7,), dtype=jnp.float32)))
    cases["transport"] = dict(kind="transport")
    for spec in cases.values():
        if "jc" in spec:
            spec["circuit"] = interop.circuit_from_reference(spec["jc"])
    return cases


CASE_NAMES = list(_cases(2))


def _worker_specs(D: int) -> dict:
    return {name: {k: v for k, v in spec.items() if k != "jc"} for name, spec in _cases(D).items()}


@pytest.fixture(scope="module", params=LAYOUTS, ids=[f"{w}x{s}" for w, s in LAYOUTS])
def layout(request, tmp_path_factory):
    """Start the layout's workers once; every test of the layout reads what
    they wrote."""
    world, shards = request.param
    D = world * shards
    out = tmp_path_factory.mktemp(f"mesh_{world}x{shards}")
    with open(out / "cases.pkl", "wb") as f:
        pickle.dump(_worker_specs(D), f)
    commands = [[sys.executable, WORKER, "--rank", str(r), "--world", str(world), "--shards", str(shards),
                 "--dir", str(out)] for r in range(world)]
    ran = launch.run(commands, [str(out / f"worker{r}.log") for r in range(world)], timeout_s=WORKER_TIMEOUT_S)
    for r, (rc, log) in enumerate(ran):
        assert rc == 0, f"worker {r} of {world}x{shards} exited {rc}:\n{log[-4000:]}"
    ranks = []
    for r in range(world):
        with open(out / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    return {"world": world, "shards": shards, "D": D, "dir": out, "ranks": ranks}


@lru_cache(maxsize=None)
def _local(D: int, name: str) -> dict:
    """The case on a one-process mesh of D CPU shards (LocalTransport)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = run_case(_worker_specs(D)[name], tmesh.build_mesh(D))
    finally:
        torch.set_num_threads(threads)
    got["values"] = json.loads(json.dumps(got["values"]))
    return got


def _gathered(lay: dict, name: str) -> list:
    """The case's shards as the workers wrote them, in mesh order."""
    return [np.load(lay["dir"] / name / f"shard{k}.npy") if (lay["dir"] / name / f"shard{k}.npy").exists() else None
            for k in range(lay["D"])]


def _amplitudes(shards: list) -> np.ndarray:
    planar = np.concatenate(shards, axis=1).astype(np.float64)
    return planar[0] + 1j * planar[1]


def test_world_mesh_is_process_major(layout):
    world, shards, D = layout["world"], layout["shards"], layout["D"]
    for r, res in enumerate(layout["ranks"]):
        assert res["owners"] == [k // shards for k in range(D)]
        assert res["local"] == list(range(r * shards, (r + 1) * shards))


@pytest.mark.parametrize("name", CASE_NAMES)
def test_process_mesh_equals_local_transport(layout, name):
    """Bit for bit: shards, values and plan; counters: each rank makes
    every call, and the bytes its shards send sum to LocalTransport's."""
    D, ranks = layout["D"], layout["ranks"]
    want = _local(D, name)
    results = [res["cases"][name] for res in ranks]
    for res in results:
        values = res["values"]
        if name == "transport":  # what each shard received, keyed by shard: each rank holds its own
            values = {k: {s: r["values"][k][s] for r in results for s in r["values"][k]} if isinstance(v, dict) else v
                      for k, v in values.items()}
        assert values == want["values"]
        assert res["plan"] == want["plan"]
    if want["shards"][0] is not None:
        got = _gathered(layout, name)
        assert all(g is not None for g in got)
        for g, w in zip(got, want["shards"]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    if name.startswith("semiclassical"):
        summed = np.sum([res["stats"]["exchange_bytes"] for res in results], axis=0).tolist()
        assert summed == want["stats"]["exchange_bytes"]
        return
    for kind in tcomm.KINDS:
        assert all(res["stats"][kind]["count"] == want["stats"][kind]["count"] for res in results), kind
        assert sum(res["stats"][kind]["bytes"] for res in results) == want["stats"][kind]["bytes"], kind
    if want["stats"]["ppermute"]["count"] or want["stats"]["all_to_all"]["count"]:
        assert all(res["stats"]["crossing"] > 0 for res in results)


def test_transport_refuses_operands_of_another_shape(layout):
    assert all(res["cases"]["transport"]["refused"] is True for res in layout["ranks"])


@lru_cache(maxsize=None)
def _jax_state(D: int, name: str) -> np.ndarray:
    spec = _cases(D)[name]
    jdt = {"complex128": jnp.complex128, "complex64": jnp.complex64}[spec["dtype"]]
    eng = JEngine(JRegister(L=spec["L"], M=spec["M"]), dtype=jdt, backend="xla", layout=spec.get("layout", "standard"))
    if spec["kind"] == "adjoint":  # the gradient of sum(out * w): the dagger circuit applied to w
        return eng.to_numpy(eng.run(jcir.dagger_circuit(spec["jc"], spec["M"]), jnp.asarray(spec["w"])))
    return eng.to_numpy(eng.run(spec["jc"]))


STATE_CASES = [n for n in CASE_NAMES if n.startswith(("gates_", "shor_", "fused_c64", "adjoint"))]


@pytest.mark.parametrize("name", STATE_CASES)
def test_process_mesh_state_matches_jax(layout, name):
    spec = _cases(layout["D"])[name]
    tol = ATOL if spec["dtype"] == "complex128" else C64_TOL
    np.testing.assert_allclose(_amplitudes(_gathered(layout, name)), _jax_state(layout["D"], name), atol=tol)


@pytest.mark.parametrize("name", ["measure_c128", "measure_c64_block_sums", "sample"])
def test_process_mesh_indices_match_jax(layout, name):
    """The JAX mesh engine's measured / sampled indices for the keys whose
    uniforms the workers drew with."""
    D = layout["D"]
    spec = _cases(D)[name]
    jdt = {"complex128": jnp.complex128, "complex64": jnp.complex64}[spec["dtype"]]
    want = JSharded(JRegister(L=spec["L"], M=spec["M"]), dtype=jdt, mesh=jmesh.build_mesh(num_devices=D))
    if spec["kind"] == "sample":
        idx = np.asarray(want.sample(want.run(spec["jc"]), jax.random.PRNGKey(spec["seed"]), len(spec["rs"]))).tolist()
    else:
        idx = [int(want.measure(want.run(spec["jc"]), jax.random.PRNGKey(s))[0]) for s in spec["seeds"]]
    for res in layout["ranks"]:
        assert res["cases"][name]["values"]["indices"] == idx


@pytest.mark.parametrize("dtype", ["complex64", "complex32"])
def test_process_mesh_semiclassical_matches_jax(layout, dtype):
    D = layout["D"]
    spec = _cases(D)[f"semiclassical_{dtype}"]
    want = jss.run_semiclassical_sharded(*spec["args"], jax.random.PRNGKey(spec["seed"]),
                                         jmesh.build_mesh(num_devices=D), dtype=jnp.complex64 if dtype == "complex64"
                                         else "complex32")
    for res in layout["ranks"]:
        got = res["cases"][f"semiclassical_{dtype}"]["values"]
        assert got["bits"] == want.bits and got["overflow"] == 0
        np.testing.assert_allclose(got["probs"], want.branch_probs, atol=SC_TOL[dtype])


def test_reports_agree_on_every_rank(layout):
    """mesh_collective_report on the process mesh: the same report on every
    rank, equal to LocalTransport's."""
    for name in ("shor_standard", "shor_mhigh"):
        want = _local(layout["D"], name)["values"]["report"]
        assert want["total_bytes"] > 0
        assert all(res["cases"][name]["values"]["report"] == want for res in layout["ranks"])


# -- the world mesh's rules, without processes --------------------------------


def _slots(domains, device="cpu", cards=None):
    return [tmesh.MeshDevice(torch.device(device), process_index=dom, id=i,
                             card=cards[i] if cards else f"host{dom}/{device}") for i, dom in enumerate(domains)]


@dataclass(frozen=True)
class Dev:
    id: int
    slice_index: int


def test_ici_device_ordering_matches_jax():
    """tests/test_sharded.py::test_ici_device_ordering's layouts."""
    devs = [Dev(0, 1), Dev(1, 0), Dev(2, 1), Dev(3, 0), Dev(4, 0), Dev(5, 1), Dev(6, 0), Dev(7, 1)]
    assert tmesh.order_devices_for_ici(devs) == jmesh.order_devices_for_ici(devs)
    assert [d.id for d in tmesh.order_devices_for_ici(devs)[:4]] == [1, 3, 4, 6]
    flat = [Dev(i, 0) for i in (3, 1, 2, 0)]
    assert [d.id for d in tmesh.order_devices_for_ici(flat)] == [0, 1, 2, 3]
    # The port's slots group by their process, as jax's non-TPU devices do.
    slots = _slots([1, 0, 1, 0])
    assert [s.process_index for s in tmesh.order_devices_for_ici(slots)] == [0, 0, 1, 1]
    assert tmesh.comm_domain(slots[0]) == 1


def test_ici_degree_matches_jax():
    mesh = tmesh.build_mesh(8)  # one process: one domain
    assert tmesh.ici_degree(mesh) == jmesh.ici_degree(jmesh.build_mesh(num_devices=8)) == 3


def test_mesh_subset_is_domain_aligned_as_in_jax():
    """8 of 12 devices in 6+6 domains: 4+4, not the 6+2 prefix; 4 inside
    one domain; and two processes offering 8 each, asked for 8, land in one
    domain (why the dryrun offers 4 a process)."""
    devs = [Dev(i, i // 6) for i in range(12)]
    for target in (8, 4):
        want = jmesh._pick_subset(jmesh.order_devices_for_ici(devs), target)
        assert tmesh._pick_subset(tmesh.order_devices_for_ici(devs), target) == want
    assert sorted(d.slice_index for d in tmesh._pick_subset(tmesh.order_devices_for_ici(devs), 8)) == [0] * 4 + [1] * 4
    picked = tmesh._pick_subset(tmesh.order_devices_for_ici(_slots([0] * 8 + [1] * 8)), 8)
    assert {s.process_index for s in picked} == {0}
    with pytest.raises(ValueError, match="leaves rank 1 without a shard"):
        tmesh.Mesh(picked, rank=1)


def test_ici_degree_unequal_domains_matches_jax():
    class FakeMesh:
        def __init__(self, devs):
            self.devices = np.array(devs, dtype=object)
            self.shape = {"q": len(devs)}

    for domains in ([0, 0, 1, 1, 1, 1, 1, 1], [i % 2 for i in range(8)], [0, 0, 0, 0, 1, 1, 1, 1]):
        want = jmesh.ici_degree(FakeMesh([Dev(i, dom) for i, dom in enumerate(domains)]))
        assert tmesh.ici_degree(tmesh.Mesh(_slots(domains))) == want
    assert tmesh.ici_degree(tmesh.Mesh(_slots([0, 0, 1, 1, 1, 1, 1, 1]))) == 1


def test_memory_gates_count_the_shards_of_one_card_across_processes(monkeypatch):
    """Two processes with two shards each of one card: 4 shards against that
    card's budget; on two cards, 2 each.  Every rank decides alike from the
    budgets gathered at build time, whatever its own environment says."""
    one_card = _slots([0, 0, 1, 1], cards=["h/cuda-A"] * 4)
    two_cards = _slots([0, 0, 1, 1], cards=["h/cuda-A", "h/cuda-A", "h/cuda-B", "h/cuda-B"])
    shard = 2 * (1 << 15) * 4  # (2, 2^15) float32
    budgets = {"h/cuda-A": 4 * shard, "h/cuda-B": 4 * shard}
    for rank in (0, 1):
        shared = tmesh.Mesh(one_card, rank=rank, budgets=budgets)
        apart = tmesh.Mesh(two_cards, rank=rank, budgets=budgets)
        assert shared.shards_on(torch.device("cpu")) == 4 and apart.shards_on(torch.device("cpu")) == 2
        monkeypatch.setenv("QC_TPU_HBM_BYTES", str(1 << 10 + rank))  # ignored: the gathered budgets decide
        assert mesh_fits(1, 15, torch.float32, shared) and not mesh_fits(2, 15, torch.float32, shared)
        assert mesh_fits(2, 15, torch.float32, apart) and not mesh_fits(3, 15, torch.float32, apart)


def test_nccl_refuses_two_ranks_on_one_card():
    with pytest.raises(ValueError, match="NCCL takes one rank a card"):
        tcomm.check_nccl_cards(tmesh.Mesh(_slots([0, 1], cards=["h/cuda-A", "h/cuda-A"])))
    tcomm.check_nccl_cards(tmesh.Mesh(_slots([0, 1], cards=["h/cuda-A", "h/cuda-B"])))


def test_a_process_mesh_state_cannot_be_read_whole():
    """A state with another process's shards (None entries) raises where
    the whole state is needed, as the JAX package's fetch of a global array
    does across processes; the norm is a collective and needs no raise."""
    eng = ShardedStateVectorEngine(Register(3, 4), dtype=torch.complex128, mesh=tmesh.build_mesh(2))
    state = eng.run(interop.circuit_from_reference(jsc.shor_circuit(15, 7, 3, 4)))
    state[1] = None
    for read in (eng.to_planar, eng.to_numpy, eng.probabilities):
        with pytest.raises(RuntimeError, match="held by other processes"):
            read(state)
    with pytest.raises(ValueError, match="spans processes"):
        tcomm.LocalTransport(tmesh.Mesh(_slots([0, 1])))


def test_sharded_semiclassical_on_a_mesh_of_indexed_device_names():
    """A mesh named with device indices (cpu:0) holds shards whose tensors
    report `cpu`: the attempt's per-device factors follow the shards."""
    from quantumcomputer_tpu_torch.parallel.sharded_semiclassical import run_semiclassical_sharded

    rs = np.full(5, 0.4, np.float32)
    got = run_semiclassical_sharded(15, 7, 5, 4, rs, tmesh.build_mesh(devices=[torch.device("cpu", 0)] * 2))
    assert got.bits == run_semiclassical_sharded(15, 7, 5, 4, rs, tmesh.build_mesh(2)).bits
