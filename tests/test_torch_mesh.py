"""The port's mesh, transport and per-device memory gates
(quantumcomputer_tpu_torch/parallel/mesh.py, comm.py, utils/memory.py)
against the JAX package's mesh on the 8 forced host devices: the same
shard counts, degrees and error messages."""

import jax
import pytest
import torch

from quantumcomputer_tpu.parallel import mesh as jmesh
from quantumcomputer_tpu_torch.parallel import mesh as tmesh
from quantumcomputer_tpu_torch.parallel.comm import LocalTransport
from quantumcomputer_tpu_torch.parallel.sharded_semiclassical import sharded_attempt_fits
from quantumcomputer_tpu_torch.utils.memory import mesh_fits

CPU = torch.device("cpu")


def test_default_mesh_takes_the_cpu_shards_as_jax_takes_its_devices():
    assert len(jax.devices()) == tmesh.CPU_SHARDS == 8
    mesh = tmesh.build_mesh()
    assert mesh.size == jmesh.build_mesh().shape[jmesh.AXIS] == 8
    assert mesh.devices == (CPU,) * 8 and mesh.shape == {"q": 8} and tmesh.AXIS == jmesh.AXIS
    for D in (1, 2, 4, 8):
        assert tmesh.mesh_degree(tmesh.build_mesh(D)) == jmesh.mesh_degree(jmesh.build_mesh(D))


@pytest.mark.parametrize(
    "kwargs",
    [{"num_devices": 6}, {"num_devices": 999}, {"num_devices": 3}, {"num_devices": 2, "devices": [CPU] * 4}],
    ids=["not_power_of_two", "more_than_available", "three", "conflicting"],
)
def test_build_mesh_errors_match_jax(kwargs):
    jkw = dict(kwargs)
    if "devices" in jkw:
        jkw["devices"] = jax.devices()[: len(jkw["devices"])]
    with pytest.raises(ValueError) as want:
        jmesh.build_mesh(**jkw)
    with pytest.raises(ValueError) as got:
        tmesh.build_mesh(**kwargs)
    assert str(got.value) == str(want.value)


def test_explicit_device_lists_may_repeat_a_device():
    mesh = tmesh.build_mesh(devices=[CPU] * 4)
    assert mesh.size == 4 and mesh.shards_on(CPU) == 4 and tmesh.mesh_degree(mesh) == 2
    assert tmesh.build_mesh(num_devices=4, devices=[CPU] * 4).size == 4
    with pytest.raises(ValueError, match="power-of-two"):
        tmesh.build_mesh(devices=[CPU] * 6)
    assert [tmesh.shard_range(mesh, 10, k) for k in range(4)] == [(0, 256), (256, 512), (512, 768), (768, 1024)]


def test_ppermute_delivers_the_sources_and_counts_link_bytes():
    comm = LocalTransport(tmesh.build_mesh(4))
    xs = [torch.full((2, 8), float(k)) for k in range(4)]
    got = comm.ppermute(xs, [(k, k ^ 1) for k in range(4)])
    assert [float(g[0, 0]) for g in got] == [1.0, 0.0, 3.0, 2.0]
    assert comm.stats["ppermute"] == {"count": 1, "bytes": 4 * 2 * 8 * 4}
    # A pytree operand (both planes in one collective) and a shard sending to itself.
    got = comm.ppermute([(x[0], x[1]) for x in xs], [(0, 0), (1, 2)])
    assert got[1] is None and got[3] is None and float(got[2][1][0]) == 1.0
    assert comm.stats["ppermute"] == {"count": 2, "bytes": 4 * 2 * 8 * 4 + 2 * 8 * 4}


def test_all_to_all_all_gather_and_psum():
    comm = LocalTransport(tmesh.build_mesh(2))
    blocks = [[torch.tensor([10.0 * e + k]) for k in range(2)] for e in range(2)]
    recv = comm.all_to_all(blocks)
    assert [[float(t) for t in r] for r in recv] == [[0.0, 10.0], [1.0, 11.0]]
    assert comm.stats["all_to_all"] == {"count": 1, "bytes": 2 * 4}  # blocks to itself cross no link
    assert comm.all_gather([torch.tensor(1.5), torch.tensor(2.5)]).tolist() == [1.5, 2.5]
    assert float(comm.psum([torch.tensor(1.5), torch.tensor(2.5)])) == 4.0
    assert comm.total_bytes() == 8 + 8 + 8
    comm.reset()
    assert comm.total_bytes() == 0


def test_memory_gates_count_every_shard_on_a_device(monkeypatch):
    """The budget of one device is divided among the shards that sit on it:
    four shards on one device need four times the bytes of one."""
    monkeypatch.setenv("QC_TPU_HBM_BYTES", str(1 << 20))  # a 1 MiB device
    one = tmesh.Mesh([CPU])
    four = tmesh.build_mesh(devices=[CPU] * 4)
    # (2, 2^15) float32 shard = 256 KiB.
    assert mesh_fits(4, 15, torch.float32, one)
    assert mesh_fits(1, 15, torch.float32, four) and not mesh_fits(2, 15, torch.float32, four)
    assert sharded_attempt_fits(14, torch.float32, tmesh.build_mesh(devices=[CPU] * 2))  # 6 x 2 x 64 KiB
    assert not sharded_attempt_fits(17, torch.float32, four)  # 6 x 4 x 256 KiB
    assert sharded_attempt_fits(17, torch.bfloat16, tmesh.build_mesh(devices=[CPU] * 8)) is False
    monkeypatch.delenv("QC_TPU_HBM_BYTES")
    assert not mesh_fits(2, 15, torch.float32, four)  # the budget recorded when the mesh was built
    assert mesh_fits(1000, 30, torch.float64, tmesh.build_mesh(devices=[CPU] * 4))  # no budget on the CPU
