"""The mesh of shards a distributed state vector lives on.

The counterpart of the JAX package's ``parallel/mesh.py``.  The 2^n
amplitude vector is sharded over its leading global index bits: with
D = 2^d shards, shard k holds the contiguous index range
[k * 2^(n-d), (k+1) * 2^(n-d)), so the top d qubits [n-d, n) are global
(their bit values select the shard) and the rest are shard-local.  A state
is a list of D planar (2, 2^(n-d)) tensors, shard k on the mesh's device k.

The JAX package runs one program over D devices (``shard_map``); here one
process holds every shard and the exchanges between them are explicit
copies (``parallel/comm.py``).  A device may hold several shards: an
explicit ``devices=`` list may repeat a device, as XLA's forced host device
count makes virtual devices of one CPU.  With no list, ``build_mesh``
takes distinct devices: the visible CUDA cards, or, on a host with no card,
``CPU_SHARDS`` virtual shards of the CPU (the device count the JAX
package's CPU tests force).

Not here: the communication-domain ordering of the JAX mesh
(``comm_domain``, ``order_devices_for_ici``, ``ici_degree``).  It only
means something across processes and hosts, and comes with a transport
over ``torch.distributed``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

#: The mesh axis name, as in the JAX package.
AXIS = "q"

#: Virtual shards a host with no CUDA card offers: the JAX package's tests
#: force 8 CPU devices (tests/conftest.py).
CPU_SHARDS = 8


class Mesh:
    """A 1-D mesh of 2^d shard slots, each naming the device its shard
    lives on (a device may repeat)."""

    def __init__(self, devices: Sequence):
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(dv) for dv in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {AXIS: self.size}

    def shards_on(self, device) -> int:
        """How many of the mesh's shards live on `device`."""
        device = torch.device(device)
        return sum(dv == device for dv in self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(dv) for dv in self.devices]})"


def available_devices() -> list:
    """The distinct devices a mesh may take when none are named: every
    visible CUDA card, else CPU_SHARDS virtual shards of the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * CPU_SHARDS


def build_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over 2^d shards (state sharding needs a power of two), as the
    JAX package's build_mesh: an explicitly requested count that is not a
    power of two is an error, a count above what is available is an error,
    and with no request the largest power of two that fits the available
    devices is used.  `devices` names the shards' devices (repeats allowed:
    several shards on one card)."""
    explicit = num_devices is not None or devices is not None
    if devices is not None and num_devices is not None and len(devices) != num_devices:
        raise ValueError(
            f"num_devices={num_devices} conflicts with len(devices)={len(devices)}; "
            "pass one or make them agree"
        )
    target = num_devices
    if devices is None:
        devices = available_devices()
        if target is not None and target > len(devices):
            raise ValueError(f"requested {target} devices, only {len(devices)} available")
    devices = list(devices)
    if target is None:
        target = len(devices)
    d = target.bit_length() - 1
    if target < 1 or target != 1 << d:
        if explicit:
            raise ValueError(f"state sharding needs a power-of-two device count, got {target}")
        target = 1 << d
    return Mesh(devices[:target])


def mesh_degree(mesh: Mesh) -> int:
    """log2(number of shards) = number of global qubits."""
    D = mesh.size
    d = D.bit_length() - 1
    if D != 1 << d:
        raise ValueError(f"mesh size {D} must be a power of two")
    return d


def shard_range(mesh: Mesh, n: int, k: int) -> Tuple[int, int]:
    """The global index range [lo, hi) shard k holds of a 2^n state (the
    JAX package's state_sharding)."""
    ls = (1 << n) >> mesh_degree(mesh)
    return k * ls, (k + 1) * ls
