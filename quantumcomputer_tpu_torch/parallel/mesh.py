"""The mesh of shards a distributed state vector lives on.

The counterpart of the JAX package's ``parallel/mesh.py``.  The 2^n
amplitude vector is sharded over its leading global index bits: with
D = 2^d shards, shard k holds the contiguous index range
[k * 2^(n-d), (k+1) * 2^(n-d)), so the top d qubits [n-d, n) are global
(their bit values select the shard) and the rest are shard-local.  A state
is a list of D planar (2, 2^(n-d)) tensors, shard k on the mesh's device k;
an entry is None where another process holds the shard.

Each mesh slot (``MeshDevice``) names the device its shard lives on, the
process that holds it (its communication domain, as the JAX package groups
non-TPU devices by ``process_index``) and the physical card behind the
device.  With no process group, one process holds every slot and the
exchanges between them are copies (``parallel/comm.LocalTransport``).  A
device may hold several shards: an explicit ``devices=`` list may repeat a
device, as XLA's forced host device count makes virtual devices of one CPU.
With no list, ``build_mesh`` takes distinct devices: the visible CUDA cards,
or, on a host with no card, ``CPU_SHARDS`` virtual shards of the CPU (the
device count the JAX package's CPU tests force).

When a ``torch.distributed`` process group is initialised, ``build_mesh``
builds the world mesh: every rank's devices, gathered, ordered
domain-major (``order_devices_for_ici``: the low mesh bits stay inside a
process, only the top bits cross processes) and cut to a power of two by
``_pick_subset``, as the JAX ``build_mesh`` does over ``jax.devices()``
after ``jax.distributed.initialize``; the exchanges then go through
``parallel/comm.ProcessTransport``.
"""

from __future__ import annotations

import socket
from collections import Counter
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from quantumcomputer_tpu_torch.utils.memory import device_memory_budget

#: The mesh axis name, as in the JAX package.
AXIS = "q"

#: Virtual shards a host with no CUDA card offers: the JAX package's tests
#: force 8 CPU devices (tests/conftest.py).
CPU_SHARDS = 8


@dataclass(frozen=True)
class MeshDevice:
    """One slot of a mesh: the device its shard lives on (as the process
    that holds it names it), that process's rank, the slot's id in the
    world's arrival order and the physical card behind the device (host and
    card; the shards on one card share its memory).  ``platform``,
    ``process_index`` and ``id`` are what the JAX ordering reads of a jax
    device."""

    device: torch.device
    process_index: int = 0
    id: int = 0
    card: str = ""

    @property
    def platform(self) -> str:
        return self.device.type


class Mesh:
    """A 1-D mesh of 2^d shard slots, each naming the device its shard
    lives on (a device may repeat) and the process that holds it.  `rank`
    is this process's.  `budgets` is the memory budget of each card
    (``utils/memory.mesh_fits``), recorded once, when the mesh is built:
    ``build_mesh`` passes what it gathered from every process, so that
    every process decides from the same numbers; with none given, the
    mesh asks each card's device now."""

    def __init__(self, devices: Sequence, rank: int = 0, budgets: Optional[dict] = None):
        self.slots: Tuple[MeshDevice, ...] = tuple(
            dv if isinstance(dv, MeshDevice) else MeshDevice(torch.device(dv), id=k, card=str(torch.device(dv)))
            for k, dv in enumerate(devices)
        )
        if not self.slots:
            raise ValueError("a mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = tuple(s.device for s in self.slots)
        self.rank = rank
        if budgets is None:
            budgets = {s.card: device_memory_budget(s.device) for s in self.slots}
        self.budgets = budgets
        #: The slots this process holds, in mesh order.
        self.local: Tuple[int, ...] = tuple(k for k, s in enumerate(self.slots) if s.process_index == rank)
        if not self.local:
            raise ValueError(
                f"the mesh leaves rank {rank} without a shard; every process of the group must hold one "
                "(offer fewer devices a process, or request more shards)"
            )

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def shape(self) -> dict:
        return {AXIS: self.size}

    @property
    def spans_processes(self) -> bool:
        return len({s.process_index for s in self.slots}) > 1

    @property
    def first_device(self) -> torch.device:
        """The device of this process's first shard."""
        return self.devices[self.local[0]]

    def cards(self) -> Counter:
        """Shards a physical card, over the whole mesh."""
        return Counter(s.card for s in self.slots)

    def shards_on(self, device) -> int:
        """How many of the mesh's shards live on the physical card behind
        this process's `device`, whichever process holds them."""
        device = torch.device(device)
        mine = {s.card for s in self.slots if s.device == device and s.process_index == self.rank}
        return sum(s.card in mine for s in self.slots)

    def __repr__(self) -> str:
        if not self.spans_processes:
            return f"Mesh({[str(dv) for dv in self.devices]})"
        return f"Mesh({[f'{s.process_index}:{s.device}' for s in self.slots]}, rank={self.rank})"


def comm_domain(dev) -> int:
    """Communication domain of a device (the JAX package's comm_domain):
    devices in one domain exchange over fast links; crossing domains rides
    the slower network.

    TPU devices group by slice_index; other devices (the port's mesh slots
    among them) group by process_index: distributed CPU devices expose a
    uniform slice_index, which would collapse every process into one
    domain.  Devices with no platform attribute (synthetic test doubles)
    keep slice_index semantics."""
    plat = getattr(dev, "platform", None)
    if plat in (None, "tpu"):
        v = getattr(dev, "slice_index", None)
        if v is not None:
            return int(v)
    v = getattr(dev, "process_index", None)
    return int(v) if v is not None else 0


def order_devices_for_ici(devices: Sequence) -> list:
    """Order devices so the devices of one domain occupy the LOW mesh-index
    bits (the JAX package's order_devices_for_ici): the engine's exchanges
    at offset 2^p for global-qubit bit p then stay inside a domain for the
    bits below log2(devices per domain), and only the top mesh bits cross
    domains."""
    return sorted(devices, key=lambda dv: (comm_domain(dv), getattr(dv, "id", 0)))


def _pick_subset(devices: list, target: int) -> list:
    """Choose `target` (a power of two) devices from the domain-ordered
    list maximizing block purity (the JAX package's _pick_subset): take
    2^b devices from each of target/2^b domains with the LARGEST b that
    covers the target, so 2^b-aligned blocks stay domain-pure
    (ici_degree >= b).  8 of 12 devices in 6+6 domains: 4+4, not the 6+2
    prefix."""
    by_dom: dict = {}
    for dv in devices:  # already domain-ordered
        by_dom.setdefault(comm_domain(dv), []).append(dv)
    sizes = sorted((len(v) for v in by_dom.values()), reverse=True)
    b = target.bit_length() - 1
    while b >= 0:
        blk = 1 << b
        n_blocks = target // blk
        if sum(1 for s in sizes if s >= blk) >= n_blocks:
            picked: List = []
            for dom_devs in sorted(by_dom.values(), key=len, reverse=True):
                if len(picked) >= target:
                    break
                if len(dom_devs) >= blk:
                    picked.extend(dom_devs[:blk])
            return picked[:target]
        b -= 1
    return devices[:target]  # unreachable: b=0 always covers


def ici_degree(mesh: Mesh) -> int:
    """Number of LOW global-qubit bits whose exchanges stay inside one
    domain under the mesh's order; bits >= this cross domains.  The
    largest b with every 2^b-aligned block domain-pure, correct for
    unequal domain sizes ([A,A,B,B,B,B,B,B] has degree 1)."""
    domains = [comm_domain(dv) for dv in mesh.slots]
    if len(set(domains)) <= 1:
        return mesh_degree(mesh)
    b = 0
    while (1 << (b + 1)) <= len(domains):
        size = 1 << (b + 1)
        if any(len(set(domains[s : s + size])) > 1 for s in range(0, len(domains), size)):
            break
        b += 1
    return b


def available_devices() -> list:
    """The distinct devices a mesh may take when none are named: every
    visible CUDA card, else CPU_SHARDS virtual shards of the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * CPU_SHARDS


def _card(device: torch.device) -> str:
    """The physical card behind one of this process's devices: the host and
    the card's UUID (two ranks' cuda:0 may be one card or two)."""
    name = str(device)
    if device.type == "cuda":
        uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
        name = f"cuda-{uuid}" if uuid is not None else name
    return f"{socket.gethostname()}/{name}"


def _world_slots(devices: list) -> Tuple[list, dict]:
    """Every rank's offered devices as mesh slots in rank order, and each
    card's budget: one all_gather_object over the process group."""
    mine = [(str(dv), _card(dv), device_memory_budget(dv)) for dv in devices]
    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, mine)
    slots, budgets = [], {}
    for rank, offered in enumerate(gathered):
        for name, card, budget in offered:
            slots.append(MeshDevice(torch.device(name), process_index=rank, id=len(slots), card=card))
            budgets[card] = budget
    return slots, budgets


def build_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over 2^d shards (state sharding needs a power of two), as the
    JAX package's build_mesh: an explicitly requested count that is not a
    power of two is an error, a count above what is available is an error,
    and with no request the largest power of two that fits the available
    devices is used.  `devices` names the shards' devices (repeats allowed:
    several shards on one card).

    With a torch.distributed process group initialised, `devices` (default:
    available_devices()) are the devices THIS process offers, every rank's
    offer is gathered, and `num_devices` counts the world's shards; the
    world's slots are ordered domain-major and a subset is picked
    domain-aligned (_pick_subset).  Every rank must call it, and every rank
    must be left at least one shard."""
    explicit = num_devices is not None or devices is not None
    world = dist.is_available() and dist.is_initialized()
    if devices is not None and num_devices is not None and not world and len(devices) != num_devices:
        raise ValueError(
            f"num_devices={num_devices} conflicts with len(devices)={len(devices)}; "
            "pass one or make them agree"
        )
    target = num_devices
    offered = [torch.device(dv) for dv in devices] if devices is not None else available_devices()
    budgets = None
    if world:
        slots, budgets = _world_slots(offered)
        slots = order_devices_for_ici(slots)
    else:
        slots = list(offered)
    if target is not None and target > len(slots) and (devices is None or world):
        raise ValueError(f"requested {target} devices, only {len(slots)} available")
    if target is None:
        target = len(slots)
    d = target.bit_length() - 1
    if target < 1 or target != 1 << d:
        if explicit:
            raise ValueError(f"state sharding needs a power-of-two device count, got {target}")
        target = 1 << d
    if world:
        if target < len(slots):
            slots = order_devices_for_ici(_pick_subset(slots, target))
        return Mesh(slots, rank=dist.get_rank(), budgets=budgets)
    return Mesh(slots[:target])


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
