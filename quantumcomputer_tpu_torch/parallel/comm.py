"""The in-process transport: every exchange between the shards of a mesh.

The JAX package's sharded engines call ``lax`` collectives inside
``shard_map`` (``ppermute``, ``all_to_all``, ``all_gather``, ``psum``) and
leave them to XLA.  Here one process holds every shard, so each collective
is a method that takes the list of all D shards' operands (entry k is shard
k's) and returns the list of what each shard receives.  The engine's bodies
are written per shard, with the shard index ``me`` where the JAX body reads
``lax.axis_index``, so a transport over ``torch.distributed`` (one shard a
process) can take this one's place without a change to the engine.

What a shard receives from a shard on the same device is the sender's
tensor itself (no bytes need to move on one device); from another device
it is a copy on the receiver's device.  ``Tensor.to`` orders that copy
after the work already queued on both devices' current streams.  Either
way a received tensor is read-only, and a body reads everything it
receives before any shard's operand is overwritten: the value semantics of
``lax.ppermute``.

Each transport counts, per kind of collective, its calls and the bytes that
cross between shards: what each shard sends to another shard, summed over
the shards (a shard's blocks to itself are not counted).  That is the
volume the links would carry on a host with one shard a card;
``utils/profiling.mesh_collective_report`` reads it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from quantumcomputer_tpu_torch.parallel.mesh import Mesh

KINDS = ("ppermute", "all_to_all", "all_gather", "psum")


def _nbytes(x) -> int:
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(t) for t in x)
    return x.numel() * x.element_size()


def _to(x, device: torch.device):
    if isinstance(x, (tuple, list)):
        return type(x)(_to(t, device) for t in x)
    return x if x.device == device else x.to(device)


class LocalTransport:
    """Collectives between the shards of `mesh`, all held by this process."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.size = mesh.size
        self.reset()

    def reset(self) -> None:
        """Zero the counters."""
        self.stats = {kind: {"count": 0, "bytes": 0} for kind in KINDS}

    def _count(self, kind: str, nbytes: int) -> None:
        self.stats[kind]["count"] += 1
        self.stats[kind]["bytes"] += nbytes

    def total_bytes(self) -> int:
        return sum(v["bytes"] for v in self.stats.values())

    def ppermute(self, xs: Sequence, perm) -> list:
        """lax.ppermute: shard dst receives xs[src] for each (src, dst) of
        `perm`; a shard no pair sends to receives None (the JAX collective
        gives it zeros, which no caller here reads).  An operand may be a
        tensor or a tuple of tensors (both planes in one collective)."""
        out: List = [None] * self.size
        sent = 0
        for src, dst in perm:
            out[dst] = _to(xs[src], self.mesh.devices[dst])
            if src != dst:
                sent += _nbytes(xs[src])
        self._count("ppermute", sent)
        return out

    def all_to_all(self, blocks: Sequence[Sequence]) -> list:
        """lax.all_to_all: blocks[e][k] is what shard e sends shard k; shard
        k receives the list [blocks[0][k], ..., blocks[D-1][k]]."""
        D = self.size
        sent = sum(_nbytes(blocks[e][k]) for e in range(D) for k in range(D) if e != k)
        self._count("all_to_all", sent)
        return [[_to(blocks[e][k], self.mesh.devices[k]) for e in range(D)] for k in range(D)]

    def all_gather(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """lax.all_gather of one small tensor a shard: their stack, on the
        first shard's device (every shard reads the same values)."""
        self._count("all_gather", (self.size - 1) * sum(_nbytes(x) for x in xs))
        return torch.stack([_to(x, self.mesh.devices[0]) for x in xs])

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """lax.psum of one small tensor a shard: their sum, on the first
        shard's device."""
        self._count("psum", (self.size - 1) * sum(_nbytes(x) for x in xs))
        total = _to(xs[0], self.mesh.devices[0])
        for x in xs[1:]:
            total = total + _to(x, self.mesh.devices[0])
        return total
