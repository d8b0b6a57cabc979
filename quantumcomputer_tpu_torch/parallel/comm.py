"""The transports: every exchange between the shards of a mesh.

The JAX package's sharded engines call ``lax`` collectives inside
``shard_map`` (``ppermute``, ``all_to_all``, ``all_gather``, ``psum``) and
leave them to XLA.  Here each collective is a method that takes the list of
all D shards' operands (entry k is shard k's, None where another process
holds shard k) and returns the list of what each shard receives (None for
the shards of other processes).  The engine's bodies are written per shard,
with the shard index ``me`` where the JAX body reads ``lax.axis_index``,
and loop over ``comm.local``, the shards this process holds.

``LocalTransport``: one process holds every shard.  What a shard receives
from a shard on the same device is the sender's tensor itself (no bytes
need to move on one device); from another device it is a copy on the
receiver's device.  ``Tensor.to`` orders that copy after the work already
queued on both devices' current streams.

``ProcessTransport``: the mesh spans the processes of a ``torch.distributed``
group (``parallel/mesh.build_mesh``).  A pair of shards in this process is
served as above; a pair across processes is one ``batch_isend_irecv``
message of the operand's tensors.  The receiver allocates its buffers from
its own operand (every call site's operands have one shape across the
shards); first the two ends swap headers naming their operands' dtypes and
shapes, and both raise when they differ, before any data moves.
``all_gather`` and ``psum`` gather every shard's value exactly and, for
psum, add them in shard order on every process, as LocalTransport does, so
every process reads the same bits (a backend's all_reduce would choose its
own order).  The backend is the process
group's: with gloo, CUDA operands are staged through pinned host buffers
(the device-to-host copies complete before a send is posted; the
host-to-device copies are queued on the current stream); with nccl, CUDA
tensors go as they are, one rank a card.  A failed collective raises.

Either way a received tensor is read-only, and a body reads everything it
receives before any shard's operand is overwritten: the value semantics of
``lax.ppermute``.

Each transport counts, per kind of collective, its calls and the bytes that
cross between shards: what each of this process's shards sends to another
shard, summed over them (a shard's blocks to itself are not counted).  On
one process that is the volume the links would carry with one shard a
card; over several processes each counts its own shards' sends, every
process makes every call, and ``world_stats`` sums the bytes over the
processes.  ProcessTransport also counts the bytes that leave this process
(``crossing``).  ``utils/profiling.mesh_collective_report`` reads them.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from quantumcomputer_tpu_torch.parallel.mesh import Mesh

KINDS = ("ppermute", "all_to_all", "all_gather", "psum")

# The dtypes a message header can name, and its length in int64 slots (a
# count of tensors, then per tensor its dtype, rank and shape).
_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16, torch.int64, torch.int32, torch.bool)
_HEADER = 16


def _nbytes(x) -> int:
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(t) for t in x)
    return x.numel() * x.element_size()


def _to(x, device: torch.device):
    if isinstance(x, (tuple, list)):
        return type(x)(_to(t, device) for t in x)
    return x if x.device == device else x.to(device)


def _tensors(x) -> list:
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _header(x, device) -> torch.Tensor:
    """An operand's dtypes and shapes as a fixed-length int64 tensor."""
    vals = [len(_tensors(x))]
    for t in _tensors(x):
        vals += [_DTYPES.index(t.dtype), t.dim(), *t.shape]
    if len(vals) > _HEADER:
        raise ValueError(f"an operand of {len(_tensors(x))} tensors of rank {[t.dim() for t in _tensors(x)]} "
                         f"does not fit a {_HEADER}-slot message header")
    return torch.tensor(vals + [-1] * (_HEADER - len(vals)), dtype=torch.int64, device=device)


class Transport:
    """What every transport shares: its mesh and its counters (per kind of
    collective, the fields of COUNTERS)."""

    COUNTERS = ("count", "bytes")

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.size = mesh.size
        self.local = mesh.local
        self.reset()

    def reset(self) -> None:
        """Zero the counters."""
        self.stats = {kind: dict.fromkeys(self.COUNTERS, 0) for kind in KINDS}

    def _count(self, kind: str, nbytes: int, crossing: int = 0) -> None:
        self.stats[kind]["count"] += 1
        self.stats[kind]["bytes"] += nbytes
        if crossing:
            self.stats[kind]["crossing"] += crossing

    def total_bytes(self) -> int:
        return sum(v["bytes"] for v in self.stats.values())


class LocalTransport(Transport):
    """Collectives between the shards of `mesh`, all held by this process."""

    def __init__(self, mesh: Mesh):
        if mesh.spans_processes:
            raise ValueError("LocalTransport needs every shard in this process; the mesh spans processes")
        super().__init__(mesh)

    def world_stats(self) -> dict:
        """The counters of every process, bytes summed: here, this one's."""
        return {kind: {"count": v["count"], "bytes": v["bytes"]} for kind, v in self.stats.items()}

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


def check_nccl_cards(mesh: Mesh) -> None:
    """Raise when two ranks hold shards on one card: NCCL refuses a second
    rank on a device."""
    holders: dict = {}
    for s in mesh.slots:
        holders.setdefault(s.card, set()).add(s.process_index)
    for card, ranks in holders.items():
        if len(ranks) > 1:
            raise ValueError(
                f"ranks {sorted(ranks)} of an NCCL group hold shards on one card ({card}): NCCL takes one "
                "rank a card; give each rank its own card, or run the processes over gloo"
            )


class ProcessTransport(Transport):
    """Collectives between the shards of a mesh over the processes of the
    default torch.distributed group (module docstring), with
    LocalTransport's methods, value semantics and counters, and the bytes
    that leave this process (`crossing`)."""

    COUNTERS = ("count", "bytes", "crossing")

    def __init__(self, mesh: Mesh):
        super().__init__(mesh)
        self.backend = dist.get_backend()
        if self.backend not in ("gloo", "nccl"):
            raise ValueError(f"ProcessTransport runs over gloo or nccl, not {self.backend!r}")
        self.owner = tuple(s.process_index for s in mesh.slots)
        self.me = mesh.rank
        self.world = dist.get_world_size()
        if self.backend == "nccl":
            check_nccl_cards(mesh)
        # Where the bytes of a message live: host memory for gloo, the card for nccl.
        self.wire = torch.device("cpu") if self.backend == "gloo" else mesh.first_device

    def world_stats(self) -> dict:
        """The counters summed over the processes (a collective: every
        process calls it): `count` is every process's (each makes every
        call), `bytes` the sum of what the processes' shards sent."""
        mine = torch.tensor([self.stats[k]["bytes"] for k in KINDS], dtype=torch.int64, device=self.wire)
        parts = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(parts, mine)
        total = torch.stack(parts).sum(0).tolist()
        return {kind: {"count": self.stats[kind]["count"], "bytes": total[i]} for i, kind in enumerate(KINDS)}

    # -- messages -------------------------------------------------------------

    def _on_wire(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a send hands the backend: a pinned host copy of a CUDA
        tensor over gloo (queued here, completed before the send)."""
        if t.device.type == "cuda" and self.wire.type == "cpu":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t, non_blocking=True)
        return t.contiguous()

    def _buffer(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        """A receive buffer shaped like `t` for a shard on `device`."""
        if device.type == "cuda" and self.wire.type == "cpu":
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return torch.empty(t.shape, dtype=t.dtype, device=device)

    def _post(self, ops: list) -> None:
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()

    def _exchange(self, sends: list, recvs: list) -> list:
        """Post every message of one collective together and wait for them.
        sends: (tag, operand, peer rank); recvs: (tag, template operand, peer
        rank, device).  First the two ends of each message swap headers (the
        sender's operand, the receiver's own) and both raise when they
        differ, before a byte of data moves; then the data.  Returns the
        received operands, on their devices, in the order of `recvs`."""
        ops, heads = [], []
        for tag, x, peer in sends:
            mine, theirs = _header(x, self.wire), torch.empty(_HEADER, dtype=torch.int64, device=self.wire)
            ops += [dist.P2POp(dist.isend, mine, peer, tag=_HEADER * tag),
                    dist.P2POp(dist.irecv, theirs, peer, tag=_HEADER * tag + 1)]
            heads.append((mine, theirs, peer))
        for tag, tmpl, peer, _ in recvs:
            mine, theirs = _header(tmpl, self.wire), torch.empty(_HEADER, dtype=torch.int64, device=self.wire)
            ops += [dist.P2POp(dist.irecv, theirs, peer, tag=_HEADER * tag),
                    dist.P2POp(dist.isend, mine, peer, tag=_HEADER * tag + 1)]
            heads.append((mine, theirs, peer))
        self._post(ops)
        for mine, theirs, peer in heads:
            if not torch.equal(mine, theirs):
                raise ValueError(
                    f"an operand {mine.tolist()} here meets {theirs.tolist()} on rank {peer} (count, then dtype, rank "
                    "and shape a tensor): the shards' operands of one collective must share their shapes and dtypes"
                )
        staged = [[self._on_wire(t) for t in _tensors(x)] for _, x, _ in sends]
        if self.wire.type == "cpu":
            for dev in {t.device for _, x, _ in sends for t in _tensors(x) if t.device.type == "cuda"}:
                torch.cuda.current_stream(dev).synchronize()  # the host copies are complete
        ops, posted = [], []
        for (tag, _, peer), ts in zip(sends, staged):
            ops += [dist.P2POp(dist.isend, t, peer, tag=_HEADER * tag + 2 + j) for j, t in enumerate(ts)]
        for tag, tmpl, peer, device in recvs:
            bufs = [self._buffer(t, device) for t in _tensors(tmpl)]
            ops += [dist.P2POp(dist.irecv, b, peer, tag=_HEADER * tag + 2 + j) for j, b in enumerate(bufs)]
            posted.append(bufs)
        self._post(ops)
        out = []
        for bufs, (_, tmpl, _, device) in zip(posted, recvs):
            got = [b.to(device, non_blocking=True) if b.device != device else b for b in bufs]
            out.append(type(tmpl)(got) if isinstance(tmpl, (tuple, list)) else got[0])
        return out

    def _gather(self, xs: Sequence[torch.Tensor]) -> list:
        """Every shard's value, exactly, in shard order, on this process's
        first device: one all_gather of a (D, ...) tensor a process, each
        holding its own shards' values."""
        first = self.mesh.first_device
        tmpl = xs[self.local[0]]
        packed = torch.zeros((self.size, *tmpl.shape), dtype=tmpl.dtype, device=self.wire)
        for k in self.local:
            packed[k] = xs[k]
        parts = [torch.empty_like(packed) for _ in range(self.world)]
        dist.all_gather(parts, packed)
        return [parts[self.owner[k]][k].to(first) for k in range(self.size)]

    # -- the collectives --------------------------------------------------------

    def ppermute(self, xs: Sequence, perm) -> list:
        out: List = [None] * self.size
        sent = crossing = 0
        sends, recvs, places = [], [], []
        for i, (src, dst) in enumerate(perm):
            mine_src, mine_dst = self.owner[src] == self.me, self.owner[dst] == self.me
            if mine_src and src != dst:
                sent += _nbytes(xs[src])
            if mine_src and mine_dst:
                out[dst] = _to(xs[src], self.mesh.devices[dst])
            elif mine_src:
                sends.append((i, xs[src], self.owner[dst]))
                crossing += _nbytes(xs[src])
            elif mine_dst:
                if xs[dst] is None:
                    raise ValueError(f"shard {dst} receives in a ppermute but has no operand to shape its buffer")
                recvs.append((i, xs[dst], self.owner[src], self.mesh.devices[dst]))
                places.append(dst)
        for dst, got in zip(places, self._exchange(sends, recvs)):
            out[dst] = got
        self._count("ppermute", sent, crossing)
        return out

    def all_to_all(self, blocks: Sequence[Sequence]) -> list:
        D = self.size
        out: List = [[None] * D if k in self.local else None for k in range(D)]
        sent = crossing = 0
        sends, recvs, places = [], [], []
        for e in range(D):
            for k in range(D):
                mine_e, mine_k = self.owner[e] == self.me, self.owner[k] == self.me
                if mine_e and e != k:
                    sent += _nbytes(blocks[e][k])
                if mine_e and mine_k:
                    out[k][e] = _to(blocks[e][k], self.mesh.devices[k])
                elif mine_e:
                    sends.append((e * D + k, blocks[e][k], self.owner[k]))
                    crossing += _nbytes(blocks[e][k])
                elif mine_k:
                    recvs.append((e * D + k, blocks[k][e], self.owner[e], self.mesh.devices[k]))
                    places.append((k, e))
        for (k, e), got in zip(places, self._exchange(sends, recvs)):
            out[k][e] = got
        self._count("all_to_all", sent, crossing)
        return out

    def all_gather(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        mine = sum(_nbytes(xs[k]) for k in self.local)
        self._count("all_gather", (self.size - 1) * mine, (self.world - 1) * mine)
        return torch.stack(self._gather(xs))

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        mine = sum(_nbytes(xs[k]) for k in self.local)
        self._count("psum", (self.size - 1) * mine, (self.world - 1) * mine)
        values = self._gather(xs)
        total = values[0]
        for x in values[1:]:
            total = total + x
        return total


def transport_for(mesh: Mesh) -> Transport:
    """The mesh's transport: ProcessTransport when its shards span
    processes, else LocalTransport."""
    return ProcessTransport(mesh) if mesh.spans_processes else LocalTransport(mesh)
