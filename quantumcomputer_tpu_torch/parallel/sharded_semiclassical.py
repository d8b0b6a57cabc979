"""Sharded semiclassical period finding: the one-control engine over a mesh.

The counterpart of the JAX package's ``parallel/sharded_semiclassical.py``,
which holds the design.  The work register (2^M amplitudes, planar) is
sharded over its leading bits: shard e owns the work indices
[e * ls, (e+1) * ls), ls = 2^(M-d).  The control qubit is implicit, as on
one device (``algorithms/semiclassical.py``), so one step is the closed form
w' = (w + (-1)^m e^{i theta} U w) / (2 sqrt(p_m)), and every part of it is
shard-local except the oracle U, the modular multiply y[w] = x[(b_inv w)
mod C], which scatters across every shard.  It runs as ONE all_to_all of
amplitudes only:

  * the sender bins its rows by destination shard (w = (b * s) mod C made
    on the device) in source order and packs each bin into a slot of a
    (2, D, cap) buffer;
  * the receiver rebuilds the order in which each sender packed its rows by
    sorting its own rows by their source index (the shard of a source is a
    monotone function of it), so both sides derive the same matching and
    no index crosses.

Rows outside the permutation's support (index >= C) stay where they are.
The bin capacity is exact and static: the bin loads of s -> (b s) mod C
over each source block are counted on the host by Euclidean lattice
counting (``_floor_sum``, copied from the JAX package), the maximum over
the attempt's multipliers rounded up to a power of two.  Smooth multipliers
(b = 2, 4, 16, ...) load a bin with up to ls / 2 rows, so a uniform
estimate would truncate them; an overflow count checked on the host guards
the count itself.  A step whose multiplier is 1 skips the exchange.

The branch sums are per-shard sums added across the mesh (psum); the bit,
the collapse and the deferred phase are the single-device engine's, so the
same draws give the same bits as ``run_semiclassical`` away from knife
edges.  Draws are an argument (``rs``, L uniforms in the compute dtype).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from quantumcomputer_tpu_torch.algorithms import semiclassical as sc
from quantumcomputer_tpu_torch.ops import gates as tops
from quantumcomputer_tpu_torch.parallel.comm import Transport, transport_for
from quantumcomputer_tpu_torch.parallel.mesh import Mesh, mesh_degree
from quantumcomputer_tpu_torch.sim import statevec as sv
from quantumcomputer_tpu_torch.utils.memory import device_memory_budget, mesh_fits

# The JAX package's int32 shift-add modular arithmetic keeps intermediates
# below 2C, so C < 2^30; the port's int64 arithmetic keeps its bound.
MAX_MODULUS_BITS = 30

# Elements per block of the elementwise passes over a shard.
_BLOCK = 1 << 22


# -- exact bin-load counting (host, arbitrary-precision ints) ---------------


def _floor_sum(n: int, m: int, a: int, b: int) -> int:
    """sum_{i=0}^{n-1} floor((a*i + b) / m) by Euclidean descent, O(log):
    the lattice points under a line."""
    ans = 0
    if a < 0:
        a2 = a % m
        ans -= n * (n - 1) // 2 * ((a2 - a) // m)
        a = a2
    if b < 0:
        b2 = b % m
        ans -= n * ((b2 - b) // m)
        b = b2
    while True:
        if a >= m:
            ans += n * (n - 1) // 2 * (a // m)
            a %= m
        if b >= m:
            ans += n * (b // m)
            b %= m
        y_max = a * n + b
        if y_max < m:
            return ans
        n = y_max // m
        b = y_max % m
        m, a = a, m


def _count_mod_lt(S0: int, N: int, b: int, C: int, T: int) -> int:
    """|{s in [S0, S0+N): (b*s) mod C < T}| for 0 <= T <= C, exactly:
    [y mod C < T] == floor(y/C) - floor((y-T)/C)."""
    if N <= 0 or T <= 0:
        return 0
    return _floor_sum(N, C, b, b * S0) - _floor_sum(N, C, b, b * S0 - T)


def max_bin_load(b: int, C: int, M: int, d: int) -> int:
    """The largest number of source rows one (sender, destination) pair
    carries under s -> (b*s) mod C, sources and destinations blocked into
    2^d ranges of ls = 2^(M-d) rows, the identity region s >= C left out."""
    D, ls = 1 << d, 1 << (M - d)
    best = 0
    for e in range(D):
        S0 = e * ls
        N = min(S0 + ls, C) - S0
        if N <= 0:
            break
        cuts = [_count_mod_lt(S0, N, b, C, min(m * ls, C)) for m in range(D + 1)]
        best = max(best, max(cuts[m + 1] - cuts[m] for m in range(D)))
    return best


def exchange_capacity(multipliers, C: int, M: int, d: int) -> int:
    """The static slots a bin holds, covering every step's multiplier: the
    exact largest bin load, rounded up to a power of two.  Multiplier-1
    steps skip the exchange and are left out."""
    ls = 1 << (M - d)
    worst = max((max_bin_load(int(b), C, M, d) for b in multipliers if int(b) != 1), default=1)
    return min(ls, 1 << max(0, (max(worst, 1) - 1).bit_length())) or 1


# -- the exchange -------------------------------------------------------------


def _blocks(m: int):
    return ((lo, min(m, lo + _BLOCK)) for lo in range(0, m, _BLOCK))


def _oracle_exchange(xs: list, b: int, b_inv: int, C: int, s2s: dict, *, M: int, d: int, cap: int, comm: Transport):
    """g = U (x * s2) on every shard of this process: the controlled modular
    multiply's permutation of the c = 1 branch, as one all_to_all (module
    docstring); s2s holds 1/sqrt(2) in the plane dtype on each device.
    Returns (new shards, the number of bins that exceeded cap, a shard)."""
    D = 1 << d
    n_l = M - d
    ls = 1 << n_l
    # Senders: bin the local rows by destination shard, in source order.
    blocks, overflow = [None] * D, [0] * D
    for me in comm.local:
        x = xs[me]
        s_glob = me * ls + torch.arange(ls, device=x.device, dtype=torch.int64)
        w = tops.modmul_permute_onchip(b, s_glob, C)
        dest = torch.where(s_glob < C, w >> n_l, D).to(torch.int32)
        del s_glob, w
        order = torch.argsort(dest, stable=True)
        s2 = s2s[x.device]
        starts = torch.searchsorted(dest[order], torch.arange(D + 1, device=x.device, dtype=torch.int32)).tolist()
        del dest
        buf = torch.empty((2, D, cap), dtype=x.dtype, device=x.device)
        for e in range(D):
            cnt = starts[e + 1] - starts[e]
            overflow[me] += cnt > cap
            cnt = min(cnt, cap)
            if cnt:
                buf[:, e, :cnt] = x[:, order[starts[e] : starts[e] + cnt]] * s2
        del order
        blocks[me] = [buf[:, e] for e in range(D)]
    received = comm.all_to_all(blocks)
    del blocks
    # Receivers: sort the local rows by source index; the rows of one
    # source shard then stand in that sender's packing order.
    out = [None] * D
    for me in comm.local:
        x = xs[me]
        w_glob = me * ls + torch.arange(ls, device=x.device, dtype=torch.int64)
        src = tops.modmul_permute_onchip(b_inv, w_glob, C)
        del w_glob
        src_sorted, rows = torch.sort(src.to(torch.int32))
        del src
        cuts = torch.searchsorted(src_sorted, torch.arange(D, device=x.device, dtype=torch.int32) * ls)
        starts = torch.cat([cuts, torch.searchsorted(src_sorted, C).reshape(1)]).tolist()
        del src_sorted
        g = torch.empty_like(x)
        s2 = s2s[x.device]
        n_exch = starts[D]  # rows with a source below C (identity rows sort last)
        for e in range(D):
            lo, hi = starts[e], min(starts[e + 1], n_exch)
            if hi > lo:
                g.index_copy_(1, rows[lo:hi], received[me][e][:, : hi - lo])
        t0 = min(max(C - me * ls, 0), ls)  # identity rows: w >= C, a tail of the shard
        if t0 < ls:
            g[:, t0:] = x[:, t0:] * s2
        del rows
        out[me] = g
    return out, overflow


# -- the attempt --------------------------------------------------------------

# Shard-sized buffers one attempt holds at its peak, a shard: the shard, the
# rotated branch, the send buffers (up to D * cap slots, about two shards at
# the capacity smooth multipliers need) and the sort's index temporaries
# (the JAX package's figure for its fused program).
_SHARD_STATES_HEADROOM = 6


def sharded_attempt_fits(M: int, rdtype: torch.dtype, mesh: Mesh) -> bool:
    """Does one sharded attempt at M work qubits fit the mesh's devices,
    every shard on a device counted against that device's budget
    (utils/memory.mesh_fits)?  Checked before any step runs."""
    return mesh_fits(_SHARD_STATES_HEADROOM, M - mesh_degree(mesh), rdtype, mesh)


def run_semiclassical_sharded(
    C: int,
    a: int,
    L: int,
    M: int,
    rs,
    mesh: Mesh,
    dtype=torch.complex64,
    forced_bits: Optional[List[int]] = None,
) -> sc.SemiclassicalRecord:
    """One semiclassical attempt with the work register sharded over `mesh`
    (the JAX package's run_semiclassical_sharded): the record of
    run_semiclassical, the same bits for the same draws `rs` (L uniforms,
    taken in the compute dtype).  The record also holds the exchange's
    slots a bin (`capacity`), the bytes each step's exchange moved between
    shards (`exchange_bytes`; on a mesh over several processes, what this
    process's shards sent) and the bins that overflowed (`overflow`, 0, or
    the call raises).  On such a mesh every process runs the attempt and
    gets the same bits and probabilities: the branch sums are gathered and
    added in shard order on each."""
    if (1 << M) < C:
        raise ValueError(f"2^M={1 << M} < C={C}: the modular-multiply gate is not unitary")
    if C >= (1 << MAX_MODULUS_BITS):
        raise ValueError(
            f"C={C} >= 2^{MAX_MODULUS_BITS} exceeds the int32 shift-add "
            "modular-arithmetic bound (ops/gates.modmul_onchip)"
        )
    if M > MAX_MODULUS_BITS:
        raise ValueError(f"M={M} > {MAX_MODULUS_BITS} exceeds the int32 index budget")
    if L > 52:
        raise ValueError(f"L={L} > 52 exceeds the float64 omega mantissa (x_tilde / 2^L)")
    if math.gcd(a, C) != 1:
        raise ValueError(f"a={a} not coprime to C={C}: gate is not a permutation")
    d = mesh_degree(mesh)
    if M - d < 1:
        raise ValueError(f"M={M} too small for 2^{d} devices (no local work rows)")
    rdtype = sv.real_dtype_of(dtype)
    if not sharded_attempt_fits(M, rdtype, mesh):
        itemsize = torch.empty((), dtype=rdtype).element_size()
        device = mesh.first_device
        per_shard = _SHARD_STATES_HEADROOM * 2 * (1 << (M - d)) * itemsize
        raise ValueError(
            f"M={M} at {str(rdtype).removeprefix('torch.')} needs ~"
            f"{mesh.shards_on(device) * per_shard / 2**30:.1f} GiB "
            f"on {device} ({mesh.shards_on(device)} shards: shard + exchange buffers) — "
            f"exceeds the {device_memory_budget(device) / 2**30:.1f} GiB device budget. "
            f"Use more devices, complex32, or a smaller M."
        )
    cdt = sc._compute_dtype(rdtype)
    rs = (rs if isinstance(rs, torch.Tensor) else torch.tensor(np.asarray(rs))).to(dtype=cdt).reshape(-1)
    if rs.shape != (L,):
        raise ValueError(f"rs must hold L={L} draws, got shape {tuple(rs.shape)}")
    forced_bits = sc.validate_forced_bits(forced_bits, L, "L")
    forces = forced_bits if forced_bits is not None else [-1] * L

    # Step s applies the controlled a^(2^(L-1-s)) mod C multiply.
    a_pows = [pow(a, 1 << (L - 1 - s), C) for s in range(L)]
    a_invs = [pow(p, -1, C) for p in a_pows]
    cap = exchange_capacity(a_pows, C, M, d)
    comm = transport_for(mesh)
    ls = 1 << (M - d)
    first = mesh.first_device
    rs = rs.to(first)
    xs = [None] * mesh.size
    for k in mesh.local:
        xs[k] = torch.zeros((2, ls), dtype=rdtype, device=mesh.devices[k])
    if xs[0] is not None:
        xs[0][0, 1] = 1.0  # |1>: work register = 1 (shard 0, local row 1)
    phi = torch.zeros((), dtype=cdt, device=first)
    s2s = {xs[k].device: sc._s2(rdtype, xs[k].device) for k in mesh.local}
    pi = torch.tensor(math.pi, dtype=cdt, device=first)
    bits_d, probs_d, sent, overflow = [], [], [], [0] * mesh.size
    for s in range(L):
        before = comm.total_bytes()
        theta = phi * pi
        ct, st = torch.cos(theta), torch.sin(theta)
        if a_pows[s] == 1:
            gs = [None if x is None else x * s2s[x.device] for x in xs]
        else:
            gs, of = _oracle_exchange(xs, a_pows[s], a_invs[s], C, s2s, M=M, d=d, cap=cap, comm=comm)
            overflow = [o + f for o, f in zip(overflow, of)]
        # The deferred phase on the c = 1 branch, in place a block at a time,
        # computed in the compute dtype and rounded once.
        parts = [None] * mesh.size
        for me in comm.local:
            x, g = xs[me], gs[me]
            s2 = s2s[x.device]
            ctd, std = ct.to(x.device), st.to(x.device)
            for lo, hi in _blocks(ls):
                gr = g[0, lo:hi].to(cdt, copy=True)
                gi = g[1, lo:hi].to(cdt, copy=True)
                sc._rotate(g[:, lo:hi], gr, gi, ctd, std, cdt)
            p0 = torch.zeros((), dtype=cdt, device=x.device)
            p1 = torch.zeros((), dtype=cdt, device=x.device)
            for lo, hi in _blocks(ls):
                q0, q1 = sc._branch_sums(x[:, lo:hi], g[:, lo:hi], s2, cdt)
                p0 += q0
                p1 += q1
            parts[me] = (p0, p1)
        p0 = comm.psum([None if p is None else p[0] for p in parts])
        p1 = comm.psum([None if p is None else p[1] for p in parts])
        new = [None] * mesh.size
        for me in comm.local:
            x, g = xs[me], gs[me]
            bit, p_cond, new[me] = sc.collapse_from_a1(
                x, g, p0.to(x.device), p1.to(x.device), rs[s].to(x.device), forces[s], rdtype, cdt
            )
        xs = new
        del gs, new
        bit = bit.to(first)
        bits_d.append(bit)
        probs_d.append(p_cond.to(first))
        phi = (phi + bit.to(cdt)) / 2
        sent.append(comm.total_bytes() - before)
    # Every process raises alike: the bins' overflow counts, summed over the shards.
    overflow = int(comm.psum([None if xs[k] is None else torch.tensor(overflow[k]) for k in range(mesh.size)]))
    if overflow:
        raise RuntimeError(
            "oracle exchange bin overflow: a destination bin exceeded the "
            f"computed capacity {cap} — the host lattice count and the "
            "device permutation disagree (bug); amplitudes were NOT "
            "silently dropped, this run is void"
        )
    rec = sc.SemiclassicalRecord.from_bits(
        [int(b) for b in torch.stack(bits_d).cpu()], [float(p) for p in torch.stack(probs_d).cpu()]
    )
    rec.oracles = ["exchange" if p != 1 else "identity" for p in a_pows]
    rec.capacity, rec.exchange_bytes, rec.overflow = cap, sent, overflow
    return rec
