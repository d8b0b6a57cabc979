"""Sharded state-vector engine: a circuit over the shards of a mesh.

The counterpart of the JAX package's ``parallel/sharded.py``.  A state on
n qubits over a mesh of D = 2^d shards is a list of D planar (2, 2^(n-d))
tensors, shard k on the mesh's device k; the top d qubits are global
(``parallel/mesh.py``).  On a mesh over several processes each process
holds its own shards, the other entries are None, and every body loops
over ``comm.local``.  Each gate runs as the JAX engine runs it inside
``shard_map``:

  * gates on shard-local qubits: the single-device ops on every shard.
    With the cuda backend, maximal runs of them go through the fused
    planner (``ops/fused.plan_circuit``) once, and every shard applies
    each segment with the fused-segment kernel (its plain version on CPU
    shards) when n - d >= FUSED_MIN_LOCAL; below that, gate by gate;
  * a dense gate on a global qubit: one exchange of whole shards with the
    partner shard (``ppermute``), then a linear combination selected by
    the shard's own bit;
  * diagonal gates on global qubits and the controlled modular multiply
    with a global control: no exchange, the shard's bits select a scalar
    or the identity;
  * the m_high layout's oracle, whose work register holds the global bits:
    a row exchange on a static packed schedule (``_apply_rows_packed_``),
    and runs of at least D oracles fused into one ladder, one rotation of
    D - 1 shard exchanges (``_fuse_mhigh_ladders``);
  * measurement: per-shard probability totals, gathered, a pick of the
    shard by a cumulative sum over D, then the single-device sampler inside
    the chosen shard, the pair (shard, local index) composed on the host
    (exact at any n).

Every plain pass over a shard computes in the compute dtype (float32 for
bf16 "complex32" planes) and rounds to the plane dtype once, as the JAX
engine's planar path does, in chunks of ``_CHUNK`` elements so its
temporaries stay small.  Exchanges go through the mesh's transport
(``parallel/comm.py``), which counts their bytes.  The m_high row exchange
ships only the columns whose control bit is 1 (the others keep their
values), half of what the JAX engine's masked exchange ships.

Not here (each listed in ROADMAP.md): the slot / template oracle forms
(``camodc_slot``, ``camodc_high_slot``, ``packed_slot_routes``,
``run_and_measure_index_with_tables``), which the single-device port has
none of either, and the double-float engine (``sharded_dd.py``): dd64 is
complex128 in this package.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

from quantumcomputer_tpu_torch.models.circuit import (
    DENSE_1Q,
    DIAGONAL_1Q,
    Circuit,
    Gate,
    H,
    dagger_circuit,
    gate_matrix_1q,
    gate_matrix_2q,
)
from quantumcomputer_tpu_torch.ops import fused, measure
from quantumcomputer_tpu_torch.ops import gates as tops
from quantumcomputer_tpu_torch.parallel.comm import Transport, transport_for
from quantumcomputer_tpu_torch.parallel.mesh import Mesh, build_mesh, mesh_degree
from quantumcomputer_tpu_torch.sim import engine as seng
from quantumcomputer_tpu_torch.sim import statevec as sv
from quantumcomputer_tpu_torch.sim.engine import Register
from quantumcomputer_tpu_torch.utils.memory import device_memory_budget, mesh_fits

#: Below this many local qubits the mesh runs gate by gate, as the JAX
#: engine does (its fused path needs n_local >= 14).
FUSED_MIN_LOCAL = 14

# Elements per chunk of a plain pass, and of the ladder's index blocks.
_CHUNK = 1 << 22
_LADDER_CHUNK = 1 << 24

def _butterfly_pairs(D: int, p: int) -> list:
    """ppermute pairing for global-qubit bit p: k <-> k XOR 2^p."""
    return [(k, k ^ (1 << p)) for k in range(D)]


def _rotation(D: int, delta: int) -> list:
    return [(p, (p + delta) % D) for p in range(D)]


def _device_bit(me: int, p: int) -> int:
    return (me >> p) & 1


def _chunks(m: int, size: int = _CHUNK):
    for lo in range(0, m, size):
        yield lo, min(m, lo + size)


def _combine_(out: torch.Tensor, terms) -> torch.Tensor:
    """out = sum_i c_i * x_i over planar (2, m) tensors and complex scalars
    c_i, computed in the compute dtype chunk by chunk and rounded to out's
    dtype once (the JAX planar blend; the real and imaginary parts of a
    coefficient that are zero are skipped).  out must not be one of the x_i."""
    cdt = sv.compute_dtype(out.dtype)
    direct = out.dtype == cdt  # accumulate in out itself
    for lo, hi in _chunks(out.shape[1]):
        acc = [out[0, lo:hi], out[1, lo:hi]] if direct else [None, None]
        first = [True, True]
        for c, x in terms:
            cr, ci = float(np.real(c)), float(np.imag(c))
            xr, xi = x[0, lo:hi].to(cdt), x[1, lo:hi].to(cdt)
            # re += cr xr - ci xi; im += cr xi + ci xr
            for p, parts in ((0, ((cr, xr), (-ci, xi))), (1, ((cr, xi), (ci, xr)))):
                for coef, src in parts:
                    if coef == 0.0:
                        continue
                    if first[p]:
                        acc[p] = torch.mul(src, coef, out=acc[p]) if direct else src * coef
                        first[p] = False
                    else:
                        acc[p] = acc[p].add_(src, alpha=coef)
        for p in range(2):
            if first[p]:
                out[p, lo:hi].zero_()
            elif not direct:
                out[p, lo:hi] = acc[p]
    return out


def _phase_pass_(x: torch.Tensor, fr, fi, block_bits: int) -> torch.Tensor:
    """x *= f in place, where f is constant over each block of 2^block_bits
    elements: fr, fi the factors' parts, float64 tensors of one value a
    block (or Python floats for one factor throughout).  Computed in the
    compute dtype as (fr re - fi im, fr im + fi re), rounded once."""
    cdt = sv.compute_dtype(x.dtype)
    block = 1 << block_bits
    nb = x.shape[1] >> block_bits
    view = x.view(2, nb, block)
    fr = torch.as_tensor(fr, dtype=torch.float64, device=x.device).to(cdt).reshape(-1, 1).expand(nb, 1)
    fi = torch.as_tensor(fi, dtype=torch.float64, device=x.device).to(cdt).reshape(-1, 1).expand(nb, 1)
    rows = max(1, _CHUNK >> block_bits)
    for b0 in range(0, nb, rows):
        b1 = min(nb, b0 + rows)
        xr, xi = view[0, b0:b1].to(cdt), view[1, b0:b1].to(cdt)
        re = fr[b0:b1] * xr - fi[b0:b1] * xi
        im = fr[b0:b1] * xi + fi[b0:b1] * xr
        view[0, b0:b1] = re
        view[1, b0:b1] = im
    return x


def _scale_(x: torch.Tensor, c) -> torch.Tensor:
    """x *= c for a complex scalar c, in place."""
    c = complex(c)
    return _phase_pass_(x, c.real, c.imag, sv.num_qubits(x))


def _bit_diag_(x: torch.Tensor, q: int, d0, d1) -> torch.Tensor:
    """The diagonal (d0, d1) on local qubit q, in place."""
    f = torch.tensor([complex(d0), complex(d1)], dtype=torch.complex128)[torch.arange(x.shape[1] >> q) & 1]
    return _phase_pass_(x, f.real, f.imag, q)


# ---------------------------------------------------------------------------
# Gates on global qubits.


def _apply_1q_global_(shards: list, u2: np.ndarray, p: int, comm: Transport) -> None:
    """Dense 1q gate on global qubit bit p: exchange shards with the
    partner, then new = U[b,b] * ours + U[b,1-b] * theirs (b = our bit)."""
    D = len(shards)
    remote = comm.ppermute(shards, _butterfly_pairs(D, p))
    out = list(shards)
    for me in comm.local:
        b = _device_bit(me, p)
        diag, off = (u2[0, 0], u2[0, 1]) if b == 0 else (u2[1, 1], u2[1, 0])
        out[me] = _combine_(torch.empty_like(shards[me]), ((diag, shards[me]), (off, remote[me])))
    shards[:] = out


def _apply_2q_one_global_(shards: list, u4: np.ndarray, p: int, q_local: int, comm: Transport) -> None:
    """Dense 2q gate with exactly one global qubit (shard bit p) and one
    local; u4 in the basis 2*bit(global) + bit(local).  One shard exchange,
    then the contraction over (global, local) pairs, in the complex
    compute dtype."""
    D = len(shards)
    remote = comm.ppermute(shards, _butterfly_pairs(D, p))
    inner = 1 << q_local
    out = list(shards)
    for me in comm.local:
        x = shards[me]
        b = _device_bit(me, p)
        cdt = sv.complex_dtype_of(x.dtype)
        w = torch.tensor(np.asarray(u4).reshape(2, 2, 2, 2)[b], dtype=cdt, device=x.device)  # (l', g, l)
        x_me = sv.to_complex(x).view(-1, 2, inner)
        x_rm = sv.to_complex(remote[me]).view(-1, 2, inner)
        xs = torch.stack([x_me, x_rm] if b == 0 else [x_rm, x_me])  # (g, outer, l, inner)
        z = torch.einsum("fgl,golx->ofx", w, xs).reshape(-1)
        out[me] = sv.from_complex(z).to(x.dtype)
    shards[:] = out


def _apply_2q_both_global_(shards: list, u4: np.ndarray, p_hi: int, p_lo: int, comm: Transport) -> None:
    """Dense 2q gate with both qubits global (shard bits p_hi, p_lo): the
    shards of the three XOR partners (three exchanges), then a 4-term
    combination selected by the shard's two bits; u4 in the basis
    2*bit(hi) + bit(lo)."""
    D = len(shards)
    r_lo = comm.ppermute(shards, _butterfly_pairs(D, p_lo))
    r_hi = comm.ppermute(shards, _butterfly_pairs(D, p_hi))
    r_both = comm.ppermute(r_lo, _butterfly_pairs(D, p_hi))
    out = list(shards)
    for me in comm.local:
        b_hi, b_lo = _device_bit(me, p_hi), _device_bit(me, p_lo)
        urow = u4[2 * b_hi + b_lo]
        terms = []
        for d_hi in (0, 1):
            for d_lo in (0, 1):
                src = (shards, r_lo, r_hi, r_both)[2 * d_hi + d_lo][me]
                terms.append((urow[2 * (b_hi ^ d_hi) + (b_lo ^ d_lo)], src))
        out[me] = _combine_(torch.empty_like(shards[me]), terms)
    shards[:] = out


def _permute_work_(x: torch.Tensor, ginv: torch.Tensor, M: int) -> None:
    """Every 2^M-element work block of a shard gathered through ginv, in
    place, a chunk of blocks at a time."""
    m_dim = 1 << M
    rows = max(1, _CHUNK >> M)
    for p in range(2):
        blocks = x[p].view(-1, m_dim)
        for r0 in range(0, blocks.shape[0], rows):
            blk = blocks[r0 : r0 + rows]
            blk.copy_(blk.index_select(1, ginv))


def _apply_iqft_global_(shards: list, l: int, M: int, n_local: int, comm: Transport) -> None:
    """One inverse-QFT stage on global qubit l: H on it (an exchange), then
    on the shards whose bit l is 1 the stage's ladder diagonal
    exp(i pi (g & mask) / 2^l), mask = 2^l - 2^M, at global indices g: the
    local bits from the shard's index, the global bits below l from the
    shard's number.  The phase is constant over each 2^M-element work
    block; angles are formed in float64."""
    _apply_1q_global_(shards, gate_matrix_1q(H(l)), l - n_local, comm)
    if l <= M:
        return
    mask = (1 << l) - (1 << M)
    for me in comm.local:
        x = shards[me]
        if _device_bit(me, l - n_local) != 1:
            continue
        high = (me & ((1 << (l - n_local)) - 1)) << n_local
        blocks = torch.arange(x.shape[1] >> M, dtype=torch.int64, device=x.device)
        theta = (((blocks << M) & mask) + high).double() * (math.pi / float(1 << l))
        _phase_pass_(x, torch.cos(theta), torch.sin(theta), M)


# ---------------------------------------------------------------------------
# The m_high oracle on the mesh: a row exchange.


def _fill_offset_routes(src, delta_of, D: int, R: int, delta: int, send_idx, recv_dst) -> None:
    """Fill one offset's packed send / recv tables in place ((D, K) views):
    send padding gathers row 0, recv padding points at row R (dropped),
    sender p = (receiver - delta) % D, rows ordered as the receiver expects
    (the JAX package's routing convention)."""
    for k in range(D):  # receiver
        g = np.nonzero(delta_of[k * R : (k + 1) * R] == delta)[0]  # local destination rows
        p = (k - delta) % D  # sender
        send_idx[p, : g.size] = (src[k * R + g] % R).astype(np.int32)
        recv_dst[k, : g.size] = g.astype(np.int32)


@lru_cache(maxsize=256)
def _packed_exchange_schedule(C: int, atox: int, m_reg: int, d: int):
    """Static routing tables of the m_high oracle's row exchange (the JAX
    package's, copied): the permutation f -> A*f mod C of global rows is
    known on the host, so each shard ships each partner only the rows it
    needs, padded per offset to the largest count over the shards.

    Returns (local_idx (D, R), schedule), schedule a tuple of (delta,
    send_idx (D, K), recv_dst (D, K)) for each used nonzero offset:
    local_idx[k][r] is the shard-local source row when it lives on shard k,
    else r (overwritten by the exchange); send_idx[p] the rows shard p
    sends to p + delta, in the receiver's order (padding sends row 0);
    recv_dst[k] where shard k puts what it receives (padding: row R,
    dropped)."""
    D = 1 << d
    R = (1 << m_reg) >> d
    src = np.asarray(tops.modmul_inverse_permutation(C, atox, m_reg), np.int64)
    rows = np.arange(D * R, dtype=np.int64)
    delta_of = (rows // R - src // R) % D
    local_idx = np.where(delta_of == 0, src % R, rows % R).reshape(D, R).astype(np.int32)
    schedule = []
    for delta in range(1, D):
        counts = [int(np.sum(delta_of[k * R : (k + 1) * R] == delta)) for k in range(D)]
        K = max(counts)
        if K == 0:
            continue
        send_idx = np.zeros((D, K), np.int32)
        recv_dst = np.full((D, K), R, np.int32)
        _fill_offset_routes(src, delta_of, D, R, delta, send_idx, recv_dst)
        schedule.append((delta, send_idx, recv_dst))
    for tab in (local_idx,) + tuple(t for s in schedule for t in s[1:]):
        tab.flags.writeable = False
    return local_idx, tuple(schedule)


@lru_cache(maxsize=256)
def _device_schedule(C: int, atox: int, m_reg: int, d: int, device: torch.device) -> tuple:
    """_packed_exchange_schedule's tables on `device`: (local_idx (D, R),
    ((delta, send_idx (D, K), recv rows of each receiver without the
    padding), ...)), int64."""
    local_tab, schedule = _packed_exchange_schedule(C, atox, m_reg, d)
    R = local_tab.shape[1]
    on = lambda tab: torch.from_numpy(np.ascontiguousarray(tab, dtype=np.int64)).to(device)
    return on(local_tab), tuple(
        (delta, on(send_tab), tuple(on(row[row < R]) for row in recv_tab)) for delta, send_tab, recv_tab in schedule
    )


def _apply_rows_packed_(views: list, C: int, atox: int, m_reg: int, d: int, comm: Transport) -> None:
    """The m_high oracle's row exchange on (2, R, ...) views of the shards
    (rows second; None for another process's), in place, on the packed
    static schedule: one row gather of each local shard's local sources,
    then per offset one packed send of rows and their placement.  Every
    shard's new rows are made before any view is written."""
    D = len(views)
    tables = {me: _device_schedule(C, atox, m_reg, d, views[me].device) for me in comm.local}
    outs = {me: views[me].index_select(1, tables[me][0][me]) for me in comm.local}
    for i, delta in enumerate(entry[0] for entry in tables[comm.local[0]][1]):
        bufs = [None] * D
        for p in comm.local:  # padded to one shape across the shards
            bufs[p] = views[p].index_select(1, tables[p][1][i][1][p])
        received = comm.ppermute(bufs, _rotation(D, delta))
        del bufs
        for k in comm.local:
            rows = tables[k][1][i][2][k]  # the padding (row R) is a suffix, dropped
            if rows.numel():
                outs[k].index_copy_(1, rows, received[k][:, : rows.numel()])
        del received
    for me, o in outs.items():
        views[me].copy_(o)


def _apply_camodc_high_(shards: list, g: Gate, d: int, comm: Transport) -> None:
    """The m_high oracle (work register in the top m_reg bits, the global
    bits inside it) on the mesh: the row exchange of the (R, 2^(n-m_reg))
    row view, on the columns whose control bit is 1."""
    C, atox, m_reg = g.meta
    if d > m_reg:
        raise ValueError("m_high sharding needs the global bits inside the M register")
    c_phys = g.qubits[0]
    R = (1 << m_reg) >> d
    B = 1 << c_phys
    views = [None if x is None else x.view(2, R, -1, 2, B)[:, :, :, 1, :] for x in shards]
    _apply_rows_packed_(views, int(C), int(atox), m_reg, d, comm)


@lru_cache(maxsize=16)
def _ladder_rows(C: int, A_list: tuple, m_reg: int, d: int, device: torch.device) -> torch.Tensor:
    """(D, R, 2^K) int64 on `device`: the global source row of each shard's
    row under each control mask of a ladder, (combo * f) mod C for f < C,
    f otherwise."""
    combos = torch.from_numpy(tops.modexp_combo_multipliers(C, A_list)).to(device)
    f = torch.arange(1 << m_reg, dtype=torch.int64, device=device)[:, None]
    return torch.where(f < C, (combos[None, :] * f) % C, f).view(1 << d, (1 << m_reg) >> d, -1)


@lru_cache(maxsize=16)
def _ladder_masks(rest: int, controls: tuple, device: torch.device) -> torch.Tensor:
    """Each column's control mask (ops/gates._column_bits), on `device`."""
    return tops._column_bits(rest, controls, device)


def _apply_ladder_high_(shards: list, g: Gate, d: int, comm: Transport) -> None:
    """A fused run of m_high oracles on the mesh: the composed source row
    (mult * f) mod C depends on each column's control bits, so one rotation
    of D - 1 whole-shard exchanges serves the run; each output element
    takes the element of its source row.  Out of place, a block of columns
    at a time: the D source shards' column blocks are joined into one
    (2, D * R, cols) block in global row order (on one device the received
    shards are the senders' own, so one join serves every shard; received
    copies are joined for each receiver), and each shard gathers its rows
    from it through a (row, control-mask) table of global source rows."""
    C, m_reg = g.meta[0], g.meta[1]
    if d > m_reg:
        raise ValueError("m_high sharding needs the global bits inside the M register")
    D = len(shards)
    R = (1 << m_reg) >> d
    rest = shards[comm.local[0]].shape[1] // R
    # incoming[delta][me]: the shard (me - delta) % D, as shard me receives it.
    incoming = [shards] + [comm.ppermute(shards, _rotation(D, delta)) for delta in range(1, D)]
    tables = {me: _ladder_rows(C, g.meta[2:], m_reg, d, shards[me].device)[me] for me in comm.local}
    masks = {me: _ladder_masks(rest, g.qubits, shards[me].device) for me in comm.local}
    out = [torch.empty_like(x).view(2, R, rest) if x is not None else None for x in shards]
    cols = max(1, min(rest, _LADDER_CHUNK // (D * R)))
    for c0 in range(0, rest, cols):
        c1 = min(rest, c0 + cols)
        joined_from, joined = None, None
        for me in comm.local:
            sources = [incoming[(me - e) % D][me] for e in range(D)]
            if joined_from != [id(t) for t in sources]:
                joined = torch.cat([t.view(2, R, rest)[:, :, c0:c1] for t in sources], dim=1)
                joined_from = [id(t) for t in sources]
            idx = tables[me][:, masks[me][c0:c1]]
            for p in range(2):
                out[me][p, :, c0:c1] = torch.gather(joined[p], 0, idx)
    del incoming, joined
    shards[:] = [None if o is None else o.view(2, -1) for o in out]


# ---------------------------------------------------------------------------
# Dispatch.


def _local_gate_(x: torch.Tensor, g: Gate, M: int, backend: str) -> None:
    """A gate on shard-local qubits, in place: the plain ops on the torch
    backend, apply_gate_planes_ (the kernels, their plain versions on CPU
    shards) on the cuda backend, as the single device applies a lone gate."""
    if backend == "torch":
        seng.apply_circuit_plain_(x, (g,), M)
    else:
        seng.apply_gate_planes_(x, g, M)


def apply_gate_sharded_(
    shards: list, g: Gate, *, n: int, M: int, d: int, comm: Transport, backend: str
) -> list:
    """Dispatch one gate over the shards (list updated in place and
    returned): the JAX package's apply_gate_sharded and its planar twin."""
    n_local = n - d

    def is_global(q: int) -> bool:
        return q >= n_local

    name = g.name
    mine = [(me, shards[me]) for me in comm.local]
    if name in ("camodc_high", "camodc_ladder_high"):
        if d == 0:
            _local_gate_(shards[0], g, M, backend)
        elif name == "camodc_high":
            _apply_camodc_high_(shards, g, d, comm)
        else:
            _apply_ladder_high_(shards, g, d, comm)
        return shards
    if not any(is_global(q) for q in g.qubits):
        for _, x in mine:
            _local_gate_(x, g, M, backend)
        return shards

    if name in DENSE_1Q:
        _apply_1q_global_(shards, gate_matrix_1q(g), g.qubits[0] - n_local, comm)
    elif name in DIAGONAL_1Q:
        dg = np.diagonal(gate_matrix_1q(g))
        p = g.qubits[0] - n_local
        for me, x in mine:
            _scale_(x, dg[_device_bit(me, p)])
    elif name in ("cz", "cphase"):
        d4 = np.diagonal(gate_matrix_2q(g))
        q_hi, q_lo = g.qubits if g.qubits[0] > g.qubits[1] else (g.qubits[1], g.qubits[0])
        for me, x in mine:
            if is_global(q_hi) and is_global(q_lo):
                _scale_(x, d4[2 * _device_bit(me, q_hi - n_local) + _device_bit(me, q_lo - n_local)])
            elif is_global(q_hi):
                b = _device_bit(me, q_hi - n_local)
                _bit_diag_(x, q_lo, d4[2 * b], d4[2 * b + 1])
            else:
                b = _device_bit(me, q_lo - n_local)
                _bit_diag_(x, q_hi, d4[b], d4[2 + b])
    elif name == "mcphase":
        # Global controls are a condition on the shard's bits; the local
        # controls the single-device in-place mcphase.
        local = [q for q in g.qubits if not is_global(q)]
        for me, x in mine:
            if all(_device_bit(me, q - n_local) for q in g.qubits if is_global(q)):
                tops.apply_mcphase_planes_(x, local, g.params[0])
    elif name == "camodc":
        if M > n_local:
            raise ValueError("M register must be shard-local")
        C, atox = g.meta
        p = g.qubits[0] - n_local
        for me, x in mine:
            if _device_bit(me, p):
                _permute_work_(x, tops.inverse_index_table(C, atox, M, x.device), M)
    elif name == "iqft_stage":
        _apply_iqft_global_(shards, g.qubits[0], M, n_local, comm)
    elif name in ("cnot", "swap", "u2q"):
        m4 = gate_matrix_2q(g)
        q0, q1 = g.qubits
        relabel = [0, 2, 1, 3]
        g0, g1 = is_global(q0), is_global(q1)
        if g0 and g1:
            q_hi, q_lo, m = (q0, q1, m4) if q0 > q1 else (q1, q0, m4[np.ix_(relabel, relabel)])
            _apply_2q_both_global_(shards, m, q_hi - n_local, q_lo - n_local, comm)
        elif g0:
            _apply_2q_one_global_(shards, m4, q0 - n_local, q1, comm)
        else:
            _apply_2q_one_global_(shards, m4[np.ix_(relabel, relabel)], q1 - n_local, q0, comm)
    else:
        raise ValueError(f"unknown gate: {g}")
    return shards


def _fuse_mhigh_ladders(circuit: Circuit, M: int, d: int) -> Circuit:
    """Fuse runs of m_high oracles into composed ladders, but only runs of
    K >= D = 2^d: a ladder pays D - 1 whole-shard exchanges, while K packed
    single oracles pay about K (D - 1) / D shards, so shorter runs would
    move more bytes (the JAX package's rule).  Eligibility keeps
    combo * f below 2^31, as there."""
    return seng.fuse_oracle_ladders(
        circuit, M,
        eligible=lambda g: g.name == "camodc_high" and g.meta[0] * (1 << g.meta[2]) < (1 << 31),
        min_run=1 << d,
    )


def plan_sharded(circuit: Circuit, n: int, M: int, d: int, real_dtype: torch.dtype, fused_path: bool, ladders: bool) -> list:
    """The engine's plan of a circuit over a mesh of 2^d shards: with
    `ladders` the m_high oracle runs fused (_fuse_mhigh_ladders); then, on
    the fused path (``fused_path`` and n - d >= FUSED_MIN_LOCAL), each
    maximal run of gates that have a fused-op form and touch only local
    qubits planned by ops/fused.plan_circuit for the local width, as the
    single-device engine plans a state of that width.  Entries are
    ("fused", ops, axes), applied per shard, and ("gate", g), dispatched by
    apply_gate_sharded_."""
    if ladders:
        circuit = _fuse_mhigh_ladders(circuit, M, d)
    n_local = n - d
    if not fused_path or n_local < FUSED_MIN_LOCAL:
        return [("gate", g) for g in circuit]
    plan: list = []
    run: list = []

    def flush():
        for seg in fused.plan_circuit(
            tuple(run), n_local, M, fused.TILE_BITS[real_dtype], group=fused.groups(real_dtype, n_local)
        ):
            plan.append(seg if seg[0] == "fused" else ("gate", seg[1]))
        run.clear()

    for g in circuit:
        if fused.gate_to_op(g, M) is not None and all(q < n_local for q in g.qubits):
            run.append(g)
        else:
            flush()
            plan.append(("gate", g))
    flush()
    return plan


def apply_plan_sharded_(
    shards: list, plan: list, *, n: int, M: int, d: int, comm: Transport, backend: str,
    norms: Optional[list] = None,
) -> list:
    """Run a plan (plan_sharded) over the shards, in place.  With a
    `norms` list, the psum of the shards' norms after each entry is
    appended to it (a 0-d tensor on the first shard's device)."""
    for entry in plan:
        if entry[0] == "fused":
            for me in comm.local:
                fused.apply_fused(shards[me], entry[1], entry[2], M)
        else:
            apply_gate_sharded_(shards, entry[1], n=n, M=M, d=d, comm=comm, backend=backend)
        if norms is not None:
            norms.append(comm.psum([None if x is None else sv.norm(x) for x in shards]))
    return shards


# ---------------------------------------------------------------------------
# Measurement.


def _shard_sums(x: torch.Tensor, plain: bool) -> tuple:
    """(block sums or None, total) of one shard in the compute dtype: the
    block sums (the block-sum kernel on the card) where the sampler picks
    hierarchically, else the flat sum of the probabilities."""
    if x.dtype in (torch.float32, torch.bfloat16) and x.shape[1] >= measure.HIERARCHICAL_MIN_DIM:
        sums = measure.block_sums_plain(x) if plain else measure.block_sums(x)
        return sums, sums.sum()
    return None, sv.probabilities(x).sum()


def two_level_pick(shards: list, rs, comm: Transport, plain: bool, scale_by_total: bool = False) -> list:
    """The sharded inverse-CDF pick (the JAX package's two_level_pick): the
    shards' totals gathered, a cumulative sum over D picks the shard, then
    the single-device sampler inside the chosen shard picks the element at
    the draw less the shards before it.  `rs` are draws in [0, 1) on the
    probability scale (normalized states), or, with scale_by_total, scaled
    by the gathered total here.  Only the owner of the chosen shard knows
    the local index: each shard contributes its picks and zeros elsewhere,
    and a psum of those (the JAX body's psum of a one-hot) hands every
    process the same pairs.  Returns one (shard, local index) pair of
    Python ints per draw."""
    parts = [None if x is None else _shard_sums(x, plain) for x in shards]
    totals = comm.all_gather([None if p is None else p[1] for p in parts]).cpu()
    cum = torch.cumsum(totals, 0)
    r = torch.tensor(np.asarray(rs, dtype=np.float64)).reshape(-1).to(totals.dtype)
    if scale_by_total:
        r = r * cum[-1]
    dev = torch.searchsorted(cum, r, side="left").clamp_(max=len(shards) - 1)
    targets = r - (cum[dev] - totals[dev])
    picks = [None] * len(shards)
    for k in comm.local:
        picks[k] = torch.zeros_like(dev)
        sel = torch.nonzero(dev == k).reshape(-1)
        if sel.numel():
            picks[k][sel] = measure.sample_indices(shards[k], targets[sel], plain, absolute=True, sums=parts[k][0])
    loc = comm.psum(picks).cpu()
    return list(zip(dev.tolist(), loc.tolist()))


class _ShardedAdjointRun(torch.autograd.Function):
    """engine.run as a differentiable function of its input shards (the
    JAX engine's custom_vjp): the forward runs the circuit on copies of the
    shards, the backward runs dagger_circuit on copies of the cotangents,
    both through the same sharded run; nothing is saved.  On a mesh over
    processes the entries of other processes' shards stay None, forward and
    back, and every process must run the backward (its exchanges are
    collectives)."""

    @staticmethod
    def forward(ctx, engine: "ShardedStateVectorEngine", circuit: Circuit, *shards):
        ctx.engine, ctx.circuit = engine, circuit
        return tuple(engine._run(circuit, [None if x is None else x.detach().clone() for x in shards], None))

    @staticmethod
    def backward(ctx, *cts):
        engine = ctx.engine
        adjoint = dagger_circuit(ctx.circuit, engine.m_eff)
        cts = [None if c is None else c.clone(memory_format=torch.contiguous_format) for c in cts]
        return (None, None, *engine._run(adjoint, cts, None))


class ShardedStateVectorEngine:
    """The single-device StateVectorEngine's API over a mesh of shards.

    A state is a list of D planar (2, 2^(n-d)) tensors, shard k on the
    mesh's device k; on a mesh that spans processes (build_mesh under a
    torch.distributed process group) each process holds its own shards and
    the other entries are None, every process runs the same calls, and the
    exchanges go through comm.ProcessTransport.  `mesh` defaults to
    build_mesh() (every visible CUDA card, or CPU_SHARDS virtual CPU
    shards).  dtype: complex64 (float32
    planes), complex128 (float64) or "complex32" (bf16 planes computed in
    float32).  backend: "torch" (every gate through the plain ops, gate by
    gate), "cuda" (the fused path: the kernels on CUDA shards, their plain
    versions on CPU shards, as the JAX engine's pallas backend runs
    interpret mode off the TPU) or "auto" ("cuda" when the mesh's shards
    live on CUDA devices, else "torch").  complex32 runs on the cuda path
    only, as the JAX engine's runs on pallas.  layout: "standard" (the work
    register must be shard-local: M <= n - d) or "m_high" (the global bits
    lie inside the work register: d <= M)."""

    def __init__(
        self,
        register: Register,
        dtype=torch.complex64,
        mesh: Optional[Mesh] = None,
        backend: str = "auto",
        layout: str = "standard",
    ):
        if layout not in ("standard", "m_high"):
            raise ValueError(f"unknown layout {layout!r}")
        if backend not in ("auto", "torch", "cuda"):
            raise ValueError(f"unknown backend {backend!r} (auto, torch or cuda)")
        self.register = register
        self.mesh = mesh if mesh is not None else build_mesh()
        self.d = mesh_degree(self.mesh)
        self.comm = transport_for(self.mesh)
        self.real_dtype = sv.real_dtype_of(dtype)
        self.dtype = {torch.float32: torch.complex64, torch.float64: torch.complex128}.get(self.real_dtype, sv.COMPLEX32)
        on_card = all(dv.type == "cuda" for dv in self.mesh.devices)
        if self.real_dtype == torch.bfloat16:
            if backend == "torch":
                raise ValueError("dtype='complex32' requires backend='cuda' or 'auto'")
            backend = "cuda"
        self.backend = ("cuda" if on_card else "torch") if backend == "auto" else backend
        if any(self.mesh.devices[k].type == "cuda" for k in self.mesh.local) and not torch.cuda.is_available():
            raise ValueError("no CUDA device is available")
        self.layout = layout
        if register.n - self.d < 1:
            raise ValueError("register too small for this mesh")
        if layout == "m_high":
            if self.d > register.M:
                raise ValueError(
                    f"mesh degree d={self.d} must be <= M={register.M}: "
                    "the m_high global bits must lie inside the work register"
                )
        elif register.M > register.n - self.d:
            raise ValueError(
                f"M={register.M} must be <= n_local={register.n - self.d}: "
                "the work register must stay shard-local"
            )
        self.n_local = register.n - self.d
        self.m_eff = 0 if layout == "m_high" else register.M
        self.reset_index = (1 << register.L) if layout == "m_high" else 1
        if not mesh_fits(1.25, self.n_local, self.real_dtype, self.mesh):
            dev = self.mesh.first_device
            raise ValueError(
                f"a 2^{register.n} state of {self.dtype} in {self.mesh.size} shards does not fit the "
                f"{device_memory_budget(dev)} usable bytes of {dev} ({self.mesh.shards_on(dev)} shards on it)"
            )
        self._plans: dict = {}

    @property
    def shard_len(self) -> int:
        return 1 << self.n_local

    def logical_index(self, phys: int) -> int:
        """Measured physical basis index -> logical (reference convention)."""
        if self.layout == "standard":
            return phys
        L, M = self.register.L, self.register.M
        return (phys >> L) | ((phys & ((1 << L) - 1)) << M)

    def _global_index(self, dev: int, loc: int) -> int:
        """Compose a measured (shard, local index) pair on the host: Python
        ints are exact at any n (2^32 and beyond)."""
        return (dev << self.n_local) | loc

    # -- state lifecycle ----------------------------------------------------

    def _basis_state(self, index: int) -> list:
        dev, loc = divmod(index, self.shard_len)
        shards = [None] * self.mesh.size
        for k in self.mesh.local:
            shards[k] = torch.zeros((2, self.shard_len), dtype=self.real_dtype, device=self.mesh.devices[k])
        if shards[dev] is not None:
            shards[dev][0, loc] = 1.0
        return shards

    def initial_state(self) -> list:
        """|00...01> (layout-aware), sharded."""
        return self._basis_state(self.reset_index)

    def zero_state(self) -> list:
        return self._basis_state(0)

    def from_planar(self, planar: torch.Tensor) -> list:
        """A (2, 2^n) planar state cut into this engine's shards (copies on
        the mesh's devices, in its plane dtype; this process's shards)."""
        shards = [None] * self.mesh.size
        for k in self.mesh.local:
            piece = planar[:, k * self.shard_len : (k + 1) * self.shard_len]
            shards[k] = piece.to(device=self.mesh.devices[k], dtype=self.real_dtype).contiguous()
        return shards

    def _whole(self, state: list) -> list:
        """The shards of a state this process holds whole; raises where
        another process holds some (the JAX package's fetch of a global
        array fails across processes too)."""
        if any(x is None for x in state):
            raise RuntimeError(
                "the state spans shards held by other processes: only the local shards "
                f"{list(self.mesh.local)} of {self.mesh.size} can be read here"
            )
        return state

    def to_planar(self, state: list) -> torch.Tensor:
        """The shards joined into one (2, 2^n) planar CPU tensor."""
        return torch.cat([x.detach().cpu() for x in self._whole(state)], dim=1)

    # -- execution ----------------------------------------------------------

    def plan(self, circuit: Circuit) -> list:
        """The circuit's plan (plan_sharded), cached per circuit.  Ladders
        fuse only where two states fit each device, the shards that share a
        device counted together (the ladder builds its result out of place);
        otherwise every oracle takes the packed exchange."""
        plan = self._plans.get(circuit)
        if plan is None:
            plan = plan_sharded(
                circuit, self.register.n, self.m_eff, self.d, self.real_dtype, self.backend == "cuda",
                mesh_fits(2, self.n_local, self.real_dtype, self.mesh),
            )
            self._plans[circuit] = plan
        return plan

    def _run(self, circuit: Circuit, state: Optional[list], norms: Optional[list]) -> list:
        shards = self.initial_state() if state is None else state
        return apply_plan_sharded_(
            shards, self.plan(circuit), n=self.register.n, M=self.m_eff, d=self.d, comm=self.comm,
            backend=self.backend, norms=norms,
        )

    def run(self, circuit: Circuit, state: Optional[list] = None) -> list:
        """Apply a circuit and return the sharded state.  With no input the
        run starts from the reset; a caller's `state` is CONSUMED (its
        entries are replaced or updated in place).  Differentiable in its
        shards, as the single-device engine's run is: when grad mode is on
        and a shard requires grad, the run leaves `state` alone and returns
        new shards whose backward applies the dagger circuit to the
        cotangents through the same sharded run (on a mesh over processes,
        a collective: every process runs its backward)."""
        if state is not None and torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in state):
            return list(_ShardedAdjointRun.apply(self, circuit, *state))
        return self._run(circuit, state, None)

    def run_with_norms(self, circuit: Circuit, state: Optional[list] = None) -> Tuple[list, torch.Tensor]:
        """run(), also returning the norm trace across the mesh: one psum of
        the shards' norms per fused segment and per gate otherwise, as a 1-d
        CPU tensor in the compute dtype."""
        norms: list = []
        out = self._run(circuit, state, norms)
        cdt = sv.compute_dtype(self.real_dtype)
        return out, (torch.stack(norms).cpu() if norms else torch.zeros(0, dtype=cdt))

    def run_norm(self, circuit: Circuit) -> float:
        """Reset -> circuit -> norm across the mesh."""
        return self.norm(self.run(circuit))

    def run_and_measure_index(self, circuit: Circuit, r: float) -> int:
        """Reset -> circuit -> the global index draw r measures."""
        return self._pick(self.run(circuit), [r])[0]

    def run_and_measure(self, circuit: Circuit, r: float) -> Tuple[int, list]:
        """Reset -> circuit -> (measured global index, collapsed state)."""
        return self.measure(self.run(circuit), r)

    # -- measurement ----------------------------------------------------------

    def _pick(self, state: list, rs, scale_by_total: bool = False) -> List[int]:
        pairs = two_level_pick(state, rs, self.comm, self.backend == "torch", scale_by_total)
        return [self._global_index(dev, loc) for dev, loc in pairs]

    def measure(self, state: list, r: float) -> Tuple[int, list]:
        """Measure with draw r, then collapse: CONSUMES `state`, which is
        overwritten in place with the one-hot basis state and returned."""
        idx = self._pick(state, [r])[0]
        dev, loc = divmod(idx, self.shard_len)
        for k in self.mesh.local:
            state[k].zero_()
        if state[dev] is not None:
            state[dev][0, loc] = 1.0
        return idx, state

    def sample(self, state: list, rs) -> torch.Tensor:
        """One global index per draw in `rs`, without collapsing, as an int64
        CPU tensor: each draw scaled by the gathered total (which absorbs a
        bf16 state's norm drift), the shard picked, then the shard's own
        sampler, one block-sum pass a shard."""
        return torch.tensor(self._pick(state, rs, scale_by_total=True), dtype=torch.int64)

    # -- inspection ----------------------------------------------------------

    def probabilities(self, state: list) -> torch.Tensor:
        """|amp|^2 of the whole state, one CPU tensor (for small states)."""
        return torch.cat([sv.probabilities(x).cpu() for x in self._whole(state)])

    def norm(self, state: list) -> float:
        return float(self.comm.psum([None if x is None else sv.norm(x) for x in state]))

    def to_numpy(self, state: list) -> np.ndarray:
        """Host-side complex copy of the whole state (for small states)."""
        return np.concatenate([sv.to_numpy_complex(x) for x in self._whole(state)])
