"""Structured modular-stride permutation: out[j] = x[(m*j) mod C] (j < C,
identity above) by transposes instead of an element gather.

The counterpart of the JAX package's ``ops/modperm.py``, which holds the
design.  The plan is that package's, field for field:

  1. ``rational_split`` writes a_inv = eps * u * v^-1 (mod C) with u, v near
     sqrt(C).  Multiplier permutations F_m(x)[j] = x[(m*j) mod C] compose
     multiplicatively, so F_a_inv = F_eps . F_u . F_v^-1.
  2. The collect leg (F_v^-1): with j = q*v + t, out[q*v + t] =
     x[(v^-1 t + q) mod C], one contiguous run of x per t.
  3. The deal leg (F_u): with the source s = q*u + t, out[(u^-1 t + q) mod
     C] = x[q*u + t], each column of the (q, t) row view landing as one
     contiguous run.
  4. F_-1, an index reversal, folds into the last leg's run indices.

``apply_stride_permute`` runs each leg as ONE pass of
``transpose.offset_transpose`` (``legs``: the collect leg where v > 1, then
the deal leg where u > 1, eps in whichever runs last, the reversal alone
where neither does): on a CUDA tensor the offset-transpose kernel, on a CPU
tensor its plain version.  Two passes are this factorization's floor.

The JAX package's own leg structure is kept beside it, off the main path,
as the CPU tests' second reference: ``_collect_leg`` (rows gathered with
``chunk_gather_src2``, one transpose, the row compaction), ``_deal_leg``
(the transposed row view and ``chunk_gather_blend``) and ``_negate_mod``
(``torch.flip``).  Planning uses that package's accelerator floor on every
device: each non-unit factor is at least 256 (``MIN_FACTOR``), the
condition of its kernel path, and the deal chunk and collect rows are
sized as there (``W``, ``collect_chunking``), which only the old legs read.
The kernels' plane offsets are 64-bit (the offset transpose indexes inside
a plane in 32 bits, under the planner's C < 2^30), so that package's < 2^31
guards do not apply.  A multiplier the planner refuses returns None, and the
caller takes the gather oracle.

The permutation is the same as the JAX package's, element for element.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from quantumcomputer_tpu_torch.ops.chunkgather import (
    chunk_gather,
    chunk_gather_blend,
    chunk_gather_blend_rowlaw,
    chunk_gather_src2,
)
from quantumcomputer_tpu_torch.ops.gates import modmul_onchip
from quantumcomputer_tpu_torch.ops.transpose import COLLECT, DEAL, offset_transpose, tiled_transpose_padded

# The JAX package's plan constants (ops/modperm.py).
_MAX_CHUNK = 16384  # deal-leg chunk width cap
_MIN_CHUNK = 128
_ROW_W_CAP = 131072  # collect rows wider than this split into chunks
_ROW_SPLIT_W = 32768
MIN_FACTOR = 256  # the accelerator's floor on a non-unit split factor
LANE = 128


def rational_split(a_inv: int, C: int, min_factor: int = MIN_FACTOR) -> Optional[Tuple[int, int, int]]:
    """(eps, u, v) with a_inv = eps * u * v^-1 (mod C), u and v as balanced
    as the continued-fraction lattice allows and each 1 or >= min_factor,
    or None.  Extended Euclid on (C, a_inv) keeps a_inv * t_i = r_i (mod
    C): u = r_i, v = |t_i|, eps = sign(t_i), minimising max(r_i, |t_i|)."""
    a_inv %= C
    if a_inv == 0 or math.gcd(a_inv, C) != 1:
        return None

    def ok(f: int) -> bool:
        return f == 1 or f >= min_factor

    r0, r1 = C, a_inv
    t0, t1 = 0, 1
    best = best_cost = None
    while r1 > 0:
        cost = max(r1, abs(t1))
        if math.gcd(r1, C) == 1 and ok(r1) and ok(abs(t1)) and (best_cost is None or cost < best_cost):
            best, best_cost = (1 if t1 > 0 else -1, r1, abs(t1)), cost
        q = r0 // r1
        r0, r1 = r1, r0 - q * r1
        t0, t1 = t1, t0 - q * t1
    return best


@dataclass(frozen=True)
class StridePlan:
    """Static plan of one structured permutation (per (C, a_inv, M))."""

    C: int
    M: int
    eps: int
    u: int  # deal-leg multiplier (1 = skip)
    v: int  # collect-leg structure parameter (1 = skip)
    vinv: int  # v^-1 mod C (the collect leg's row-start multiplier)
    W: int  # deal-leg output chunk width


def plan_stride_permute(
    C: int, a_inv: int, M: int, max_chunk: int = _MAX_CHUNK, min_factor: int = MIN_FACTOR
) -> Optional[StridePlan]:
    """The plan, or None where the structured path does not apply: a
    trivial multiplier, no split within the factor floor, a deal chunk
    below 128 (W*u <= C is needed), or collect rows narrower than 128."""
    dim = 1 << M
    if C > dim or C >= (1 << 30):
        return None
    a_inv %= C
    if a_inv <= 1:
        return None
    split = rational_split(a_inv, C, min_factor)
    if split is None:
        return None
    eps, u, v = split
    W = max_chunk
    while W > dim:
        W //= 2
    while W >= _MIN_CHUNK and W * u > C:
        W //= 2
    if u > 1 and W < _MIN_CHUNK:
        return None
    if v > 1 and (C - 1) // v + 1 < _MIN_CHUNK:
        return None
    vinv = pow(v, -1, C) if v > 1 else 1
    return StridePlan(C=C, M=M, eps=eps, u=u, v=v, vinv=vinv, W=W)


def collect_chunking(C: int, v: int) -> Tuple[int, int, int]:
    """(Wc, Qpr, K) of the collect leg: rows of Qpv = ceil(C/v) live
    elements gathered at the 128-rounded width Qpr, split into K chunks of
    Wc when wider than the row cap (the candidate width that rounds Qpv up
    least, ties to the wider).  Qpr = K * Wc by construction."""
    Qpv = (C - 1) // v + 1
    Qpr = -(-Qpv // LANE) * LANE
    Wc = Qpr
    if Qpr > _ROW_W_CAP:
        best = None
        cand = _ROW_SPLIT_W
        while cand >= max(_ROW_SPLIT_W // 8, LANE):
            q = -(-Qpv // cand) * cand
            if best is None or q < best[1]:
                best = (cand, q)
            cand //= 2
        Wc, Qpr = best
    return Wc, Qpr, Qpr // Wc


def _negate_mod(x: torch.Tensor, C: int) -> torch.Tensor:
    """F_-1: out[0] = x[0], out[j] = x[C - j] for 0 < j < C, identity above."""
    parts = [x[..., :1], torch.flip(x[..., 1:C], dims=(-1,))]
    if C < x.shape[-1]:
        parts.append(x[..., C:])
    return torch.cat(parts, dim=-1)


def _row_compact(w2: torch.Tensor, v: int, dim: int) -> torch.Tensor:
    """(B, rows, vpad) padded row view -> (B, dim) flat with
    flat[q*v + t] = w2[b, q, t] (t < v), exact for positions < (rows-1)*v.
    Each Wt-wide flat chunk is two slices of w2's storage split at the one
    row boundary it crosses (Wt <= v), so the offsets follow one law in the
    chunk index (``chunk_gather_blend_rowlaw``).  The caller supplies one
    slack row past the live ones (the transpose's extra row), read only by
    positions it discards."""
    B, rows, vpad = w2.shape
    if rows < 2:
        raise ValueError(f"row compaction needs a slack row, got {rows} rows")
    Wt = min((v // LANE) * LANE, _MAX_CHUNK)
    NCt = -(-dim // Wt)
    out = chunk_gather_blend_rowlaw(w2.reshape(B, rows * vpad), NCt, v, vpad, Wt)
    return out.reshape(B, NCt * Wt)[:, :dim]


def _deal_leg(x: torch.Tensor, C: int, u: int, M: int, W: int) -> torch.Tensor:
    """F_u: out[j] = x[(u*j) mod C] (j < C), x[j] above.

    The source index rem = (u*j) mod C splits as q*u + t.  Row r of the
    view w2 is x[r*u - LANE : r*u - LANE + WIDTH] (LANE junk lanes before
    the data), so its transpose y0 holds x[q*u + t] at (LANE + t, q).  An
    output chunk at j0 is y0[LANE + t1, q1 + i] up to the wrap i* and
    y0[LANE + t2, i - i*] after it (W*u <= C: one wrap at most)."""
    dim = 1 << M
    lead = x.shape[:-1]
    xf = x.reshape(-1, dim).contiguous()
    B = xf.shape[0]
    dev = x.device
    Qp = (C - 1) // u + 1
    Qp2 = -(-Qp // LANE) * LANE
    WIDTH = -(-u // LANE) * LANE + 2 * LANE

    # Rows straight from the state, starts clamped; the rows whose window
    # leaves [0, dim) (row 0, and the last live ones) are rewritten exactly.
    # Junk rows r >= Qp have no reader.
    w2 = chunk_gather(xf, torch.arange(Qp2, device=dev, dtype=torch.int64) * u - LANE, WIDTH)
    w2[:, 0, :LANE] = 0
    w2[:, 0, LANE:] = xf[:, : WIDTH - LANE]
    for r in range(max(1, (dim + LANE - WIDTH) // u + 1), Qp):
        s = r * u - LANE
        take = max(0, min(dim - s, WIDTH))
        w2[:, r, :take] = xf[:, s : s + take]
        w2[:, r, take:] = 0
    y0 = tiled_transpose_padded(w2)  # (B, WIDTH, Qp2): no padding
    del w2
    pitch = y0.shape[2]

    # Every chunk of the plane: those past C read clamped, in-range junk and
    # are overwritten by the identity tail, so the output is the plane itself.
    NC = dim // W
    j0 = torch.arange(NC, device=dev, dtype=torch.int64) * W
    rem0 = modmul_onchip(u, j0, C)
    t1 = rem0 % u
    q1 = rem0 // u
    istar = ((C - rem0 + u - 1) // u).clamp(0, W)
    t2 = (rem0 + istar * u - C).clamp(0, u - 1)
    s0 = (t1 + LANE) * pitch + q1
    s1 = (t2 + LANE) * pitch - istar
    flat = chunk_gather_blend(y0.reshape(B, -1), s0, s1, istar, W).reshape(B, dim)
    del y0
    if C < dim:
        flat[:, C:] = xf[:, C:]
    return flat.reshape(lead + (dim,))


def _collect_leg(x: torch.Tensor, C: int, v: int, vinv: int, M: int) -> torch.Tensor:
    """F_v^-1: out[j] = x[(v^-1 * j) mod C] (j < C), x[j] above.

    With j = q*v + t, out[q*v + t] = x[(j0(t) + q) mod C], j0(t) = v^-1 t
    mod C: one contiguous run per t, wrapping mod C at most once.  Each
    Wc-wide chunk of a run is one straight read: from the state, or from
    the cyclic join [x[C-Wc : C] | x[:Wc]] where it straddles C.  The rows
    (vpad of them, those past v junk) transpose to (Qpr, vpad) and compact
    to flat order."""
    dim = 1 << M
    lead = x.shape[:-1]
    xf = x.reshape(-1, dim).contiguous()
    B = xf.shape[0]
    dev = x.device
    Wc, Qpr, K = collect_chunking(C, v)
    vpad = -(-v // LANE) * LANE

    t = torch.arange(vpad, device=dev, dtype=torch.int64)
    j0 = torch.where(t < v, modmul_onchip(vinv, t, C), 0)
    base = (j0[:, None] + Wc * torch.arange(K, device=dev, dtype=torch.int64)[None, :]).reshape(-1)
    in_join = (base > C - Wc) & (base < C)
    starts = torch.where(in_join, base - (C - Wc), torch.where(base < C, base, base - C))
    xjoin = torch.cat([xf[:, C - Wc : C], xf[:, :Wc]], dim=-1)
    y0 = chunk_gather_src2(xf, xjoin, starts, in_join, Wc).reshape(B, vpad, Qpr)
    del xjoin
    w2 = tiled_transpose_padded(y0, extra_rows=1)  # (B, Qpr + 1, vpad)
    del y0
    flat = _row_compact(w2, v, dim)
    del w2
    if C < dim:
        flat[:, C:] = xf[:, C:]
    return flat.reshape(lead + (dim,))


@functools.lru_cache(maxsize=256)
def legs(plan: StridePlan) -> Tuple[Tuple[int, int, int, int], ...]:
    """The offset-transpose launches of one plane's permutation, in order,
    as (R, m, leg, sign) with m * R = 1 (mod C): the collect leg (v, v^-1)
    where v > 1, then the deal leg (u, u^-1) where u > 1, with eps as the
    last one's sign; the reversal (1, 1) alone where neither runs."""
    C = plan.C
    out = []
    if plan.v > 1:
        out.append((plan.v, plan.vinv, COLLECT))
    if plan.u > 1:
        out.append((plan.u, pow(plan.u, -1, C), DEAL))
    if not out:
        out.append((1, 1, COLLECT))
    return tuple((R, m, leg, plan.eps if i == len(out) - 1 else 1) for i, (R, m, leg) in enumerate(out))


def apply_stride_permute(x: torch.Tensor, plan: StridePlan) -> torch.Tensor:
    """out[..., j] = x[..., (a_inv*j) mod C] for j < C, x[..., j] above: the
    ``modmul_inverse_permutation`` gather as one offset transpose a leg
    (``legs``), each into a fresh tensor; a leg's input is freed as the next
    one runs."""
    dim = 1 << plan.M
    if x.shape[-1] != dim:
        raise ValueError(f"x has {x.shape[-1]} elements per row, the plan 2^{plan.M}")
    lead = x.shape[:-1]
    out = x.reshape(-1, dim).contiguous()
    for R, m, leg, sign in legs(plan):
        out = offset_transpose(out, plan.C, R, m, sign, leg)
    return out.reshape(lead + (dim,))


def modmul_stride_permute(x: torch.Tensor, C: int, a_inv: int, M: int) -> torch.Tensor:
    """Plan and apply in one call; raises where the structured path does
    not apply."""
    plan = plan_stride_permute(C, a_inv, M)
    if plan is None:
        raise ValueError(f"structured stride permutation unsupported for C={C}, a_inv={a_inv}, M={M}")
    return apply_stride_permute(x, plan)
