"""Transposes of the structured stride permutation: wrappers and plain
versions, over the two kernels of ``csrc/transpose.cu``.

``tiled_transpose_padded`` is the counterpart of the JAX package's
``ops/pallas_transpose.py`` as its ``ops/modperm.py`` calls it (128 x 128
blocks).  The output is PADDED: the permutation's old legs
(``modperm._collect_leg`` / ``_deal_leg``) index it with its padded row
pitch, so its shape is part of the contract.

``offset_transpose`` is one leg of the structured permutation in one pass,
the main path's only kernel there: with m * R = 1 (mod C), for 0 <= t < R
and f = q * R + t < C,

    collect:  out[f] = x[r(t, q)]        deal:  out[r(t, q)] = x[f]
    r(t, q) = sign * (m * t + q) mod C

and out[j] = x[j] for C <= j < dim.  Column t of the (q, t) matrix is one
contiguous run of the other side from (sign * m * t) mod C, so the leg is a
transpose whose runs start at offsets computed from the row index (the
kernel's note has the design).  Its plain version applies the same index law
with torch indexing, 2^22 elements at a time.

Each wrapper takes the plain version for a CPU tensor, launches its kernel
for a CUDA tensor at every size, and raises for any other device.
``LAUNCHES`` counts padded-transpose launches, ``OFFSET_LAUNCHES``
offset-transpose launches.
"""

from __future__ import annotations

import torch

from quantumcomputer_tpu_torch.ops import _build

#: Padded-transpose launches (CUDA tensors only).
LAUNCHES = 0
#: Offset-transpose launches (CUDA tensors only): one a leg of a plane.
OFFSET_LAUNCHES = 0

#: The offset transpose's two legs.
COLLECT, DEAL = 0, 1

BLOCK = 128
_DTYPES = (torch.float32, torch.float64, torch.bfloat16)


def padded_shape(R: int, Cc: int, extra_rows: int = 0) -> tuple:
    """(rows, pitch) of the transposed (R, Cc) view: (Cp + extra_rows, Rp)."""
    return -(-Cc // BLOCK) * BLOCK + extra_rows, -(-R // BLOCK) * BLOCK


def _check(x: torch.Tensor, extra_rows: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, R, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32, float64 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if extra_rows < 0:
        raise ValueError(f"extra_rows={extra_rows} must be >= 0")


def transpose_plain(x: torch.Tensor, extra_rows: int = 0) -> torch.Tensor:
    """(B, R, Cc) -> (B, Cp + extra_rows, Rp): out[b, c, r] = x[b, r, c],
    zero on the padding of the first Cp rows, the extra rows unwritten."""
    _check(x, extra_rows)
    B, R, Cc = x.shape
    rows, pitch = padded_shape(R, Cc, extra_rows)
    out = torch.empty((B, rows, pitch), dtype=x.dtype, device=x.device)
    cp = rows - extra_rows
    out[:, :cp].zero_()
    out[:, :Cc, :R] = x.transpose(1, 2)
    return out


def tiled_transpose_padded(x: torch.Tensor, extra_rows: int = 0) -> torch.Tensor:
    """The padded transpose of `x` (see ``transpose_plain``): the plain
    version on the CPU, the kernel on a CUDA device."""
    _check(x, extra_rows)
    kind = x.device.type
    if kind == "cpu":
        return transpose_plain(x, extra_rows)
    if kind != "cuda":
        raise ValueError(f"no transpose path for device {x.device}")
    global LAUNCHES
    B, R, Cc = x.shape
    rows, pitch = padded_shape(R, Cc, extra_rows)
    out = torch.empty((B, rows, pitch), dtype=x.dtype, device=x.device)
    fn = _build.entry("qc_transpose", x.dtype)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), B, R, Cc, extra_rows, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "transpose")
    LAUNCHES += 1
    return out


_PLAIN_BLOCK = 1 << 22


def _check_leg(x: torch.Tensor, C: int, R: int, m: int, sign: int, leg: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (B, dim), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32, float64 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not 0 < C <= x.shape[1] or C >= 1 << 30:
        raise ValueError(f"C={C} must lie in (0, dim] and below 2^30, dim={x.shape[1]}")
    if not 0 < R <= C or not 0 <= m < C or (m * R) % C != 1 % C:
        raise ValueError(f"need 0 < R <= C, 0 <= m < C and m * R = 1 mod C, got R={R}, m={m}, C={C}")
    if sign not in (1, -1) or leg not in (COLLECT, DEAL):
        raise ValueError(f"sign must be +1 or -1 and leg COLLECT or DEAL, got {sign}, {leg}")


def offset_transpose_plain(x: torch.Tensor, C: int, R: int, m: int, sign: int, leg: int) -> torch.Tensor:
    """The offset transpose's index law (module docstring) with torch
    indexing: a new (B, dim) tensor."""
    _check_leg(x, C, R, m, sign, leg)
    out = torch.empty_like(x)
    for lo in range(0, C, _PLAIN_BLOCK):
        hi = min(C, lo + _PLAIN_BLOCK)
        f = torch.arange(lo, hi, device=x.device)
        r = (m * (f % R) + f // R) % C
        if sign < 0:
            r = (C - r) % C
        if leg == COLLECT:
            out[:, lo:hi] = x[:, r]
        else:
            out[:, r] = x[:, lo:hi]
    out[:, C:] = x[:, C:]
    return out


def offset_transpose(x: torch.Tensor, C: int, R: int, m: int, sign: int, leg: int) -> torch.Tensor:
    """One leg of the structured stride permutation (module docstring) as a
    new (B, dim) tensor: the plain version on the CPU, the kernel on a CUDA
    device."""
    _check_leg(x, C, R, m, sign, leg)
    kind = x.device.type
    if kind == "cpu":
        return offset_transpose_plain(x, C, R, m, sign, leg)
    if kind != "cuda":
        raise ValueError(f"no offset transpose path for device {x.device}")
    global OFFSET_LAUNCHES
    B, dim = x.shape
    out = torch.empty_like(x)
    fn = _build.entry("qc_offset_transpose", x.dtype)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), B, dim, C, R, m, sign, leg, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "offset transpose")
    OFFSET_LAUNCHES += 1
    return out
