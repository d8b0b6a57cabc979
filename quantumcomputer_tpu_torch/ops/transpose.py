"""Tiled transpose of the structured stride permutation: wrapper and plain
version.

The counterpart of the JAX package's ``ops/pallas_transpose.py`` as
``ops/modperm.py`` calls it (``tiled_transpose_padded`` with 128 x 128
blocks).  The output is PADDED: the permutation legs index it with its
padded row pitch, so its shape is part of the contract.  The CUDA kernel
is ``csrc/transpose.cu``.

The wrapper takes the plain version for a CPU tensor, launches the kernel
for a CUDA tensor at every size, and raises for any other device.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from quantumcomputer_tpu_torch.ops import _build

#: Kernel launches (CUDA tensors only).
LAUNCHES = 0

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
