"""Planar state-vector representation.

A state on n qubits is one real tensor of shape (2, 2^n): plane 0 = Re(psi),
plane 1 = Im(psi).  float32 planes carry complex64 semantics, float64 planes
complex128.  The kernels read and write the two planes as separate
contiguous arrays, so the layout is the JAX package's planar layout
(``quantumcomputer_tpu/sim/statevec.py``) and states carry across between
the two packages as numpy arrays (``quantumcomputer_tpu_torch.interop``).
"""

from __future__ import annotations

import numpy as np
import torch

_REAL_OF = {
    torch.complex64: torch.float32,
    torch.complex128: torch.float64,
    "complex64": torch.float32,
    "complex128": torch.float64,
}


def real_dtype_of(cdtype) -> torch.dtype:
    """Plane dtype of a complex dtype (torch dtype or its name)."""
    try:
        return _REAL_OF[cdtype]
    except (KeyError, TypeError):
        raise ValueError(f"not a supported complex dtype: {cdtype!r}") from None


def num_qubits(planar: torch.Tensor) -> int:
    if planar.dim() != 2 or planar.shape[0] != 2:
        raise ValueError(f"planar state must have shape (2, 2^n), got {tuple(planar.shape)}")
    dim = planar.shape[1]
    n = dim.bit_length() - 1
    if dim != 1 << n:
        raise ValueError(f"state length {dim} is not a power of two")
    return n


def initial_planar(n: int, dtype=torch.float32, index: int = 1, device="cpu") -> torch.Tensor:
    """|00...01> as planes: Re at `index` is 1 (qc_shor.c:318-324)."""
    planar = torch.zeros((2, 1 << n), dtype=dtype, device=device)
    planar[0, index] = 1.0
    return planar


def to_complex(planar: torch.Tensor) -> torch.Tensor:
    """(2, dim) planes -> (dim,) complex tensor (a copy)."""
    return torch.complex(planar[0], planar[1])


def probabilities(planar: torch.Tensor) -> torch.Tensor:
    return planar[0] * planar[0] + planar[1] * planar[1]


def norm(planar: torch.Tensor) -> torch.Tensor:
    """Sum of |amp|^2 as a 0-d tensor on the state's device."""
    return torch.sum(planar[0] * planar[0]) + torch.sum(planar[1] * planar[1])


def to_numpy_complex(planar: torch.Tensor) -> np.ndarray:
    """Host-side complex copy of a planar state."""
    host = planar.detach().cpu().numpy()
    return host[0] + 1j * host[1]
