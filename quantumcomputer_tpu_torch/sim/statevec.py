"""Planar state-vector representation.

A state on n qubits is one real tensor of shape (2, 2^n): plane 0 = Re(psi),
plane 1 = Im(psi).  float32 planes carry complex64 semantics, float64 planes
complex128.  The kernels read and write the two planes as separate
contiguous arrays, so the layout is the JAX package's planar layout
(``quantumcomputer_tpu/sim/statevec.py``) and states carry across between
the two packages as numpy arrays (``quantumcomputer_tpu_torch.interop``).

bfloat16 planes are the storage-only "complex32" mode, as in the JAX
package: no complex dtype exists at that width (``torch.complex32`` is a
pair of float16, whose smallest normal, 6.1e-5, lies above a uniform
amplitude at n = 31).  Kernels widen bf16 to float32, compute there and
round to bf16 once, at the store; probabilities, norms and draws of a bf16
state are float32 (``compute_dtype``).
"""

from __future__ import annotations

import numpy as np
import torch

#: The engine's dtype token of the bf16-storage mode.
COMPLEX32 = "complex32"

_REAL_OF = {
    torch.complex64: torch.float32,
    torch.complex128: torch.float64,
    "complex64": torch.float32,
    "complex128": torch.float64,
    COMPLEX32: torch.bfloat16,
    "c32": torch.bfloat16,
}

# Elements per chunk of a bf16 reduction: bounds its float32 temporaries.
_CHUNK = 1 << 26


def real_dtype_of(cdtype) -> torch.dtype:
    """Plane dtype of a complex dtype (torch dtype or its name)."""
    try:
        return _REAL_OF[cdtype]
    except (KeyError, TypeError):
        raise ValueError(f"not a supported complex dtype: {cdtype!r}") from None


def complex_dtype_of(real_dtype: torch.dtype) -> torch.dtype:
    """Complex dtype of a plane dtype: complex64 for float32 and bf16 (bf16
    computes in float32), complex128 for float64."""
    if real_dtype in (torch.float32, torch.bfloat16):
        return torch.complex64
    if real_dtype == torch.float64:
        return torch.complex128
    raise ValueError(f"not a planar real dtype: {real_dtype}")


def compute_dtype(real_dtype: torch.dtype) -> torch.dtype:
    """The dtype arithmetic, sums and draws run in: float32 for bf16
    planes, the plane dtype otherwise."""
    return torch.float32 if real_dtype == torch.bfloat16 else real_dtype


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


def zero_planar(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """|00...0> as planes."""
    return initial_planar(n, dtype, 0, device)


def to_complex(planar: torch.Tensor) -> torch.Tensor:
    """(2, dim) planes -> (dim,) complex tensor (a copy); bf16 planes widen
    to complex64."""
    cdt = compute_dtype(planar.dtype)
    return torch.complex(planar[0].to(cdt), planar[1].to(cdt))


def from_complex(z: torch.Tensor) -> torch.Tensor:
    """(dim,) complex tensor -> (2, dim) planes of its real dtype (a copy).
    Out of place, as to_complex is, so autograd runs through both."""
    return torch.stack([z.real, z.imag])


def probabilities(planar: torch.Tensor) -> torch.Tensor:
    """|amp|^2 per amplitude, in compute_dtype (float32 for bf16 planes)."""
    planar = planar.to(compute_dtype(planar.dtype))
    return planar[0] * planar[0] + planar[1] * planar[1]


def norm(planar: torch.Tensor) -> torch.Tensor:
    """Sum of |amp|^2 as a 0-d tensor on the state's device, accumulated in
    compute_dtype (a bf16 state in float32 chunks of _CHUNK elements)."""
    if planar.dtype != torch.bfloat16:
        return torch.sum(planar[0] * planar[0]) + torch.sum(planar[1] * planar[1])
    return sum(torch.sum(c.float().square()) for c in planar.reshape(-1).split(_CHUNK))


def to_numpy_complex(planar: torch.Tensor) -> np.ndarray:
    """Host-side complex copy of a planar state (complex64 for bf16)."""
    host = planar.detach().to(compute_dtype(planar.dtype)).cpu().numpy()
    return host[0] + 1j * host[1]
