"""Carry states and circuits across from the JAX package.

The JAX package is the reference this package is tested against.  Its
states are (2, 2^n) planar arrays and its circuits tuples of ``Gate``
records; both cross here as plain numpy arrays and Python values, so this
package never imports jax and a test can run one input through both.
"""

from __future__ import annotations

import numpy as np
import torch

from quantumcomputer_tpu_torch.models.circuit import Circuit, Gate


def state_from_numpy(planar: np.ndarray, device="cpu") -> torch.Tensor:
    """A (2, 2^n) float32/float64 planar array (plane 0 = Re, plane 1 = Im)
    as this package's state tensor on `device` (a copy)."""
    a = np.asarray(planar)
    if a.ndim != 2 or a.shape[0] != 2:
        raise ValueError(f"planar state must have shape (2, 2^n), got {a.shape}")
    if a.dtype not in (np.float32, np.float64):
        raise TypeError(f"planar state must be float32 or float64, got {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def state_to_numpy(planar: torch.Tensor) -> np.ndarray:
    """A state tensor as a host (2, 2^n) numpy array of its own dtype."""
    return planar.detach().cpu().numpy()


def circuit_from_reference(circuit) -> Circuit:
    """Rebuild this package's Gates from any objects with
    ``.name/.qubits/.params/.meta/.matrix`` (e.g. the JAX package's)."""
    out = []
    for g in circuit:
        matrix = None
        if g.matrix is not None:
            matrix = tuple(tuple(complex(v) for v in row) for row in g.matrix)
        out.append(
            Gate(
                str(g.name),
                tuple(int(q) for q in g.qubits),
                tuple(float(p) for p in g.params),
                tuple(int(m) for m in g.meta),
                matrix,
            )
        )
    return tuple(out)
