"""Carry states and circuits across from the JAX package.

The JAX package is the reference this package is tested against.  Its
states are (2, 2^n) planar arrays and its circuits tuples of ``Gate``
records, its stride-permutation plans frozen dataclasses; all of them
cross here as plain numpy arrays and Python values, so this
package never imports jax and a test can run one input through both.

bfloat16 ("complex32") planes cross as their raw 16-bit patterns: numpy has
no bf16, so a JAX bf16 array (an ``ml_dtypes.bfloat16`` numpy array, which
this package never imports) crosses as ``np.uint16`` bits, and the round
trip is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from quantumcomputer_tpu_torch.models.circuit import Circuit, Gate


def state_from_numpy(planar: np.ndarray, device="cpu") -> torch.Tensor:
    """A (2, 2^n) planar array (plane 0 = Re, plane 1 = Im) as this
    package's state tensor on `device` (a copy): float32 or float64, or
    bf16 as uint16 bit patterns (or a numpy array of a dtype named
    "bfloat16", viewed as them), which become a bfloat16 tensor."""
    a = np.asarray(planar)
    if a.ndim != 2 or a.shape[0] != 2:
        raise ValueError(f"planar state must have shape (2, 2^n), got {a.shape}")
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    if a.dtype not in (np.float32, np.float64):
        raise TypeError(f"planar state must be float32, float64 or bf16 bits, got {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def state_to_numpy(planar: torch.Tensor) -> np.ndarray:
    """A state tensor as a host (2, 2^n) numpy array of its own dtype; a
    bfloat16 state as its uint16 bit patterns."""
    host = planar.detach().cpu()
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


def plan_from_reference(plan):
    """This package's ``StridePlan`` with the fields of any object that has
    ``.C/.M/.eps/.u/.v/.vinv/.W`` (e.g. the JAX package's), so a leg can run
    under the reference's exact plan."""
    from quantumcomputer_tpu_torch.ops.modperm import StridePlan

    return StridePlan(**{f: int(getattr(plan, f)) for f in ("C", "M", "eps", "u", "v", "vinv", "W")})


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
