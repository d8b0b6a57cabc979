"""Debug helpers: the testing_and_debug.c equivalents.

The counterpart of the JAX package's ``utils/debug.py``, with the same
output text.  display_state (testing_and_debug.c:7-26) prints every
nonzero-amplitude basis state as a ket string; check_normalisation
(testing_and_debug.c:28-37) prints the total probability to 16 decimal
places.  Both take a complex vector or (2, 2^n) planes, as numpy arrays or
torch tensors on any device, work on host copies, and are meant for
interactive use on small registers.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(state) -> np.ndarray:
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    return np.asarray(state)


def state_to_kets(state, atol: float = 0.0) -> list[tuple[str, complex]]:
    """Nonzero support of the wavefunction as (ket-string, amplitude) pairs,
    most-significant qubit first (matching the reference's print order).

    Accepts a complex vector OR planar (2, 2^n) state (re/im rows combine
    here); the length must be a power of two."""
    psi = _host(state)
    shape = psi.shape
    if psi.ndim == 2 and psi.shape[0] == 2:
        psi = psi[0].astype(np.float64) + 1j * psi[1].astype(np.float64)
    if psi.ndim != 1 or psi.shape[0] & (psi.shape[0] - 1):
        raise ValueError(f"expected a (2^n,) state or (2, 2^n) planes, got shape {shape}")
    n = int(psi.shape[0]).bit_length() - 1
    out = []
    for idx in np.nonzero(np.abs(psi) > atol)[0]:
        ket = format(int(idx), f"0{n}b")
        out.append((f"|{ket}>", complex(psi[idx])))
    return out


def display_state(state, atol: float = 1e-12) -> str:
    """Human-readable nonzero support with |amplitude| like display_state."""
    lines = [
        f"{ket}  amp={amp.real:+.6f}{amp.imag:+.6f}j  |amp|={abs(amp):.6f}"
        for ket, amp in state_to_kets(state, atol)
    ]
    text = "\n".join(lines)
    print(text)
    return text


def check_normalisation(state) -> float:
    """Total probability, printed to 16 d.p. (testing_and_debug.c:28-37)."""
    total = float(np.sum(np.abs(_host(state)) ** 2))
    print(f"Total probability: {total:.16f}")
    return total
