"""The plain reference of the gradient cell: the gradient of
L = sum_x w_x |psi_x|^2 with respect to the Shor circuit's input state,
independent of the program.

Plain PyTorch only; nothing here imports ``jax``, the JAX package or the
PyTorch port.  psi = U |0..01> with U the Shor circuit of
``reference.plain_state`` (H on the counting qubits, the controlled
multiplies by a^(2^j) mod C on control M + j, the reference loop's inverse
QFT).  For the planes of the input z, dL/dz = U^dagger (2 w psi) (U is
unitary, so the transpose of its real-linear map on the planes is its
adjoint).  ``gradient`` builds 2 w psi from the closed form
(``reference.ShorDistribution.amplitudes``) in complex128 on the device
and runs U^dagger on it gate by gate, in place:

* the inverse QFT's stages undone from l = M up: the phases
  exp(-i pi x_[M, l) / 2^(l - M)) where bit l is 1, then H(l);
* the multiplies undone from j = L - 1 down: where bit M + j is 1, the
  work register f -> A^-1 f, i.e. new[f] = old[A f mod C] for f < C;
* H on every counting qubit.

A state of 2^28 complex128 amplitudes is 4 GiB; each gate works on slabs of
at most SLAB amplitudes of each half.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from portbench.reference import ShorDistribution

SLAB = 1 << 24


def _halves(v: torch.Tensor, q: int):
    """(a, b) slab pairs of v's halves with bit q 0 and 1."""
    t = v.view(-1, 2, 1 << q)
    rows, cols = t.shape[0], t.shape[2]
    if cols >= SLAB:
        for c in range(0, cols, SLAB):
            yield t[:, 0, c : c + SLAB], t[:, 1, c : c + SLAB]
    else:
        step = max(1, SLAB // cols)
        for r in range(0, rows, step):
            yield t[r : r + step, 0], t[r : r + step, 1]


def hadamard_(v: torch.Tensor, q: int) -> None:
    s = 1.0 / math.sqrt(2.0)
    for a, b in _halves(v, q):
        t = a.clone()
        a.add_(b).mul_(s)
        b.neg_().add_(t).mul_(s)


def dagger_(v: torch.Tensor, C: int, a: int, L: int, M: int) -> torch.Tensor:
    """v <- U^dagger v for the Shor circuit (C, a, L, M), in place."""
    n = L + M
    for l in range(M, M + L):
        if l > M:
            ph = torch.exp(-1j * math.pi * torch.arange(1 << (l - M), dtype=torch.float64, device=v.device) / (1 << (l - M)))
            hi = v.view(-1, 2, 1 << (l - M), 1 << M)
            for r in range(0, hi.shape[0], max(1, SLAB >> l)):
                hi[r : r + max(1, SLAB >> l), 1] *= ph[:, None]
        hadamard_(v, l)
    f = torch.arange(1 << M, device=v.device)
    for j in reversed(range(L)):
        A = pow(a, 1 << j, C)
        perm = f.clone()
        perm[:C] = (A * f[:C]) % C
        view = v.view(-1, 2, 1 << j, 1 << M)  # [:, 1]: bit M + j is 1
        for r in range(0, view.shape[0], max(1, SLAB >> (M + j))):
            blk = view[r : r + max(1, SLAB >> (M + j)), 1]
            blk.copy_(blk.index_select(-1, perm))
    for q in range(M, n):
        hadamard_(v, q)
    return v


def gradient(dist: ShorDistribution, w: torch.Tensor, rows_per_block: int = 1 << 10) -> Tuple[torch.Tensor, float]:
    """(dL/dz as a complex128 vector on w's device, L) for the weights w
    (2^n, any real dtype) and the closed-form state of `dist`."""
    N, W = 1 << dist.L, 1 << dist.M
    v = torch.empty(N * W, dtype=torch.complex128, device=w.device)
    vv, ww = v.view(N, W), w.view(N, W)
    loss = 0.0
    for lo in range(0, N, rows_per_block):
        hi = min(N, lo + rows_per_block)
        re, im = dist.amplitudes(lo, hi, w.device)
        wb = ww[lo:hi].to(torch.float64)
        loss += float((wb * (re * re + im * im)).sum())
        vv[lo:hi] = torch.complex(2 * wb * re, 2 * wb * im)
        del re, im, wb
    return dagger_(v, dist.C, dist.a, dist.L, dist.M), loss
