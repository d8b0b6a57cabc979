"""The plain reference of the QAOA cells: QAOA MaxCut's expected cut and its
exact gradient in float64 (complex128 states), independent of the program.

Plain PyTorch only; nothing here imports ``jax``, the JAX package or the
PyTorch port.  The objective (Farhi, Goldstone and Gutmann,
arXiv:1411.4028): from |+>^n, p layers of the cost phase exp(-i gamma_k C),
C the diagonal of cut sizes c(x) = sum over edges (a, b, w) of w [x_a != x_b],
then the mixer exp(-i beta_k B), B = sum_q X_q; E = <psi|C|psi>.

Two forms:

* ``tape_cut_and_gradient``: the evolution as the program's CPU route once
  wrote it (a new state an RX gate, tape autograd through all of it), copied;
  for small registers, where it holds the other form to it.
* ``Qaoa64``: the same numbers at the cell's size within a few states.  The
  mixer is a tensor power of one 2 x 2 rotation, so it applies as k-qubit
  blocks R^(x)k (2^k x 2^k, k = BLOCK) by matrix products over the state's
  axes, a slab at a time, in place; the gradient comes by the adjoint
  method (Jones and Gacon, arXiv:2009.02823): with lambda = C psi and the
  layers walked backward, dE/dbeta_k = 2 Im <lambda|B|psi> (B a block at a
  time, sum_q X_q over the block's qubits as one 2^k x 2^k matrix) and
  dE/dgamma_k = 2 Im <lambda|C|psi>, each layer undone on both states.
  ψ, λ and a uint8 table of c(x) live on the device: 2 x 16 GiB + 1 GiB at
  n = 30.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

#: Qubits a mixer block takes; slab of the state a product handles at once.
BLOCK = 5
SLAB = 1 << 24


def cut_table(n: int, edges: Sequence, device) -> torch.Tensor:
    """c(x) for every x < 2^n as uint8 (whole weights summing under 256), 2^24 at a time."""
    out = torch.empty(1 << n, dtype=torch.uint8, device=device)
    for lo in range(0, 1 << n, SLAB):
        x = torch.arange(lo, min(lo + SLAB, 1 << n), dtype=torch.int64, device=device)
        c = torch.zeros_like(x)
        for e in edges:
            a, b = int(e[0]), int(e[1])
            w = int(e[2]) if len(e) > 2 else 1
            c += (((x >> a) ^ (x >> b)) & 1) * w
        out[lo : lo + x.numel()] = c.to(torch.uint8)
    return out


def _rx(beta: float) -> np.ndarray:
    c, s = math.cos(beta), math.sin(beta)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=np.complex128)


def _power(m: np.ndarray, k: int) -> np.ndarray:
    out = np.ones((1, 1), dtype=np.complex128)
    for _ in range(k):
        out = np.kron(out, m)
    return out


def _x_sum(k: int) -> np.ndarray:
    """sum_q X_q on k qubits, 2^k x 2^k."""
    idx = np.arange(1 << k)
    out = np.zeros((1 << k, 1 << k), dtype=np.complex128)
    for q in range(k):
        out[idx ^ (1 << q), idx] += 1.0
    return out


class Qaoa64:
    """E and dE/d(gamma, beta) of an n-qubit MaxCut QAOA in complex128 on
    `device`, in place (see the module docstring)."""

    def __init__(self, n: int, edges: Sequence, device):
        self.n, self.device = int(n), torch.device(device)
        self.c = cut_table(self.n, edges, self.device)
        self.blocks = [(s, min(BLOCK, self.n - s)) for s in range(0, self.n, BLOCK)]

    # -- passes ------------------------------------------------------------------

    def _slabs(self):
        dim = 1 << self.n
        return ((lo, min(dim, lo + SLAB)) for lo in range(0, dim, SLAB))

    def _cost(self, lo: int, hi: int) -> torch.Tensor:
        return self.c[lo:hi].to(torch.float64)

    def _phase(self, z: torch.Tensor, gamma: float) -> None:
        for lo, hi in self._slabs():
            z[lo:hi] *= torch.exp(-1j * gamma * self._cost(lo, hi))

    def _views(self, z: torch.Tensor, s: int, k: int):
        """Slabs of z as (rows, 2^k, cols) views, the block's qubits [s, s + k) in the middle."""
        v = z.view(-1, 1 << k, 1 << s)
        rows, cols = v.shape[0], v.shape[2]
        if rows * (1 << k) * cols <= SLAB or rows > 1:
            step = max(1, SLAB // ((1 << k) * cols))
            return [v[r : r + step] for r in range(0, rows, step)]
        step = max(1, SLAB >> k)
        return [v[:, :, c : c + step] for c in range(0, cols, step)]

    def _mix(self, z: torch.Tensor, beta: float) -> None:
        """z <- exp(-i beta B) z, block by block, slab by slab."""
        for s, k in self.blocks:
            u = torch.from_numpy(_power(_rx(beta), k)).to(self.device)
            for v in self._views(z, s, k):
                v.copy_(torch.matmul(u, v))

    def _x_inner(self, lam: torch.Tensor, psi: torch.Tensor) -> float:
        """Im <lam|B|psi>."""
        total = 0.0
        for s, k in self.blocks:
            g = torch.from_numpy(_x_sum(k)).to(self.device)
            for vl, vp in zip(self._views(lam, s, k), self._views(psi, s, k)):
                total += float((vl.conj() * torch.matmul(g, vp)).imag.sum())
        return total

    def _c_inner(self, lam: torch.Tensor, psi: torch.Tensor) -> float:
        """Im <lam|C|psi>."""
        return sum(float(((lam[lo:hi].conj() * psi[lo:hi]).imag * self._cost(lo, hi)).sum()) for lo, hi in self._slabs())

    def state(self, params) -> torch.Tensor:
        prm = np.asarray(params, dtype=np.float64)
        z = torch.full((1 << self.n,), 2.0 ** (-self.n / 2), dtype=torch.complex128, device=self.device)
        for g, b in zip(prm[0], prm[1]):
            self._phase(z, float(g))
            self._mix(z, float(b))
        return z

    def cut_and_gradient(self, params) -> Tuple[float, np.ndarray]:
        prm = np.asarray(params, dtype=np.float64)
        p = prm.shape[1]
        psi = self.state(prm)
        lam = torch.empty_like(psi)
        energy = 0.0
        for lo, hi in self._slabs():
            c = self._cost(lo, hi)
            energy += float((psi[lo:hi].abs() ** 2 * c).sum())
            lam[lo:hi] = psi[lo:hi] * c
        grad = np.zeros((2, p))
        for k in reversed(range(p)):
            grad[1, k] = 2.0 * self._x_inner(lam, psi)
            self._mix(psi, -float(prm[1, k]))
            self._mix(lam, -float(prm[1, k]))
            grad[0, k] = 2.0 * self._c_inner(lam, psi)
            if k:
                self._phase(psi, -float(prm[0, k]))
                self._phase(lam, -float(prm[0, k]))
        del psi, lam
        return energy, grad


def tape_cut_and_gradient(n: int, edges: Sequence, params, dtype=torch.float64) -> Tuple[float, np.ndarray]:
    """The expected cut and its gradient by tape autograd through a state a
    gate, in `dtype` (float64: complex128 states), on the CPU."""
    idx = np.arange(1 << n)
    cost_np = np.zeros(1 << n)
    for e in edges:
        a, b = int(e[0]), int(e[1])
        cost_np += (((idx >> a) ^ (idx >> b)) & 1) * (float(e[2]) if len(e) > 2 else 1.0)
    cost = torch.from_numpy(cost_np).to(dtype)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    prm = torch.tensor(np.asarray(params, dtype=np.float64), dtype=dtype, requires_grad=True)
    z = torch.full((1 << n,), 2.0 ** (-n / 2), dtype=cdtype)
    for k in range(prm.shape[1]):
        z = z * torch.exp(-1j * prm[0, k] * cost.to(cdtype))
        for q in range(n):
            t = z.reshape(-1, 2, 1 << q)
            c, s = torch.cos(prm[1, k]), torch.sin(prm[1, k])
            a, b = t[:, 0, :], t[:, 1, :]
            z = torch.stack([c * a - 1j * s * b, -1j * s * a + c * b], dim=1).reshape(-1)
    e = torch.sum((z.real ** 2 + z.imag ** 2) * cost)
    e.backward()
    return float(e.detach()), prm.grad.numpy().astype(np.float64)


def adam_replay(params0, grads: Sequence, learning_rate: float, betas=(0.9, 0.999), eps: float = 1e-8) -> list:
    """The parameters before each step of Adam ascending (maximize) with
    these gradients from params0, in float64: the trajectory the recorded
    one is held to."""
    theta = np.asarray(params0, dtype=np.float64).copy()
    m, v = np.zeros_like(theta), np.zeros_like(theta)
    out = []
    for t, g in enumerate(grads, start=1):
        out.append(theta.copy())
        d = -np.asarray(g, dtype=np.float64)
        m = betas[0] * m + (1 - betas[0]) * d
        v = betas[1] * v + (1 - betas[1]) * d * d
        step = learning_rate / (1 - betas[0] ** t)
        theta = theta - step * m / (np.sqrt(v) / math.sqrt(1 - betas[1] ** t) + eps)
    return out
