"""QAOA for MaxCut in plain torch: the tape-autograd evolution.

The CPU route of ``variational.qaoa_maxcut`` and the plain version its card
route (``variational.qaoa_step``: the engine, the cost-table kernels and the
adjoint gradient) is held to.  It uses no kernel of the port: the state is
one flat complex tensor, the separator exp(-i gamma c) one elementwise
multiply by the cost vector, each RX(2 beta) a new state from a view with
the qubit as its middle axis, and autograd keeps every intermediate state
for the backward pass.  That is exact and simple, and its memory grows as
(n p + p) states, so it serves small registers (about n = 25 at p = 4 on an
80 GB card).

A float32 cost vector evolves a complex64 state (the JAX package's QAOA),
a float64 one a complex128 state.
"""

from __future__ import annotations

import numpy as np
import torch

from quantumcomputer_tpu_torch.algorithms.variational import _rot_x


def evolve(cost: torch.Tensor, n: int, params: torch.Tensor) -> torch.Tensor:
    """|psi(gamma, beta)> from |+>^n: p layers of exp(-i gamma_k c) then n
    RX(2 beta_k); `cost` the real cost vector (its dtype sets the state's),
    `params` (2, p).  Differentiable in `params`."""
    cdtype = torch.complex128 if cost.dtype == torch.float64 else torch.complex64
    dim = 1 << n
    phase_cost = cost.to(cdtype)
    z = torch.full((dim,), 1.0 / np.sqrt(dim), dtype=cdtype, device=cost.device)
    gammas, betas = params[0], params[1]
    for k in range(params.shape[1]):
        z = z * torch.exp(-1j * gammas[k].to(cost.dtype) * phase_cost)
        for q in range(n):
            z = _rot_x(z, q, n, 2.0 * betas[k].to(cost.dtype))
    return z


def expected_cut(cost: torch.Tensor, n: int, params: torch.Tensor):
    """(sum |psi|^2 c, |psi|^2) for the evolution's state."""
    z = evolve(cost, n, params)
    probs = z.real ** 2 + z.imag ** 2
    return torch.sum(probs * cost), probs


def cut_and_gradient(cost: torch.Tensor, n: int, params) -> tuple:
    """The expected cut and its (2, p) gradient at `params`, by one backward
    pass through the tape, in the cost vector's precision (host numbers)."""
    prm = torch.as_tensor(np.asarray(params, dtype=np.float64), dtype=cost.dtype, device=cost.device)
    prm.requires_grad_()
    e, _ = expected_cut(cost, n, prm)
    e.backward()
    return float(e.detach()), prm.grad.detach().cpu().numpy().astype(np.float64)


def optimize(cost: torch.Tensor, n: int, params0: torch.Tensor, steps: int, learning_rate: float):
    """Adam-maximize the expected cut from float32 `params0` (2, p) on the
    cost vector's device: torch.optim.Adam, betas (0.9, 0.999), eps 1e-8,
    maximize=True (optax.adam on the negated gradient).  Returns (the final
    float32 parameters, the per-step expected cuts)."""
    params = params0.to(cost.device).requires_grad_()
    opt = torch.optim.Adam([params], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, maximize=True)
    trace = np.zeros(steps, dtype=np.float64)
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        e, _ = expected_cut(cost, n, params)
        e.backward()
        opt.step()
        trace[i] = float(e.detach())
    return params.detach(), trace
