"""The runner of the gradient cells: one attempt is the program's
``engine.run(shor_circuit, planes)`` on |0..01> reset planes that require
grad, the loss L = sum_x w_x |psi_x|^2 and ``L.backward()`` (the engine's
adjoint: the dagger circuit on the cotangent through the same plan and
kernels), then the host waits for the card.  The weights w are uniform
[0, 1) float32, drawn once from the seed on the engine's device, so the
cotangent 2 w psi is not proportional to the output.

The comparison, once the window has closed (``reference_grad``):

* ``loss_gap``: every attempt's L against the closed form's, relative;
* ``state_gap``: || psi - psi_ref ||_2 of one more attempt's output
  (``reference.ShorDistribution``, the full-register cells' number);
* ``grad_gap``: || grad - grad_ref ||_2 / || grad_ref ||_2 of that
  attempt's input gradient, grad_ref = U^dagger (2 w psi_ref) run gate by
  gate in complex128.
"""

from __future__ import annotations

import math

import torch

from portbench import reference, reference_grad
from portbench.full_register import _dtype


class GradientRunner:
    def __init__(self, cell: dict, seed: int, a: int):
        from quantumcomputer_tpu_torch.models.shor_circuit import shor_circuit
        from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

        cfg, p = cell["config"], cell["params"]
        self.C, self.a, self.L, self.M = int(cfg["C"]), int(a), int(cfg["L"]), int(cfg["M"])
        backend = "cuda" if cell["device"] == "cuda" else "auto"
        self.engine = StateVectorEngine(
            Register(self.L, self.M), dtype=_dtype(cfg["precision"]), backend=backend,
            layout=p.get("layout", "standard"), oracle=p.get("oracle", "gather"),
        )
        self.device = self.engine.device
        self.circuit = shor_circuit(self.C, self.a, self.L, self.M)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.w = torch.rand(1 << (self.L + self.M), generator=gen, dtype=torch.float32, device=self.device)
        self.warm_attempts = int(p.get("warm_attempts", 2))
        self._dist = None

    def _run(self):
        planes = self.engine.initial_state().requires_grad_()
        out = self.engine.run(self.circuit, planes)
        loss = (out.square() * self.w).sum()
        loss.backward()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return planes, out, float(loss.detach())

    def warm(self) -> None:
        for _ in range(self.warm_attempts):
            self._run()

    def instrument(self, spans) -> None:
        pass

    def attempt(self, i: int) -> dict:
        return {"loss": self._run()[2]}

    def invalid(self, out: dict):
        return None if math.isfinite(out["loss"]) and out["loss"] >= 0 else f"loss {out['loss']}"

    def counters(self) -> dict:
        from quantumcomputer_tpu_torch.ops import fused

        return {"fused": fused.LAUNCHES, "permute": fused.PERMUTE_LAUNCHES, "camodc": fused.CAMODC_LAUNCHES}

    def check(self, attempts, seed: int) -> dict:
        dist = reference.ShorDistribution(self.C, self.a, self.L, self.M)
        planes, out, loss = self._run()
        state_gap = dist.state_gap(out.detach())
        grad = planes.grad.detach()
        del planes, out
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref, loss_ref = reference_grad.gradient(dist, self.w)
        num = den = 0.0
        for lo in range(0, ref.numel(), reference_grad.SLAB):
            r = ref[lo : lo + reference_grad.SLAB]
            g = grad[:, lo : lo + reference_grad.SLAB].to(torch.float64)
            num += float(((g[0] - r.real) ** 2 + (g[1] - r.imag) ** 2).sum())
            den += float((r.real ** 2 + r.imag ** 2).sum())
        del ref, grad
        losses = [at.out["loss"] for at in attempts] + [loss]
        loss_gap = max(abs(x - loss_ref) / loss_ref for x in losses)
        return {"state_gap": state_gap, "grad_gap": math.sqrt(num / den), "loss_gap": loss_gap}
