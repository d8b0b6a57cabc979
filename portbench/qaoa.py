"""The QAOA cells' side of the benchmark: the runner, and the bytes the
step's cost and gradient passes need.

One attempt is one step of the program's Adam over QAOA MaxCut
(``variational.QAOAOptimizer.step``: ``qaoa_step``'s expected cut and
adjoint gradient at the current angles, then the Adam update) on one
trajectory from the angles ``qaoa_initial_parameters(p, seed)`` draws.
Every step of the run is recorded, the warm-up's included: the angles it
started from, its expected cut and its gradient.

The comparison, once the window has closed (``reference_qaoa.Qaoa64``,
complex128, after the program's states are freed):

* ``cut_gap``: |E - E_ref| / |E_ref| at the angles of the first, the
  middle and the last step of the window, the largest;
* ``grad_gap``: at the same steps, the largest error of a gradient
  component over the reference's largest component;
* ``param_gap``: the largest distance of a recorded angle from an Adam
  replay in float64 of the program's own gradients (lr and betas of the
  mix), over every step.

Bytes (each input read once, each output written once, S the planar
state's bytes, T the uint8 cost table's, 2^n): a step's cost passes are
p phase passes (read S and T, write S) and the expectation (read S and T,
write lambda, S); its gradient passes are p cost-gradient passes (read psi,
lambda and T, write both, 4S + T; the last layer's writes are skipped,
2S + T) and p mixer reductions (read psi and lambda once, 2S: the least
whatever tiles cut them into).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference_qaoa
from portbench.layers import ITEMSIZE


def state_bytes(n: int, precision: str) -> int:
    return 2 * (1 << n) * ITEMSIZE[precision]


def cost_bytes(n: int, p: int, precision: str) -> int:
    """Bytes of a step's cost passes: p phase passes and the expectation."""
    s, t = state_bytes(n, precision), 1 << n
    return (p + 1) * (2 * s + t)


def grad_bytes(n: int, p: int, precision: str) -> int:
    """Bytes of a step's gradient passes: p cost-gradient passes (the last
    read-only) and p mixer reductions."""
    s, t = state_bytes(n, precision), 1 << n
    return (p - 1) * (4 * s + t) + (2 * s + t) + p * 2 * s


def _dtype(precision: str):
    return {"complex64": torch.complex64, "complex128": torch.complex128, "complex32": "complex32"}[precision]


class QAOARunner:
    def __init__(self, cell: dict, seed: int):
        from quantumcomputer_tpu_torch.algorithms import variational
        from quantumcomputer_tpu_torch.ops import qaoa as qops

        cfg, prm = cell["config"], cell["params"]
        self.n, self.p = int(cfg["n"]), int(cfg["p"])
        self.edges = [tuple(int(x) for x in e) for e in cfg["edges"]]
        self.device = "cuda" if cell["device"] == "cuda" else "cpu"
        self.lr = float(prm.get("learning_rate", 0.05))
        self.warm_steps = int(prm.get("warm_steps", 2))
        self.qops = qops
        self.engine = variational.qaoa_engine(self.n, dtype=_dtype(cfg["precision"]), device=self.device)
        self.table = qops.CostTable(self.n, self.edges, self.device)
        self.params0 = variational.qaoa_initial_parameters(self.p, seed).numpy().astype(np.float64)
        self.opt = variational.QAOAOptimizer(self.engine, self.table, self.params0, self.lr)
        self.history = []  # (angles before the step, expected cut, gradient) of every step

    def _step(self) -> dict:
        before = self.opt.params.detach().numpy().astype(np.float64)
        energy, grad = self.opt.step()
        self.history.append((before, energy, np.asarray(grad, dtype=np.float64)))
        return {"params": before, "cut": energy, "grad": np.asarray(grad, dtype=np.float64)}

    def warm(self) -> None:
        for _ in range(self.warm_steps):
            self._step()

    def instrument(self, spans) -> None:
        pass

    def attempt(self, i: int) -> dict:
        return self._step()

    def invalid(self, out: dict):
        total = sum(int(e[2]) if len(e) > 2 else 1 for e in self.edges)
        if not np.isfinite(out["cut"]) or not -1e-6 <= out["cut"] <= total + 1e-6:
            return f"expected cut {out['cut']} outside [0, {total}]"
        if not np.all(np.isfinite(out["grad"])):
            return "a gradient component is not finite"
        return None

    def counters(self) -> dict:
        from quantumcomputer_tpu_torch.ops import fused

        out = {f"qaoa_{k}": v for k, v in self.qops.LAUNCHES.items()}
        out.update(fused=fused.LAUNCHES, permute=fused.PERMUTE_LAUNCHES)
        return out

    def check(self, attempts, seed: int) -> dict:
        if self.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        ref = reference_qaoa.Qaoa64(self.n, self.edges, self.device)
        picks = sorted({0, len(attempts) // 2, len(attempts) - 1}) if attempts else []
        cut_gap = grad_gap = 0.0
        for k in picks:
            o = attempts[k].out
            e_ref, g_ref = ref.cut_and_gradient(o["params"])
            cut_gap = max(cut_gap, abs(o["cut"] - e_ref) / abs(e_ref))
            grad_gap = max(grad_gap, float(np.abs(o["grad"] - g_ref).max() / np.abs(g_ref).max()))
        del ref
        replay = reference_qaoa.adam_replay(self.params0, [h[2] for h in self.history], self.lr)
        param_gap = max((float(np.abs(h[0] - r).max()) for h, r in zip(self.history, replay)), default=0.0)
        if not attempts:
            cut_gap = grad_gap = float("inf")
        return {"cut_gap": cut_gap, "grad_gap": grad_gap, "param_gap": param_gap}
