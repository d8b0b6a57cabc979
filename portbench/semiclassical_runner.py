"""The runner of the semiclassical cells: one attempt is one call of the
program's ``algorithms/semiclassical.find_period_semiclassical(C, a, L, M,
rs)`` with L draws from the benchmark's seed.

The comparison, once the window has closed, for every attempt:

* ``sc_gap``: over the L steps, the widest gap between the program's
  conditional probability of its measured bit and the exact one of the
  eigenphase posterior that follows the program's bits (the step glue,
  the structured permutation and the gather steps together), and how far a
  draw lies on the wrong side of the exact p0 where the bit disagrees;
* ``driver_mismatches``: attempts whose x~, omega or period differs from
  the reference's readout and continued fractions of the same bits (exact).

The warm-up runs the attempt's last ``warm_steps`` steps alone (a call
with L = warm_steps has exactly their multipliers), which reaches both
step paths, the structured permutation and the gather, in a fraction of an
attempt.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import core, reference
from portbench.full_register import _dtype


class SemiclassicalRunner:
    def __init__(self, cell: dict, seed: int):
        from quantumcomputer_tpu_torch.algorithms import semiclassical

        cfg, p = cell["config"], cell["params"]
        self.C, self.a, self.L, self.M = int(cfg["C"]), int(cfg["a"]), int(cfg["L"]), int(cfg["M"])
        self.dtype = _dtype(cfg["precision"])
        self.device = "cuda" if cell["device"] == "cuda" else "cpu"
        self.warm_steps = int(p.get("warm_steps", 4))
        self.find = semiclassical.find_period_semiclassical
        seq = np.random.SeedSequence(int(seed))
        self._draw_rng, self._warm_rng = (np.random.default_rng(s) for s in seq.spawn(2))
        self._draws = []
        self.spans = core.NoSpans()
        self.posterior = reference.EigenphasePosterior(self.C, self.a, self.L)

    def draws(self, i: int) -> np.ndarray:
        while len(self._draws) <= i:
            self._draws.append(self._draw_rng.random(self.L, dtype=np.float32))
        return self._draws[i]

    def warm(self) -> None:
        rs = self._warm_rng.random(self.warm_steps, dtype=np.float32)
        self.find(self.C, self.a, self.warm_steps, self.M, torch.from_numpy(rs), dtype=self.dtype, device=self.device)

    def instrument(self, spans) -> None:
        self.spans = spans

    def attempt(self, i: int) -> dict:
        rs = self.draws(i)
        period, rec = self.find(self.C, self.a, self.L, self.M, torch.from_numpy(rs), dtype=self.dtype, device=self.device)
        return {
            "rs": rs, "bits": list(rec.bits), "probs": list(rec.branch_probs), "x_tilde": rec.x_tilde,
            "omega": rec.omega, "period": period, "oracles": list(rec.oracles),
        }

    def invalid(self, out: dict):
        if len(out["bits"]) != self.L or any(b not in (0, 1) for b in out["bits"]):
            return "bits out of range"
        if any(not 0.0 <= p <= 1.0 + 1e-6 for p in out["probs"]):
            return "a branch probability outside [0, 1]"
        return None

    def counters(self) -> dict:
        from quantumcomputer_tpu_torch.ops import chunkgather, transpose

        return {"transpose": transpose.LAUNCHES, "chunk_gather": sum(chunkgather.LAUNCHES.values())}

    def check(self, attempts, seed: int) -> dict:
        gap, mismatches = 0.0, 0
        for at in attempts:
            o = at.out
            p0s = self.posterior.replay(o["bits"])
            gap = max(gap, reference.sc_gap(p0s, o["bits"], o["probs"], o["rs"]))
            x = reference.x_tilde(o["bits"])
            omega = x / float(1 << self.L)
            if x != o["x_tilde"] or omega != o["omega"] or reference.period_from_omega(omega, self.a, self.C) != o["period"]:
                mismatches += 1
        return {"sc_gap": gap, "driver_mismatches": float(mismatches)}
