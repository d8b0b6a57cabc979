"""The runner of the full-register cells: one attempt is one call of the
program's ``algorithms/shor.find_period(engine, C, a, r)`` on a
``StateVectorEngine`` built once in set-up; the generator chooses each
attempt's base.  The draws r come from the benchmark's seed, one an attempt.

The comparison, once the window has closed:

* ``index_gap``: for every attempt, how far its draw lies outside the
  reference's CDF interval of the index the program measured (planner,
  kernels, oracle and measurement together);
* ``driver_mismatches``: attempts whose omega or period differs from the
  reference's bit-reversed readout and continued fractions of the same
  index (exact);
* ``state_gap``: || psi - psi_ref ||_2 of the state of one more attempt
  through the same call on the same engine after the window (the window's
  states die inside ``run_and_measure_index``; keeping one alive would add
  a state to the window's peak).
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from portbench import core, reference


class FullRegisterRunner:
    def __init__(self, cell: dict, seed: int, base_of: Callable[[int], int], warm_bases: List[int]):
        from quantumcomputer_tpu_torch.algorithms import shor
        from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

        cfg, p = cell["config"], cell["params"]
        self.C, self.L, self.M = int(cfg["C"]), int(cfg["L"]), int(cfg["M"])
        self.find_period = shor.find_period
        # On a host without a card (the CPU tests) "auto" takes the plain path.
        backend = "cuda" if cell["device"] == "cuda" else "auto"
        self.engine = StateVectorEngine(
            Register(self.L, self.M), dtype=_dtype(cfg["precision"]), backend=backend,
            layout=p.get("layout", "standard"), oracle=p.get("oracle", "gather"),
        )
        self.base_of = base_of
        self.warm_bases = warm_bases
        seq = np.random.SeedSequence(int(seed))
        self._draw_rng, self._warm_rng = (np.random.default_rng(s) for s in seq.spawn(2))
        self._draws: List[float] = []
        self.spans = core.NoSpans()
        # The engine's own instance methods report to whichever spans are current.
        for attr, name in (("run_and_measure_index", "engine"), ("run", "run")):
            fn = getattr(self.engine, attr)
            setattr(self.engine, attr, self._spanned(fn, name))
        self._keep = None

    def _spanned(self, fn, name: str):
        def call(*args, **kwargs):
            with self.spans.span(name):
                out = fn(*args, **kwargs)
            if name == "run" and self._keep is not None:
                self._keep.append(out)
            return out

        return call

    def draw(self, i: int) -> float:
        while len(self._draws) <= i:
            self._draws.append(float(self._draw_rng.random()))
        return self._draws[i]

    def warm(self) -> None:
        for a in self.warm_bases:
            self.find_period(self.engine, self.C, a, float(self._warm_rng.random()))

    def instrument(self, spans) -> None:
        self.spans = spans

    def attempt(self, i: int) -> dict:
        a, r = self.base_of(i), self.draw(i)
        rec = self.find_period(self.engine, self.C, a, r)
        return {"a": a, "r": r, "index": rec.measured_index, "omega": rec.omega, "period": rec.period}

    def invalid(self, out: dict):
        if not 0 <= out["index"] < (1 << (self.L + self.M)):
            return f"index {out['index']} out of range"
        return None

    def counters(self) -> dict:
        from quantumcomputer_tpu_torch.ops import fused, measure

        return {
            "fused": fused.LAUNCHES, "permute": fused.PERMUTE_LAUNCHES,
            "camodc": fused.CAMODC_LAUNCHES, "block_sums": measure.LAUNCHES,
        }

    def check(self, attempts, seed: int) -> dict:
        dists = {}

        def dist(a):
            if a not in dists:
                dists[a] = reference.ShorDistribution(self.C, a, self.L, self.M)
            return dists[a]

        gap, mismatches = 0.0, 0
        for at in attempts:
            o = at.out
            gap = max(gap, dist(o["a"]).index_gap(o["index"], o["r"]))
            omega = reference.read_omega(o["index"], self.L, self.M)
            if omega != o["omega"] or reference.period_from_omega(omega, o["a"], self.C) != o["period"]:
                mismatches += 1
        # One more attempt through the same call, its state kept for the comparison.
        i = attempts[-1].i + 1 if attempts else 0
        self._keep = []
        out = self.attempt(i)
        state = self._keep[-1]
        self._keep = None
        gap = max(gap, dist(out["a"]).index_gap(out["index"], out["r"]))
        state_gap = dist(out["a"]).state_gap(state)
        del state
        return {"state_gap": state_gap, "index_gap": gap, "driver_mismatches": float(mismatches)}


def _dtype(precision: str):
    return {"complex64": torch.complex64, "complex128": torch.complex128, "complex32": "complex32"}[precision]
