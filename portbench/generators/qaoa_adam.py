"""Closed loop of QAOA MaxCut Adam steps on one trajectory: each attempt is
one step of the program's ``variational.QAOAOptimizer`` (the expected cut,
its adjoint gradient, the Adam update), from initial angles drawn from the
seed; the runner and the comparison are ``portbench/qaoa.py``."""

from portbench import core, qaoa

#: End-to-end metrics besides setup_s and peak_gib: name -> f(attempts, window start, cell).
E2E = {
    "attempt_ms": lambda attempts, t0, cell: core.window_ms(attempts, t0),
    "attempt_p95_ms": lambda attempts, t0, cell: core.p95_ms(attempts),
}


def setup(cell: dict, seed: int):
    return qaoa.QAOARunner(cell, seed)
