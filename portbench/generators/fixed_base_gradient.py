"""Closed loop of the Shor circuit's gradient with respect to its input
state, on the configuration's base: each attempt runs ``engine.run`` on
reset planes that require grad, the loss sum w |psi|^2 with weights drawn
once from the seed, and its backward (the engine's adjoint: the dagger
circuit through the same plan and kernels); the runner and the comparison
are ``portbench/gradient.py``."""

from portbench import core, gradient

#: End-to-end metrics besides setup_s and peak_gib: name -> f(attempts, window start, cell).
E2E = {
    "attempt_ms": lambda attempts, t0, cell: core.window_ms(attempts, t0),
    "attempt_p95_ms": lambda attempts, t0, cell: core.p95_ms(attempts),
}


def setup(cell: dict, seed: int):
    a = int(cell["params"].get("a", cell["config"]["a"]))
    return gradient.GradientRunner(cell, seed, a)
