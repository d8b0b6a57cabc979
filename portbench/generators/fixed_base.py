"""Closed loop of full-register attempts on one base: the configuration's
``a`` every attempt, one draw an attempt from the seed.  Every attempt runs
the same circuit, so the engine's plan cache hits after the warm-up."""

from portbench import core, full_register

#: End-to-end metrics besides setup_s and peak_gib: name -> f(attempts, window start, cell).
E2E = {
    "attempt_ms": lambda attempts, t0, cell: core.window_ms(attempts, t0),
    "attempt_p95_ms": lambda attempts, t0, cell: core.p95_ms(attempts),
}


def setup(cell: dict, seed: int):
    a = int(cell["params"].get("a", cell["config"]["a"]))
    return full_register.FullRegisterRunner(cell, seed, lambda i: a, [a] * int(cell["params"].get("warm_attempts", 2)))
