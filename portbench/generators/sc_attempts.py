"""Closed loop of whole semiclassical attempts on one base: each attempt is
one call of the program's ``algorithms/semiclassical.find_period_semiclassical``
with L fresh float32 draws from the seed.  Every attempt runs the same L
steps (the same multipliers, so the same structured plans and gather
steps); only the measured branch differs."""

from portbench import core, semiclassical_runner

E2E = {"sc_step_ms": lambda attempts, t0, cell: core.window_ms(attempts, t0, per=int(cell["config"]["L"]))}


def setup(cell: dict, seed: int):
    return semiclassical_runner.SemiclassicalRunner(cell, seed)
