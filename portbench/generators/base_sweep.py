"""Closed loop of full-register attempts over consecutive bases, as the
CLI's loop without ``-a`` tries them (``qc_shor.c``'s trial loop): attempt
i takes the i-th base coprime to C from a = 2 on; the draws come from the
seed.  Every attempt is a new circuit, so the engine plans it and builds
its oracle tables inside the attempt.  Every seed runs the same bases: a
base's oracle multipliers set how local the gathers are (those of small
bases are), so a base sequence drawn from the seed would change the work
from run to run.  The warm-up takes the bases just below C - 1, which the
window never reaches (it would need all C - 3 bases first)."""

import itertools
import math

from portbench import core, full_register

#: The sweep's attempt time has a metric of its own: its planning on the
#: host makes it spread more than the fixed-base cells, and its tail too
#: much to bound (PERF.md).
E2E = {"sweep_attempt_ms": lambda attempts, t0, cell: core.window_ms(attempts, t0)}
FIRST = 2


def walk(C: int, a: int, step: int):
    """Bases coprime to C from `a` on, by `step`, wrapping within [2, C - 2]."""
    while True:
        if math.gcd(a, C) == 1:
            yield a
        a = 2 + (a - 2 + step) % (C - 3)


def setup(cell: dict, seed: int):
    C = int(cell["config"]["C"])
    warm = list(itertools.islice(walk(C, C - 2, -1), int(cell["params"].get("warm_attempts", 2))))
    seq, forward = [], walk(C, FIRST, 1)

    def base_of(i: int) -> int:
        while len(seq) <= i:
            seq.append(next(forward))
        return seq[i]

    return full_register.FullRegisterRunner(cell, seed, base_of, warm)
