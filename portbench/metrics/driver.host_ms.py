"""driver.host_ms: host time an attempt spends outside the engine call, in
ms: the mean attempt span less the mean span of the engine instance's
run_and_measure_index (reset, circuit, measurement), over the traced run's
window.  What is left is algorithms/shor.py and algorithms/number_theory.py:
circuit build, readout, continued fractions, the period test.
Layer: driver.  Source: the benchmark's spans.  Moves: attempt_ms."""

from portbench.layers import mean

UNIT = "ms"
MOVES = "attempt_ms"


def value(obs):
    a, e = mean(obs.spans.get("attempt", [])), mean(obs.spans.get("engine", []))
    if a is None or e is None:
        return None
    return 1e3 * (a - e)


def read(obs):
    return value(obs) if MOVES in obs.reports else None
