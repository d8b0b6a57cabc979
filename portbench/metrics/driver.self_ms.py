"""driver.self_ms: host time an attempt spends in the driver itself, in
ms: the program's driver.attempt span (algorithms/shor.find_period) less
its children (engine.run, measure.sample, driver.period), over the traced
slice's attempts.  What is left is the circuit build, the verbosity and
checkpoint switches and the calls between the layers.
Layer: driver.  Source: the program's spans.  Moves: attempt_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "attempt_ms"


def read(obs):
    return program_spans.self_ms(obs, "driver.attempt") if MOVES in obs.reports else None
