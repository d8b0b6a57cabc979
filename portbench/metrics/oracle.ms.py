"""oracle.ms: device time of the oracle gates an attempt, in ms: the
program's oracle.gate spans (a gather gate with its table, a Beneš
permutation segment, a strip run, a ladder or an m_high walk), timed by
CUDA events at their start and end, summed over the traced slice over its
attempts.
Layer: oracle.  Source: the program's spans.  Moves: attempt_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "attempt_ms"


def value(obs):
    return program_spans.per_attempt(obs, "driver.attempt", ("oracle.gate",), "device_ms")


def read(obs):
    return value(obs) if MOVES in obs.reports else None
