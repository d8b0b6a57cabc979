"""measure.ms: device time of the measurement an attempt, in ms: the
program's measure.sample spans (StateVectorEngine._sample: the block sums,
the two scans and the read back of the index), timed by CUDA events at
their start and end, summed over the traced slice over its attempts.
Layer: measurement.  Source: the program's spans.  Moves: attempt_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "attempt_ms"


def read(obs):
    if MOVES not in obs.reports:
        return None
    return program_spans.per_attempt(obs, "driver.attempt", ("measure.sample",), "device_ms")
