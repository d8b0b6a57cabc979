"""measure.ms.mhigh: device time of the measurement an attempt in an m_high
cell, in ms: the program's measure.sample spans (block sums, the scans in
physical order, the index read back; past 2^31 amplitudes the float64
scans), timed by CUDA events at their start and end, summed over the
traced slice over its attempts.
Layer: measurement.  Source: the program's spans.  Moves: attempt_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "attempt_ms"


def read(obs):
    if MOVES not in obs.reports or obs.cell["params"].get("layout") != "m_high":
        return None
    return program_spans.per_attempt(obs, "driver.attempt", ("measure.sample",), "device_ms")
