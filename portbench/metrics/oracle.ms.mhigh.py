"""oracle.ms.mhigh: device time of the m_high oracle an attempt, in ms: the
program's oracle.gate spans in an m_high cell (each ladder, cycle walk,
in-place pair or strip run), timed by CUDA events at their start and end,
summed over the traced slice over its attempts.
Layer: oracle.  Source: the program's spans.  Moves: attempt_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "attempt_ms"


def read(obs):
    if MOVES not in obs.reports or obs.cell["params"].get("layout") != "m_high":
        return None
    return program_spans.per_attempt(obs, "driver.attempt", ("oracle.gate",), "device_ms")
