"""fused.ms: device time of the fused segments an attempt, in ms: the
program's fused.segment spans (each plan entry that apply_circuit_fused_
runs as a fused segment, other than a segment of oracle ops alone), timed
by CUDA events at their start and end, summed over the traced slice over
its attempts.
Layer: fused segments.  Source: the program's spans.  Moves: attempt_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "attempt_ms"


def read(obs):
    if MOVES not in obs.reports:
        return None
    return program_spans.per_attempt(obs, "driver.attempt", ("fused.segment",), "device_ms")
