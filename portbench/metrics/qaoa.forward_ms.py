"""qaoa.forward_ms: device time of a QAOA step's forward evolution, in ms:
the program's qaoa.forward spans (|+>^n, then p layers of the cost-phase
pass and the mixer's fused segments, ops/qaoa.apply_mixer), timed by CUDA
events at their start and end, summed over the traced slice over its
steps (the qaoa.step root spans, one a step).
Layer: variational.  Source: the program's spans.  Moves: attempt_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "attempt_ms"


def read(obs):
    if MOVES not in obs.reports:
        return None
    return program_spans.per_attempt(obs, "qaoa.step", ("qaoa.forward",), "device_ms")
