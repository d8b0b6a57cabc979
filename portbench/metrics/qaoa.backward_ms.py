"""qaoa.backward_ms: device time of a QAOA step's adjoint backward, in ms:
the program's qaoa.backward spans (for each layer from the last: the
mixer's reduction passes, the mixer undone on psi and on lambda through
its fused segments, the cost-gradient pass that undoes the cost layer), timed by
CUDA events, summed over the traced slice over its steps (the qaoa.step
root spans).
Layer: variational.  Source: the program's spans.  Moves: attempt_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "attempt_ms"


def read(obs):
    if MOVES not in obs.reports:
        return None
    return program_spans.per_attempt(obs, "qaoa.step", ("qaoa.backward",), "device_ms")
