"""grad.backward_ms: device time of the engine's adjoint backward, in ms:
the program's engine.adjoint spans (_AdjointRun.backward: the dagger
circuit on the cotangent through the engine's plan and kernels), timed by
CUDA events at their start and end, over the traced slice over its
attempts; nothing unless there is one such root span an attempt.
Layer: engine gradient.  Source: the program's spans.  Moves: attempt_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "attempt_ms"


def read(obs):
    if MOVES not in obs.reports:
        return None
    found = program_spans.roots(obs, "engine.adjoint")
    if found is None:
        return None
    t = program_spans.total_ms(found, ("engine.adjoint",), "device_ms")
    return None if t is None else t / len(found)
