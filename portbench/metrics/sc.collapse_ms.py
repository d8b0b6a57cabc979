"""sc.collapse_ms: device time a semiclassical step spends on its
measurement and collapse, in ms: the program's sc.collapse spans
(collapse_from_a1: the bit, the conditional probability and the collapsed
state written over a1), timed by CUDA events at their start and end,
summed over the traced slice over its steps.
Layer: semiclassical step.  Source: the program's spans.  Moves: sc_step_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "sc_step_ms"


def read(obs):
    if MOVES not in obs.reports:
        return None
    return program_spans.per_attempt(obs, "sc.attempt", ("sc.collapse",), "device_ms", int(obs.cell["config"]["L"]))
