"""sc.oracle_ms: device time a semiclassical step spends applying its
oracle, in ms: the program's sc.permute (both planes' structured
permutation and the 1/sqrt2 scale), sc.rotate (the rotation into a1) and
sc.gather_pass spans (a step without a plan: gather, rotation and branch
sums block by block), timed by CUDA events at their start and end, summed
over the traced slice over its steps.
Layer: semiclassical step.  Source: the program's spans.  Moves: sc_step_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "sc_step_ms"
SPANS = ("sc.permute", "sc.rotate", "sc.gather_pass")


def read(obs):
    if MOVES not in obs.reports:
        return None
    return program_spans.per_attempt(obs, "sc.attempt", SPANS, "device_ms", int(obs.cell["config"]["L"]))
