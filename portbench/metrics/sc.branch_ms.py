"""sc.branch_ms: device time a semiclassical step spends on its branch
sums, in ms: the program's sc.branch_sums spans (the structured steps'
blockwise p0 / p1 sums), timed by CUDA events at their start and end,
summed over the traced slice over its steps.
Layer: semiclassical step.  Source: the program's spans.  Moves: sc_step_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "sc_step_ms"


def read(obs):
    if MOVES not in obs.reports:
        return None
    return program_spans.per_attempt(obs, "sc.attempt", ("sc.branch_sums",), "device_ms", int(obs.cell["config"]["L"]))
