"""sc.plan_ms: host time a semiclassical step spends planning its
structured permutation, in ms: the program's sc.plan span
(algorithms/semiclassical._structured_plans, the L stride-permutation
plans of an attempt), summed over the traced slice over its steps.
Layer: structured permutation.  Source: the program's spans.  Moves: sc_step_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "sc_step_ms"


def read(obs):
    if MOVES not in obs.reports:
        return None
    return program_spans.per_attempt(obs, "sc.attempt", ("sc.plan",), "host_ms", int(obs.cell["config"]["L"]))
