"""engine.reset_ms: device time of the state's reset an attempt in an
m_high cell, in ms: the program's engine.reset spans (the fresh |0..01>
state inside StateVectorEngine.run: its allocation and fill), timed by
CUDA events at their start and end, summed over the traced slice over its
attempts.  None where the program has no such span.
Layer: engine + planner.  Source: the program's spans.  Moves: attempt_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "attempt_ms"


def read(obs):
    if MOVES not in obs.reports or obs.cell["params"].get("layout") != "m_high":
        return None
    recs = program_spans.records(obs)
    if recs is None or not any(r.name == "engine.reset" for r in recs):
        return None
    return program_spans.per_attempt(obs, "driver.attempt", ("engine.reset",), "device_ms")
