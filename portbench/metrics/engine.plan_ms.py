"""engine.plan_ms: host time an attempt spends planning and building
oracle tables, in ms: the program's engine.plan spans (plan_circuit, on a
plan-cache miss) and oracle.table spans (the gather oracle's
modmul_inverse_permutation table, built and copied to the card at every
gate), summed over the traced slice over its attempts.  The copy is a
pageable one, so its host time holds the wait for the work queued before it.
Layer: engine + planner.  Source: the program's spans.  Moves: attempt_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "attempt_ms"
SPANS = ("engine.plan", "oracle.table")


def value(obs):
    return program_spans.per_attempt(obs, "driver.attempt", SPANS, "host_ms")


def read(obs):
    return value(obs) if MOVES in obs.reports else None
