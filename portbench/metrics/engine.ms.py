"""engine.ms: mean host-clock time of the engine call
(StateVectorEngine.run_and_measure_index: reset, plan lookup or planning,
the fused segments, the oracles, the measurement; it returns a host int,
so it ends synchronised), in ms, over the traced run's window.
Layer: engine + planner.  Source: the benchmark's spans.  Moves: attempt_ms."""

from portbench.layers import mean

UNIT = "ms"
MOVES = "attempt_ms"


def value(obs):
    e = mean(obs.spans.get("engine", []))
    return None if e is None else 1e3 * e


def read(obs):
    return value(obs) if MOVES in obs.reports else None
