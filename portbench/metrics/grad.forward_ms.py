"""grad.forward_ms: device time of the differentiated run's forward, in ms:
the program's root engine.run spans (a run outside any other span: the
forward of _AdjointRun; the backward's run sits inside engine.adjoint),
timed by CUDA events, over the traced slice over its attempts; nothing
unless there is one such span and one engine.adjoint span an attempt.
Layer: engine gradient.  Source: the program's spans.  Moves: attempt_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "attempt_ms"


def read(obs):
    if MOVES not in obs.reports or program_spans.roots(obs, "engine.adjoint") is None:
        return None
    runs = [r for r in program_spans.records(obs) if r.name == "engine.run" and r.parent is None]
    if len(runs) != obs.counters.get("attempts"):
        return None
    t = program_spans.total_ms(runs, ("engine.run",), "device_ms")
    return None if t is None else t / len(runs)
