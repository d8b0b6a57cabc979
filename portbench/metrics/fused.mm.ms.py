"""fused.mm.ms: device time of the fused segments that ran matrix groups
(the tensor-core form, csrc/fused_matmul.cu: lanemat, rowmat and xtable
ops on bf16 planes) an attempt, in ms: the program's fused.segment spans
whose `groups` count is above 0, timed by CUDA events at their start and
end, summed over the traced slice over its attempts (driver.attempt
roots).  None where no span ran a matrix group: a program without the
count, or a cell whose segments all keep the butterfly form.
Layer: fused segments.  Source: the program's spans.  Moves: attempt_ms."""

from portbench import program_spans

UNIT = "ms"
MOVES = "attempt_ms"


def read(obs):
    if MOVES not in obs.reports or program_spans.roots(obs, "driver.attempt") is None:
        return None
    found = [r for r in program_spans.records(obs) if r.name == "fused.segment" and r.counts.get("groups", 0) > 0]
    if not found or any(r.device_ms is None for r in found):
        return None
    return sum(r.device_ms for r in found) / obs.counters["attempts"]
