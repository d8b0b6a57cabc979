"""fused.mm.roofline: the tensor-core segments' share of their HBM
roofline, in %: the traced slice's fused.segment spans whose `groups`
count is above 0 (the MAT instance of fused_segment_kernel,
csrc/fused_matmul.cu), each one read and one write of the state's planes,
over the card's published bandwidth (peaks.json), divided by those spans'
device time (CUDA events at their start and end).  None where no span ran
a matrix group.
Layer: fused segments.  Source: the program's spans.  Moves: attempt_ms."""

from portbench import layers, program_spans

UNIT = "%"
MOVES = "attempt_ms"


def read(obs):
    if MOVES not in obs.reports or program_spans.roots(obs, "driver.attempt") is None:
        return None
    found = [r for r in program_spans.records(obs) if r.name == "fused.segment" and r.counts.get("groups", 0) > 0]
    if not found or any(r.device_ms is None for r in found):
        return None
    cfg = obs.cell["config"]
    nbytes = len(found) * 2 * layers.planes_bytes(cfg["L"] + cfg["M"], cfg["precision"])
    return layers.share(nbytes, layers.hbm_bytes_per_s(obs), 1e-3 * sum(r.device_ms for r in found))
