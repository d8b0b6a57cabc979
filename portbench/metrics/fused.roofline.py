"""fused.roofline: the fused segments' share of their HBM roofline, in %.
Launches of fused segments over the traced slice (the program's counters
ops/fused.LAUNCHES less PERMUTE_LAUNCHES, which count the camodc
permutation kernel apart) times one read and one write of the whole
state, over the card's published bandwidth (peaks.json), divided by the
summed device time of the kernels named fused_segment_kernel
(csrc/fused_segment.cu, csrc/fused_matmul.cu).
Layer: fused segments.  Source: counters and the device trace.  Moves: attempt_ms."""

from portbench import layers

UNIT = "%"
MOVES = "attempt_ms"
KERNELS = ("fused_segment_kernel",)


def read(obs):
    return value(obs) if MOVES in obs.reports else None


def value(obs):
    launches = obs.counters.get("fused", 0) - obs.counters.get("permute", 0)
    if obs.trace is None or launches <= 0:
        return None
    cfg = obs.cell["config"]
    nbytes = launches * 2 * layers.planes_bytes(cfg["L"] + cfg["M"], cfg["precision"])
    t = obs.trace.device_seconds(lambda name, span: layers.ident(name) in KERNELS)
    return layers.share(nbytes, layers.hbm_bytes_per_s(obs), t)
