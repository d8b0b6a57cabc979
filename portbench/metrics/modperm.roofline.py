"""modperm.roofline: the structured permutation's share of its HBM
roofline, in %.  For every step of the traced slice that planned (the
attempts' ``oracles`` records), both planes of the work state read once
and written once, over the card's published bandwidth, divided by the
device time of transpose_kernel and chunk_gather_kernel
(csrc/transpose.cu, csrc/chunk_gather.cu) in the slice.
Layer: structured permutation.  Source: the program's records and the
device trace.  Moves: sc_step_ms."""

from portbench import layers

UNIT = "%"
MOVES = "sc_step_ms"
KERNELS = ("transpose_kernel", "chunk_gather_kernel")


def read(obs):
    if obs.trace is None or MOVES not in obs.reports:
        return None
    planned = sum(r["oracles"].count("structured") for r in obs.records)
    cfg = obs.cell["config"]
    nbytes = planned * 2 * layers.planes_bytes(int(cfg["M"]), cfg["precision"])
    t = obs.trace.device_seconds(lambda name, span: layers.ident(name) in KERNELS)
    return layers.share(nbytes, layers.hbm_bytes_per_s(obs), t)
