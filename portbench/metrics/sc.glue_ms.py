"""sc.glue_ms: device time a semiclassical step spends outside the port's
own CUDA kernels, in ms: every kernel, copy and memset of the traced
slice whose identifier is not one of csrc/*.cu's, over L steps times the
slice's attempts.  That is the step's torch glue (the rotation, the branch
sums, the collapse, the gather steps' index generation and gather).
Layer: semiclassical step.  Source: the device trace.  Moves: sc_step_ms."""

from portbench import layers

UNIT = "ms"
MOVES = "sc_step_ms"
CSRC = (
    "fused_segment_kernel", "camodc_permute_kernel", "block_sums_kernel", "chunk_gather_kernel",
    "transpose_kernel", "walk_preread_kernel", "cycle_walk_kernel", "gather_kernel", "ladder_kernel",
    "strip_kernel", "copy_kernel", "roll2_kernel", "mxuroll_kernel", "roll_kernel",
)


def read(obs):
    attempts = obs.counters.get("attempts", 0)
    if obs.trace is None or not attempts or MOVES not in obs.reports:
        return None
    t = obs.trace.device_seconds(lambda name, span: layers.ident(name) not in CSRC)
    return 1e3 * t / (attempts * int(obs.cell["config"]["L"]))
