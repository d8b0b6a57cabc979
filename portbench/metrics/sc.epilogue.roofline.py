"""sc.epilogue.roofline: the semiclassical step's two epilogue kernels'
share of their HBM roofline, in %.  Every op of the traced slice named
sc_branch_sums_kernel (csrc/sc_step.cu: reads w, gr and gi, twice the
state's bytes) or sc_collapse_kernel (reads them and writes w, three times
the state's bytes), over the card's published bandwidth, divided by those
ops' summed device time.  Nothing where neither kernel ran (a program
without them keeps the step's PyTorch composition).
Layer: semiclassical step.  Source: the device trace.  Moves: sc_step_ms."""

from portbench import layers

UNIT = "%"
MOVES = "sc_step_ms"
# Passes over the state's bytes, by kernel.
PASSES = {"sc_branch_sums_kernel": 2, "sc_collapse_kernel": 3}


def read(obs):
    if obs.trace is None or MOVES not in obs.reports:
        return None
    cfg = obs.cell["config"]
    state = layers.planes_bytes(int(cfg["M"]), cfg["precision"])
    nbytes, seconds = 0, 0.0
    for name, _, dur, _ in obs.trace.ops:
        passes = PASSES.get(layers.ident(name))
        if passes:
            nbytes += passes * state
            seconds += dur * 1e-6
    return layers.share(nbytes, layers.hbm_bytes_per_s(obs), seconds)
