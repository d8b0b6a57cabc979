"""qaoa.cost.roofline: the QAOA step's cost-diagonal passes' share of their
HBM roofline, in %.  Each step of the traced slice needs p phase passes and
one expectation pass, each reading the state and the uint8 cost table and
writing a state (portbench/qaoa.cost_bytes, from the configuration); those
bytes over the card's published bandwidth (peaks.json), divided by the
summed device time of qaoa_phase_kernel and qaoa_expect_kernel
(csrc/qaoa.cu) in the slice.  Nothing where neither kernel ran.
Layer: variational.  Source: the device trace.  Moves: attempt_ms."""

from portbench import layers, qaoa

UNIT = "%"
MOVES = "attempt_ms"
KERNELS = ("qaoa_phase_kernel", "qaoa_expect_kernel")


def read(obs):
    if obs.trace is None or MOVES not in obs.reports or obs.cell["generator"] != "qaoa_adam":
        return None
    cfg = obs.cell["config"]
    nbytes = obs.counters.get("attempts", 0) * qaoa.cost_bytes(int(cfg["n"]), int(cfg["p"]), cfg["precision"])
    t = obs.trace.device_seconds(lambda name, span: layers.ident(name) in KERNELS)
    return layers.share(nbytes, layers.hbm_bytes_per_s(obs), t)
