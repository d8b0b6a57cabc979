"""qaoa.grad.roofline: the QAOA step's gradient passes' share of their HBM
roofline, in %.  Each step of the traced slice needs p cost-gradient passes
(read psi, lambda and the cost table, write both; the last layer reads
only) and p mixer reductions, each reading psi and lambda once
(portbench/qaoa.grad_bytes, from the configuration: the least whatever
tiles the program cuts the reduction into); those bytes over the card's
published bandwidth (peaks.json), divided by the summed device time of
qaoa_cost_grad_kernel and qaoa_mixer_grad_kernel (csrc/qaoa.cu) in the
slice.  Nothing where neither kernel ran.
Layer: variational.  Source: the device trace.  Moves: attempt_ms."""

from portbench import layers, qaoa

UNIT = "%"
MOVES = "attempt_ms"
KERNELS = ("qaoa_cost_grad_kernel", "qaoa_mixer_grad_kernel")


def read(obs):
    if obs.trace is None or MOVES not in obs.reports or obs.cell["generator"] != "qaoa_adam":
        return None
    cfg = obs.cell["config"]
    nbytes = obs.counters.get("attempts", 0) * qaoa.grad_bytes(int(cfg["n"]), int(cfg["p"]), cfg["precision"])
    t = obs.trace.device_seconds(lambda name, span: layers.ident(name) in KERNELS)
    return layers.share(nbytes, layers.hbm_bytes_per_s(obs), t)
