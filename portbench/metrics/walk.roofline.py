"""walk.roofline: the m_high oracle's share of its least HBM time, in %.
The bytes of the traced slice's oracle passes (portbench/mhigh.oracle_bytes:
each ladder every element of both planes once each way, each in-place walk,
pair or strip run the elements it moves, reckoned from the circuit's
controls and multipliers and the state's size), over the card's published
bandwidth, divided by the device time of the m_high oracle kernels
(csrc/oracle_cycle.cu's walk and its pre-read, csrc/oracle_ladder.cu,
csrc/oracle_strip.cu, csrc/oracle_gather.cu).  The passes are the
program's oracle.gate spans in order, each with its gate count and whether
it ran in place; None where the spans do not say (a program without the
`inplace` count).
Layer: oracle.  Source: the program's spans and the device trace.  Moves: attempt_ms."""

from portbench import layers, mhigh, program_spans

UNIT = "%"
MOVES = "attempt_ms"
KERNELS = ("cycle_walk_kernel", "walk_preread_kernel", "ladder_kernel", "strip_kernel", "gather_kernel")


def read(obs):
    if MOVES not in obs.reports or obs.cell["params"].get("layout") != "m_high":
        return None
    return value(obs)


def value(obs):
    if obs.trace is None or program_spans.roots(obs, "driver.attempt") is None:
        return None
    gates = [r for r in program_spans.records(obs) if r.name == "oracle.gate"]
    if not gates or any("inplace" not in r.counts for r in gates):
        return None
    cfg = obs.cell["config"]
    a = int(obs.cell["params"].get("a", cfg["a"]))
    passes = [(r.counts["gates"], r.counts["inplace"]) for r in gates]
    nbytes = mhigh.oracle_bytes(passes, int(cfg["C"]), a, int(cfg["L"]), int(cfg["M"]), layers.ITEMSIZE[cfg["precision"]])
    if nbytes is None:
        return None
    t = obs.trace.device_seconds(lambda name, span: layers.ident(name) in KERNELS)
    return layers.share(nbytes, layers.hbm_bytes_per_s(obs), t)
