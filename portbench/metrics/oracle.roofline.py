"""oracle.roofline: the oracle stage's share of its least HBM time, in %.
The L controlled multiplies together move every block in which any control
is 1 exactly once, whatever implements them: at least 2 x state bytes x
(1 - 2^-L) an attempt (1.28 ms at n = 28, complex64, 3.35 TB/s).  That,
times the attempts of the traced slice, over the card's published
bandwidth, is divided by the device time of the kernels that carry out the
oracle gates, in every form the engine has:

* gather (ops/gates.apply_c_amodc_planes_): torch's index_select (on the
  H100 with PyTorch 2.11 a ``_scatter_gather_elementwise_kernel``) and
  the copies back into the control-1 halves (``direct_copy``), launched
  inside the engine's run (span ``run``; the measurement's block gather
  runs outside it, and the reset's fill is no copy);
* benes (csrc/camodc_permute.cu): camodc_permute_kernel;
* m_high (ops/oracle.py): the cycle walk, its pre-read, the ladder, the
  strip pass and the row gather of csrc/oracle_*.cu.

Layer: oracle.  Source: the device trace.  Moves: attempt_ms."""

from portbench import layers

UNIT = "%"
MOVES = "attempt_ms"
KERNELS = ("camodc_permute_kernel", "cycle_walk_kernel", "walk_preread_kernel", "ladder_kernel", "strip_kernel", "gather_kernel")


def is_oracle(name: str, span) -> bool:
    if layers.ident(name) in KERNELS:
        return True
    if span != "run":
        return False
    low = name.lower()
    return any(k in low for k in ("indexselect", "index_select", "scatter_gather", "direct_copy"))


def read(obs):
    return value(obs) if MOVES in obs.reports else None


def value(obs):
    attempts = obs.counters.get("attempts", 0)
    if obs.trace is None or not attempts:
        return None
    cfg = obs.cell["config"]
    L = int(cfg["L"])
    nbytes = attempts * 2 * layers.planes_bytes(L + cfg["M"], cfg["precision"]) * (1 - 2.0**-L)
    t = obs.trace.device_seconds(is_oracle)
    return layers.share(nbytes, layers.hbm_bytes_per_s(obs), t)
