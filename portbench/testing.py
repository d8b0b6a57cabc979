"""Helpers of the benchmark's CPU tests: a cell shrunk to a small register
and run through the kernels' plain versions, without the card."""

import os
import time

CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Small registers for CPU runs of the cells (config keys overridden).
SMALL_FULL = {"C": 21, "a": 2, "L": 6, "M": 5}
SMALL_SC = {"C": 2**16 - 3, "a": 7, "L": 20, "M": 16}


def small(workload: str, root=None) -> dict:
    """Config overrides that shrink a cell to a CPU test's size."""
    from portbench import core

    kind = core.cell(workload, root or core.ROOT)["config"]["kind"]
    return {"config": dict(SMALL_SC if kind == "semiclassical" else SMALL_FULL)}


def run_small(workload: str, seed: int = 7, seconds: float = 0.3, trace: bool = False, config=None, root=None):
    from portbench import core

    ov = small(workload, root)
    ov["config"].update(config or {})
    kw = {} if root is None else {"root": root}
    return core.run(workload, seed, seconds, trace, time.perf_counter(), device="cpu", overrides=ov, **kw)
