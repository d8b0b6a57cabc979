"""Closed loop of full-register attempts on one base in the m_high layout:
the configuration's ``a`` every attempt, one draw an attempt from the
seed, compared with the closed form in the layout's physical order
(``portbench/mhigh.py``)."""

from portbench import core, mhigh

#: End-to-end metrics besides setup_s and peak_gib: name -> f(attempts, window start, cell).
E2E = {
    "attempt_ms": lambda attempts, t0, cell: core.window_ms(attempts, t0),
    "attempt_p95_ms": lambda attempts, t0, cell: core.p95_ms(attempts),
}


def setup(cell: dict, seed: int):
    from quantumcomputer_tpu_torch.ops import measure

    cfg = cell["config"]
    # A program whose sampler cannot take a state this large raises here,
    # before the engine builds its kernels.
    measure.block_geom(1 << (int(cfg["L"]) + int(cfg["M"])))
    a = int(cell["params"].get("a", cfg["a"]))
    return mhigh.MhighRunner(cell, seed, lambda i: a, [a] * int(cell["params"].get("warm_attempts", 2)))
