"""fused.roofline.sweep: fused.roofline in the sweep cell, whose attempt time is
sweep_attempt_ms (PERF.md); the arithmetic is fused.roofline's.
Layer: fused segments.  Source: counters and the device trace.  Moves: sweep_attempt_ms."""

import os

from portbench import core

_base = core.load_module("metrics", "fused.roofline", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

UNIT = _base.UNIT
MOVES = "sweep_attempt_ms"


def read(obs):
    return _base.value(obs) if MOVES in obs.reports else None
