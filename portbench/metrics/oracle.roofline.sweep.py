"""oracle.roofline.sweep: oracle.roofline in the sweep cell, whose attempt time is
sweep_attempt_ms (PERF.md); the arithmetic is oracle.roofline's.
Layer: oracle.  Source: the device trace.  Moves: sweep_attempt_ms."""

import os

from portbench import core

_base = core.load_module("metrics", "oracle.roofline", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

UNIT = _base.UNIT
MOVES = "sweep_attempt_ms"


def read(obs):
    return _base.value(obs) if MOVES in obs.reports else None
