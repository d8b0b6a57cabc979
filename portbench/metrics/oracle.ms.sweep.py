"""oracle.ms.sweep: oracle.ms in the sweep cell, whose attempt time is
sweep_attempt_ms (PERF.md); the arithmetic is oracle.ms's.
Layer: oracle.  Source: the program's spans.  Moves: sweep_attempt_ms."""

import os

from portbench import core

_base = core.load_module("metrics", "oracle.ms", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

UNIT = _base.UNIT
MOVES = "sweep_attempt_ms"


def read(obs):
    return _base.value(obs) if MOVES in obs.reports else None
