"""device.idle.sc: as device.idle.attempt, in the semiclassical cells.
Layer: device.  Source: the device trace.  Moves: sc_step_ms."""

UNIT = "%"
MOVES = "sc_step_ms"


def read(obs):
    if obs.trace is None or MOVES not in obs.reports:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s() / obs.trace.window_s)
