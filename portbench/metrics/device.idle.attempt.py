"""device.idle.attempt: the share of the traced slice in which no kernel,
copy or memset ran on the card, in %: 1 - (union of device intervals /
the slice), from torch.profiler, in the full-register cells.
Layer: device.  Source: the device trace.  Moves: attempt_ms."""

UNIT = "%"
MOVES = "attempt_ms"


def value(obs):
    if obs.trace is None:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s() / obs.trace.window_s)


def read(obs):
    return value(obs) if MOVES in obs.reports else None
