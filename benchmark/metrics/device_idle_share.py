"""1 - (union of the intervals in which an operation ran on the card) /
(the host-clock wall of the f32 march traced for the card's activity
alone, which the host profiler does not slow), in %."""
from metrics._common import trace0


def read(run):
    tr = trace0(run)
    if tr is None or not tr.kernels or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
