"""The whole lock-step iteration's share of the card's peak: the least
time an iteration needs (its least bytes over the HBM rate; the step moves
bytes, it does not compute) over ``iteration_ms``, in %."""
from core.yardstick import roofline_percent, step_bytes
from metrics import iteration_ms
from metrics._common import shape


def read(run):
    ms = iteration_ms.read(run)
    if not ms:
        return None
    B, n = shape(run)
    conv = bool(run['config']['march'].get('convective_adjust'))
    return roofline_percent(step_bytes(B, n, convective=conv), ms * 1e-3)
