"""Operations on the card (kernels, copies, fills) in the traced f32 march,
from the profiler's events, over its lock-step iterations."""
from metrics._common import trace0, traced_iterations


def read(run):
    tr, its = trace0(run), traced_iterations(run)
    if tr is None or not its or not tr.kernels:
        return None
    return len(tr.kernels) / its
