"""Host clock of the f32 march calls (each ending in a synchronise), summed
over the untraced marches, over their lock-step iterations."""
from metrics._common import untraced


def read(run):
    ms = untraced(run)
    its = sum(m['iterations'] for m in ms)
    return 1e3 * sum(m['f32_wall'] for m in ms) / its if its else None
