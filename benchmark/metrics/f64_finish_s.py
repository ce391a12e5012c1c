"""Host clock of the f64 finish and the result's read-back a march, as the
mean over the untraced marches."""
from metrics._common import untraced


def read(run):
    ms = untraced(run)
    return sum(m['finish_wall'] for m in ms) / len(ms)
