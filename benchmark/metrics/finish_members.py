"""Members the f64 finish re-marches (the ``finish.members`` change over
its top-level ``finish`` span: the f32 march's timed-out members), as the
mean over the untraced marches: the width of every finish iteration."""
from metrics._spans import untraced_tops


def read(run):
    tops = untraced_tops(run, 'finish')
    if not tops:
        return None
    return sum(s.counters.get('finish.members', 0) for s in tops) / len(tops)
