"""Repeats of the f64 finish (the ``finish.repeats`` change over its
top-level ``finish`` span: fresh marches of the members not yet settled,
at most ``finish_repeats``), as the mean over the untraced marches; with
``finish_iterations`` and ``finish_members``, what ``f64_finish_s`` is
made of."""
from metrics._spans import untraced_tops


def read(run):
    tops = untraced_tops(run, 'finish')
    if not tops:
        return None
    return sum(s.counters.get('finish.repeats', 0) for s in tops) / len(tops)
