"""Lock-step loop iterations of the f64 finish (the ``march.iterations``
change over its top-level ``finish`` span: its repeats' marches summed),
as the mean over the untraced marches.  For one seed it repeats march by
march; the window's mean varies with the number of marches it holds
where the marches differ."""
from metrics._spans import iterations, untraced_tops


def read(run):
    tops = untraced_tops(run, 'finish')
    if not tops:
        return None
    return sum(iterations(s) for s in tops) / len(tops)
