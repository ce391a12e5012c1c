"""Host syncs of the group blend (the ``blend.sweeps`` counter, one an
outer sweep) a loop iteration of the march (``march.iterations``, the
no-op iterations up to the closing stop check included: each calls the
blend), over the untraced marches' top-level ``march`` spans.  For one
seed it repeats march by march; the window's mean varies with the number
of marches it holds."""
from metrics._spans import iterations, untraced_tops


def read(run):
    tops = untraced_tops(run, 'march')
    its = sum(iterations(s) for s in tops) if tops else 0
    if not its:
        return None
    return sum(s.counters.get('blend.sweeps', 0) for s in tops) / its
