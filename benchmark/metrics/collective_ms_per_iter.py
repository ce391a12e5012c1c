"""NCCL kernels' device time in the traced f32 march (by kernel name, from
each rank's profiler events, waiting for the other ranks included), over
that rank's own lock-step iterations: the slowest rank's, in ms."""


def read(run):
    ranks = run.get('rank_marches')
    if not ranks or len(run['traces']) != len(ranks):
        return None
    worst = None
    for tr, marches in zip(run['traces'], ranks):
        its = [m['own_iterations'] for m in marches
               if m['traced'] == 'device']
        if not its or not its[0]:
            return None
        nccl = [e - s for s, e, name in tr.kernels if 'nccl' in name.lower()]
        if not nccl:
            return None
        t = sum(nccl)
        worst = max(worst or 0.0, 1e3 * t / its[0])
    return worst
