"""How long the other ranks wait for the slowest at the gather: the most
lock-step iterations a rank's own members took minus the fewest, over the
most, summed over the window's marches, in %."""


def read(run):
    ranks = run.get('rank_marches')
    if not ranks:
        return None
    its = [sum(m['own_iterations'] for m in marches) for marches in ranks]
    return 100.0 * (max(its) - min(its)) / max(its) if max(its) else None
