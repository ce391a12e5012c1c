"""Shared helpers of the metric readers.  A reader's ``read(run)`` takes
the run's record (``benchmark/run.py``'s ``measure``) and returns a number,
or None where the run holds nothing to read."""
from __future__ import annotations


def untraced(run):
    """The marches made before any profiling (all, if none was)."""
    plain = [m for m in run['marches'] if not m['traced']]
    return plain or run['marches']


def shape(run):
    """(members, cells) of the cell's march."""
    return (int(run['traffic']['members']),
            int(run['config']['world']['nz']) - 1)


def traced_iterations(run):
    """Lock-step iterations of the f32 march traced for the device metrics
    (of rank 0's own shard when ranks ran)."""
    traced = [m for m in run['marches'] if m['traced'] == 'device']
    if not traced:
        return None
    return traced[0].get('own_iterations', traced[0]['iterations'])


def trace0(run):
    """The device trace of the traced march (of rank 0 when ranks ran),
    or None."""
    return run['traces'][0] if run['traces'] else None
