"""The yardstick: the card's published peaks, the least bytes a step or a
kernel must move (counted from shapes: each input read once, each output
written once), and the outcome arithmetic of the port's first bench
(``climatemodel_tpu_torch/bench.py``'s ``_flags`` and ``_days``), frozen
here so that a change to the program cannot move what it is measured by.
"""
from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM, published: HBM3 bytes/s and dense float32 FLOP/s
#: outside the tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

SECONDS_PER_DAY = 86400.0


def days(t):
    """Simulated days summed over members of a march's times t [B] (s)."""
    return float(np.asarray(t, np.float64).sum()) / SECONDS_PER_DAY


def flags(equilibrium, timed_out, failed, nan):
    """The outcome flags of a march's members (bench.py ``_flags``)."""
    eq, out, fl, bad = (np.asarray(x, bool)
                        for x in (equilibrium, timed_out, failed, nan))
    return dict(converged_fraction=float(eq.mean()),
                equilibrium=bool(eq.all()), timed_out=bool(out.any()),
                failed=bool(fl.any()), nan=bool(bad.any()))


def step_bytes(B, n, *, itemsize=4, convective=False):
    """Least bytes of one lock-step iteration of B members of n cells: the
    member state read and written once, the hoisted forcing read once.

    State a member: T [n] and the held net flux [n + 1]; simulated time,
    the threshold and delta statistic, the dt controller's five floats and
    its index, two counters and the step count (int32); the removed and
    convective level masks [n] and four exit flags (bool).  Forcing a
    member: dtau [n], the short-wave up and down fluxes [n + 1] and the
    top boundary; shared: the interface pressures [n + 1] and, for the
    convective march, the cell pressures [n]."""
    floats = n + (n + 1) + 1 + 2 + 5
    ints = 1 + 2 + 1
    bools = 2 * n + 4
    state = floats * itemsize + ints * 4 + bools
    forcing = (n + 2 * (n + 1) + 1) * itemsize
    shared = ((n + 1) + (n if convective else 0)) * itemsize
    return B * (2 * state + forcing) + shared


def net_stats_walk_bytes(B, n, itemsize=4):
    """Least bytes of one K3 launch (``net_stats_walk``) over B member rows
    of n cells: reads T and dtau [B, n], the short-wave fluxes and the
    previous net flux [B, n + 1] and the top boundary [B]; writes the net
    flux [B, n + 1] and four statistics [B]."""
    reads = 2 * n + 3 * (n + 1) + 1
    writes = (n + 1) + 4
    return B * (reads + writes) * itemsize


def iso_fit_bytes(C, n, itemsize=4):
    """Least bytes of one K4 launch (``iso_fit``): reads theta [C, n] and
    the weights [n]; writes the fit [C, n]."""
    return (2 * C * n + n) * itemsize


def roofline_percent(least_bytes, seconds):
    """Share (%) of the card's HBM rate that moving ``least_bytes`` in
    ``seconds`` reaches; None without a time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * least_bytes / HBM_BYTES_PER_S / seconds
