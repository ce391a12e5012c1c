"""Host-side pressure-grid construction.

Grid generation is shape-determining and therefore runs once in NumPy at model
build time; the resulting arrays are frozen and copied to the device as tensors.
The same code as ``climatemodel_tpu/utils/grids.py``: the grids stay float64
NumPy so both packages build byte-equal grids.  This module re-implements the adaptive ('auto') grey-gas grid of the
reference (GreyGas.get_p_grid, grey.py:129-249 of the NumPy original):
points are allocated around local maxima of the absorber concentration q(p) in
proportion to q_max, placed at equal increments of cumulative q, then densified
wherever the grid is sparser than ``log_p_min_sep`` in log-pressure while optical
depth still changes by more than ``tau_min_sep``.

Returned grids are ordered surface -> top-of-atmosphere (descending pressure),
matching the reference grey model's orientation.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import argrelextrema


def grey_p_grid(tau_lw, tau_sw=None, nz='auto', p_surface=None, p_toa=None,
                nz_multiplier_param=100000, q_thresh_info_percentile=75,
                q_thresh_info_max=1000, log_p_min_sep=0.1, tau_min_sep=1e-3):
    """Build the grey-gas interface pressure grid.

    :param tau_lw: GreyOpticalDepth for the long-wave absorber.
    :param tau_sw: optional GreyOpticalDepth for the short-wave absorber
        (ignored if ``tau_sw.is_zero``).
    :param nz: int or 'auto'.
    :return: (p_interface [nz], nz) with p_interface descending (surface first).
    """
    p_surface = float(p_surface if p_surface is not None else tau_lw.p_surface)
    if p_toa is None:
        raise ValueError('p_toa must be given')
    auto = nz == 'auto'
    p_initial_size = int(1e6) if auto else int(nz * 1000)
    p0 = np.logspace(np.log10(p_surface), np.log10(p_toa), p_initial_size)
    p_scratch = p0.copy()

    q = np.asarray(tau_lw.q(p_scratch), dtype=np.float64)
    small = 1e-10
    use_sw = tau_sw is not None and not tau_sw.is_zero
    sw_maxima = np.array([], dtype=int)
    if use_sw:
        q_sw = np.asarray(tau_sw.q(p_scratch), dtype=np.float64)
        sw_maxima = argrelextrema(np.insert(q_sw, 0, q_sw[1] - small), np.greater)[0] - 1
        sw_maxima = sw_maxima[sw_maxima >= 0]
        q = q + q_sw
    cum_q = np.cumsum(q)
    # catch a maximum sitting exactly at the surface by prepending a slightly
    # smaller value (same trick as grey.py:175)
    maxima = argrelextrema(np.insert(q, 0, q[1] - small), np.greater)[0] - 1
    maxima = maxima[maxima >= 0]
    if use_sw:
        maxima = np.sort(np.concatenate((maxima, sw_maxima)))

    n_maxima = len(maxima)
    q_max_values = q[maxima]
    if auto:
        # at least 5 grid points per local maximum
        nz_multiplier = max(nz_multiplier_param, np.max(5 / q_max_values))
        points_per_set = np.ceil(q_max_values * nz_multiplier).astype(int)
        nz = int(points_per_set.sum())
    else:
        nz_multiplier = None
        points_per_set = np.floor(q_max_values / q_max_values.sum() * nz).astype(int)
        points_per_set[-1] = nz - points_per_set[:-1].sum()

    indices = []
    last_above_ind = 0
    for i in range(n_maxima):
        if points_per_set[i] <= 0:
            continue
        q_thresh = min(np.percentile(q, q_thresh_info_percentile),
                       q[maxima[i]] / q_thresh_info_max)
        if maxima[i] == 0:
            below_ind = 0
        else:
            below_candidates = np.arange(maxima[i])
            below_ind = max(below_candidates[np.abs(q[below_candidates] - q_thresh).argmin()],
                            last_above_ind)
        above_candidates = np.arange(maxima[i], p_initial_size)
        above_ind = above_candidates[np.abs(q[above_candidates] - q_thresh).argmin()]
        # merge point budgets of maxima whose spans this one swallows
        for j in range(i, n_maxima - 1):
            if above_ind > maxima[j + 1]:
                points_per_set[i] += points_per_set[j + 1]
                points_per_set[j + 1] = 0
        if i == 0 and below_ind != 0:
            points_per_set[i] -= 1
            indices.append(0)
        if i == n_maxima - 1 and above_ind != p_initial_size - 1:
            points_per_set[i] -= 1
        # equal-cumulative-q placement between the span bounds
        q_grid_values = np.linspace(cum_q[below_ind], cum_q[above_ind], points_per_set[i])
        set_indices = [int(np.abs(cum_q - v).argmin()) for v in q_grid_values]
        indices += set_indices
        if i == n_maxima - 1 and above_ind != p_initial_size - 1:
            indices.append(p_initial_size - 1)
        if len(set_indices) >= 2:
            last_above_ind = set_indices[-1] * 2 - set_indices[-2]
        elif set_indices:
            last_above_ind = set_indices[-1] + 1

    p_interface = p_scratch[indices]

    # densify stretches that are too sparse in log-p while tau still changes
    log_p = np.log10(p_interface)
    delta_log_p = np.abs(np.ediff1d(log_p))
    tau_vals = np.asarray(tau_lw.tau(p_interface), dtype=np.float64)
    delta_tau = np.abs(np.ediff1d(tau_vals))
    to_correct = np.where(delta_log_p > log_p_min_sep)[0]
    to_correct = to_correct[delta_tau[to_correct] > tau_min_sep]
    target_log_delta_p = log_p_min_sep / 2
    for i in to_correct:
        if nz_multiplier is not None:
            in_range = np.logical_and(p0 < p_interface[i], p0 > p_interface[i + 1])
            n_new = max(int(np.max(q[in_range]) * nz_multiplier), 3)
            new_levels = np.logspace(log_p[i], log_p[i + 1], n_new + 2)
            p_interface = np.flip(np.sort(np.append(p_interface, new_levels[1:-1])))
            nz = len(p_interface)
        else:
            n_new = int(min(max(np.ceil((log_p[i - 1] - log_p[i]) / target_log_delta_p), 3),
                            nz / 10))
            max_i = int(min(i + np.ceil(n_new / 2), nz) - 1)
            min_i = int(max(max_i - n_new, 0))
            if min_i == 0:
                max_i = n_new
            new_levels = np.logspace(log_p[min_i], log_p[max_i], n_new + 1)
            p_interface[min_i:max_i + 1] = new_levels

    p_interface = np.flip(np.sort(np.unique(p_interface)))
    return p_interface, len(p_interface)


def log_p_grid(nz, p_surface, p_toa):
    """Plain log-spaced interface grid, surface first (descending p)."""
    return np.logspace(np.log10(p_surface), np.log10(p_toa), int(nz))


def cell_centre_pressure(p_interface):
    """Cell-centre pressures by interface averaging (grey.py:84-86)."""
    p_interface = np.asarray(p_interface)
    return 0.5 * (p_interface[:-1] + p_interface[1:])
