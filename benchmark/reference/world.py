"""The grey column world of a configuration file, rebuilt in float64 NumPy.

A plain reference of what the program's world constructor derives from a
configuration: the optical-depth profile families, the adaptive interface
pressure grid, the cell pressures and the short-wave albedo correction, as
the NumPy original defines them (grey_optical_depth.py, GreyGas.get_p_grid
at grey.py:129-249, base.py:30-48).  Frozen here: a later change to the
program does not change what the benchmark holds it to.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
from scipy.signal import argrelextrema

# sympl's default constants (Model/constants.py of the NumPy original)
G = 9.80665
C_P_DRY = 1004.64
SIGMA = 5.670367e-8
R_SPECIFIC = 287.0
P_SURFACE_EARTH = 1.0132e5
P_TOA_EARTH = 20.0
F_SUN = 1367.0
SECONDS_PER_DAY = 86400.0
SECONDS_PER_YEAR = 365 * SECONDS_PER_DAY


@dataclass(frozen=True)
class Profile:
    """tau(p) and q(p) of one absorber; ``args`` with p_surface pinned."""
    name: str
    args: tuple
    tau: callable
    dtau_dp: callable

    def q(self, p):
        return (G / self.args[-1]) * self.dtau_dp(p)

    @property
    def is_zero(self):
        return any(a == 0 for a in self.args)


def _scale_height_alpha(p_width, p_surface):
    p_fall = p_surface - p_width
    return 0.0 if p_fall == 0 else -1.0 / math.log(p_fall / p_surface)


def _exponential_alpha(p_width, p_max):
    return 1.0 / p_width


def scale_height(p_width=0.22 * P_SURFACE_EARTH, tau_surface=4.0,
                 p_surface=P_SURFACE_EARTH, k=1.0):
    """tau = tau_s (p / p_s)^(alpha + 1) (grey_optical_depth.py:47-76)."""
    a = _scale_height_alpha(p_width, p_surface)
    return Profile('scale_height', (p_width, tau_surface, p_surface, k),
                   lambda p: tau_surface * (p / p_surface) ** (a + 1.0),
                   lambda p: tau_surface * (a + 1.0) * (p / p_surface) ** a
                   / p_surface)


def _peak_terms(p_width, p_max, tau_surface, p_surface):
    a = _exponential_alpha(p_width, p_max)
    coef = tau_surface / (2.0 - math.exp(-a * p_max)
                          - math.exp(a * (p_max - p_surface)))

    def tau(p):
        below = coef * (np.exp(np.minimum(a * (p - p_max), 0.0))
                        - math.exp(-a * p_max))
        above = coef * (2.0 - math.exp(-a * p_max)
                        - np.exp(np.minimum(a * (p_max - p), 0.0)))
        return np.where(p <= p_max, below, above)

    def dtau_dp(p):
        return np.where(p <= p_max,
                        coef * a * np.exp(np.minimum(a * (p - p_max), 0.0)),
                        coef * a * np.exp(np.minimum(a * (p_max - p), 0.0)))
    return tau, dtau_dp


def scale_height_and_peak_in_atmosphere(
        p_width1=0.7788 * P_SURFACE_EARTH, tau_surface1=4.0, p_width2=1e4,
        p_max2=5e4, tau_surface2=4.0, p_surface=P_SURFACE_EARTH, k=1.0):
    """The sum of the scale-height and the peaked families
    (grey_optical_depth.py:211-300)."""
    sh = scale_height(p_width1, tau_surface1, p_surface, k)
    pk_tau, pk_d = _peak_terms(p_width2, p_max2, tau_surface2, p_surface)
    return Profile('scale_height_and_peak_in_atmosphere',
                   (p_width1, tau_surface1, p_width2, p_max2, tau_surface2,
                    p_surface, k),
                   lambda p: sh.tau(p) + pk_tau(p),
                   lambda p: sh.dtau_dp(p) + pk_d(p))


FAMILIES = {'scale_height': (scale_height, 2),
            'scale_height_and_peak_in_atmosphere':
                (scale_height_and_peak_in_atmosphere, 5)}


def make_profile(name, args, p_surface):
    """The family's defaults overridden by ``args``, p_surface pinned
    (GreyGas.ensure_p_surface_correct_in_tau_func, grey.py:108-127)."""
    func, p_arg = FAMILIES[name]
    full = list(func.__defaults__)
    full[:len(args)] = list(args)
    full[p_arg] = p_surface
    return func(*full)


def p_grid(lw, sw, nz, p_surface, p_toa):
    """Interface pressures, surface first, of a fixed-``nz`` grid
    (grey.py:129-249 with an integer nz)."""
    size = int(nz * 1000)
    p0 = np.logspace(np.log10(p_surface), np.log10(p_toa), size)
    q = np.asarray(lw.q(p0), np.float64)
    small = 1e-10
    sw_max = np.array([], dtype=int)
    if sw is not None:
        q_sw = np.asarray(sw.q(p0), np.float64)
        sw_max = argrelextrema(np.insert(q_sw, 0, q_sw[1] - small),
                               np.greater)[0] - 1
        sw_max = sw_max[sw_max >= 0]
        q = q + q_sw
    cum_q = np.cumsum(q)
    maxima = argrelextrema(np.insert(q, 0, q[1] - small), np.greater)[0] - 1
    maxima = maxima[maxima >= 0]
    if sw is not None:
        maxima = np.sort(np.concatenate((maxima, sw_max)))
    qmax = q[maxima]
    points = np.floor(qmax / qmax.sum() * nz).astype(int)
    points[-1] = nz - points[:-1].sum()
    idx, last_above = [], 0
    for i in range(len(maxima)):
        if points[i] <= 0:
            continue
        q_thresh = min(np.percentile(q, 75), q[maxima[i]] / 1000)
        if maxima[i] == 0:
            below = 0
        else:
            cand = np.arange(maxima[i])
            below = max(cand[np.abs(q[cand] - q_thresh).argmin()], last_above)
        cand = np.arange(maxima[i], size)
        above = cand[np.abs(q[cand] - q_thresh).argmin()]
        for j in range(i, len(maxima) - 1):
            if above > maxima[j + 1]:
                points[i] += points[j + 1]
                points[j + 1] = 0
        if i == 0 and below != 0:
            points[i] -= 1
            idx.append(0)
        last = i == len(maxima) - 1 and above != size - 1
        if last:
            points[i] -= 1
        vals = np.linspace(cum_q[below], cum_q[above], points[i])
        new = [int(np.abs(cum_q - v).argmin()) for v in vals]
        idx += new
        if last:
            idx.append(size - 1)
        if len(new) >= 2:
            last_above = new[-1] * 2 - new[-2]
        elif new:
            last_above = new[-1] + 1
    p_int = p0[idx]
    log_p = np.log10(p_int)
    d_log_p = np.abs(np.ediff1d(log_p))
    d_tau = np.abs(np.ediff1d(np.asarray(lw.tau(p_int), np.float64)))
    fix = np.where(d_log_p > 0.1)[0]
    for i in fix[d_tau[fix] > 1e-3]:
        n_new = int(min(max(np.ceil((log_p[i - 1] - log_p[i]) / 0.05), 3),
                        nz / 10))
        hi = int(min(i + np.ceil(n_new / 2), nz) - 1)
        lo = int(max(hi - n_new, 0))
        if lo == 0:
            hi = n_new
        p_int[lo:hi + 1] = np.logspace(log_p[lo], log_p[hi], n_new + 1)
    return np.ascontiguousarray(np.flip(np.sort(np.unique(p_int))))


@dataclass
class GreyWorld:
    """Float64 inputs of a single-column (ny = 1) grey world."""
    p_interface: np.ndarray      # [nz] surface first
    p_centre: np.ndarray         # [nz - 1]
    dtau: np.ndarray             # [nz - 1] |tau_lw difference| of each cell
    tau_sw_interface: np.ndarray | None   # [nz], None: transparent
    albedo_mod: float
    temp_change: float
    delta_temp_change: float

    @property
    def n(self):
        return self.dtau.shape[0]


def grey_world(cfg):
    """The world of a configuration file's ``world`` entry (a single
    column, latitude factor 1)."""
    w = cfg['world']
    ps, pt = w.get('p_surface', P_SURFACE_EARTH), w.get('p_toa', P_TOA_EARTH)
    lw = make_profile(w['tau_lw_func'], w['tau_lw_func_args'], ps)
    sw = (make_profile(w['tau_sw_func'], w['tau_sw_func_args'], ps)
          if w.get('tau_sw_func') else None)
    if sw is not None and sw.is_zero:
        sw = None
    p_int = p_grid(lw, sw, int(w['nz']), ps, pt)
    tau = np.asarray(lw.tau(p_int), np.float64)
    albedo = float(w.get('albedo', 0.3))
    tau_sw = None if sw is None else np.asarray(sw.tau(p_int), np.float64)
    return GreyWorld(
        p_interface=p_int, p_centre=0.5 * (p_int[:-1] + p_int[1:]),
        dtau=np.abs(tau[1:] - tau[:-1]), tau_sw_interface=tau_sw,
        albedo_mod=albedo if tau_sw is None else albedo * math.exp(
            -2 * tau_sw[0]),
        temp_change=float(w.get('temp_change', 1.0)),
        delta_temp_change=float(w.get('delta_temp_change', 0.01)))
