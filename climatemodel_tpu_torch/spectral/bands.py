"""Wavenumber grid and equal-flux band construction for the real-gas solver
(port of ``climatemodel_tpu/spectral/bands.py``).

Host-side NumPy float64 (shape-determining), bit-equal to the JAX package:
the reference's real_gas.py:300-402.  The wavenumber range
covers 99.9% of both the stellar and planetary Planck curves; bands are
allocated so each carries roughly equal flux, with the overlap region blending
both spectra, and each band is tagged short-wave if the atmosphere's own
emission integral can be neglected there.
"""
from __future__ import annotations

from math import ceil

import numpy as np

from ..ops.planck import B_wavenumber


def get_wavenumber_array(T_g, T_star, d_nu, fract_to_ignore=0.001,
                         fract_to_ignore_overlap=0.001):
    """Wavenumber grids covering the planetary + stellar spectra
    (real_gas.py:300-334).

    :return: (nu, nu_lw, nu_overlap, nu_sw)
    """
    nu_initial = np.arange(10.0, 100000.0 + d_nu, d_nu)
    B_star = B_wavenumber(nu_initial, T_star)
    B_planet = B_wavenumber(nu_initial, T_g)
    max_nu = nu_initial[np.abs(np.cumsum(B_star) / B_star.sum()
                               - (1 - fract_to_ignore)).argmin()]
    min_nu = nu_initial[np.abs(np.cumsum(B_planet) / B_planet.sum()
                               - fract_to_ignore).argmin()]
    sw_nu_min = nu_initial[np.abs(np.cumsum(B_star) / B_star.sum()
                                  - fract_to_ignore_overlap).argmin()]
    lw_nu_max = nu_initial[np.abs(np.cumsum(B_planet) / B_planet.sum()
                                  - (1 - fract_to_ignore_overlap)).argmin()]
    nu = np.arange(min_nu, max_nu + d_nu, d_nu)
    nu_overlap = nu[np.logical_and(nu <= lw_nu_max, nu >= sw_nu_min)]
    nu_lw = nu[nu <= lw_nu_max]
    nu_sw = nu[nu >= lw_nu_max]
    return nu, nu_lw, nu_overlap, nu_sw


def get_equal_bands(nu, B, n_bands):
    """Split nu into n_bands of ~equal cumulative normalised flux
    (real_gas.py:347-362)."""
    B_norm = B / B.max()            # fresh array: safe to mutate below
    # fold the post-peak decrease into a monotone increase
    B_norm[B_norm.argmax():] = 1 + (1 - B_norm[B_norm.argmax():])
    B_norm = B_norm - B_norm.min()
    B_norm = B_norm / B_norm.max()
    targets = np.linspace(0, 1, n_bands + 1)[1:]
    info = {'range': [], 'centre': np.zeros(len(targets)),
            'delta': np.zeros(len(targets))}
    start = 0
    for i, t in enumerate(targets):
        end = max(int(np.abs(B_norm - t).argmin()), start + 1)
        rng = nu[start:end + 1]
        info['range'].append(rng)
        info['centre'][i] = rng[round((len(rng) + 1) / 2) - 1]
        info['delta'][i] = rng[-1] - rng[0]
        start = end
    return info


def get_wavenumber_bands(n_nu_bands, T_g, T_star, nu_lw, nu_overlap, nu_sw):
    """Allocate n_nu_bands across lw / overlap / sw regions, equal-flux within
    each (real_gas.py:336-402).

    :return: dict with 'range' (list of nu arrays), 'centre', 'delta',
        'sw' (bool per band).
    """
    B_star = B_wavenumber(nu_sw, T_star)
    nu_lw_only = np.setdiff1d(nu_lw, nu_overlap)
    B_planet = B_wavenumber(nu_lw_only, T_g)

    B_overlap_planet = B_wavenumber(nu_overlap, T_g)
    B_overlap_star = B_wavenumber(nu_overlap, T_star)
    n_planet_overlap = (1 - B_planet.sum()
                        / (B_planet.sum() + B_overlap_planet.sum())) \
        * n_nu_bands / 2
    n_star_overlap = (1 - (B_star.sum()
                           / (B_star.sum() + B_overlap_star.sum()))) \
        * n_nu_bands / 2
    n_overlap = ceil(n_planet_overlap + n_star_overlap)
    n_lw = ceil(n_nu_bands / 2 - n_planet_overlap)
    n_sw = n_nu_bands - n_lw - n_overlap
    bands_lw = get_equal_bands(nu_lw_only, B_planet, n_lw)
    bands_sw = get_equal_bands(nu_sw, B_star, n_sw)

    # overlap: blend both spectra into a monotone-increasing proxy
    # (real_gas.py:374-381)
    B_op = B_overlap_planet / B_planet.max()
    B_os = B_overlap_star / B_star.max()
    if B_os.max() == 1 or B_op.max() == 1:
        raise ValueError('Peak of planet or star spectrum is in overlap region')
    B_overlap = B_op + B_os[0] - (B_os - B_os[0])
    bands_overlap = get_equal_bands(nu_overlap, B_overlap, n_overlap)

    bands = {'range': bands_lw['range'] + bands_overlap['range']
             + bands_sw['range'],
             'centre': np.concatenate((bands_lw['centre'],
                                       bands_overlap['centre'],
                                       bands_sw['centre'])),
             'delta': np.concatenate((bands_lw['delta'],
                                      bands_overlap['delta'],
                                      bands_sw['delta'])),
             'sw': np.ones(n_nu_bands, dtype=bool)}
    bands['sw'][bands['centre'] <= nu_sw.min()] = False
    return bands
