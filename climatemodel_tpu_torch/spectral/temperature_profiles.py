"""Fixed T(p) profiles for diagnostic (fixed-dynamics) real-gas runs (port
of ``climatemodel_tpu/spectral/temperature_profiles.py``; reference
real_gas_data/temperature_profiles.py of the NumPy original, the earth
profile digitised from Solomon Fig. 3a).  Host NumPy float64.
"""
from __future__ import annotations

import numpy as np

from .humidity import p_altitude_convert

_EARTH_H = np.array([0, 12, 19, 21, 30, 40, 46, 50, 70, 79, 81, 88, 99, 140],
                    dtype=float) * 1000
_EARTH_T = np.array([288, 210, 205, 215, 226, 250, 260, 260, 210, 199, 199,
                     202, 195, 610], dtype=float)


def earth_temp(p):
    """US-standard-like Earth profile incl. 610 K thermosphere
    (temperature_profiles.py:16-28)."""
    h = p_altitude_convert(p=p)
    return np.where(h <= _EARTH_H[-1],
                    np.interp(h, np.asarray(_EARTH_H), np.asarray(_EARTH_T)),
                    _EARTH_T[-1])


def fixed_tropopause_temp(p, h_tropopause=19, T_tropopause=205, T_ground=288):
    """Troposphere then isothermal at the tropopause temperature
    (temperature_profiles.py:31-46)."""
    h_values = np.array([0.0, h_tropopause, 140.0]) * 1000
    T_values = np.array([T_ground, T_tropopause, T_tropopause], dtype=float)
    h = p_altitude_convert(p=p)
    return np.where(h <= h_values[-1],
                    np.interp(h, np.asarray(h_values), np.asarray(T_values)),
                    T_values[-1])


def two_lapse_temp(p, h_tropopause=10, h_top=20, T_ground=288, lapse_trop=9,
                   lapse_strat=0):
    """Two linear lapse rates then isothermal (temperature_profiles.py:49-59)."""
    h_values = np.array([0.0, h_tropopause, h_top]) * 1000
    T_tropopause = T_ground - h_tropopause * lapse_trop
    T_top = T_tropopause - (h_top - h_tropopause) * lapse_strat
    T_values = np.array([T_ground, T_tropopause, T_top], dtype=float)
    h = p_altitude_convert(p=p)
    return np.where(h <= h_values[-1],
                    np.interp(h, np.asarray(h_values), np.asarray(T_values)),
                    T_values[-1])
