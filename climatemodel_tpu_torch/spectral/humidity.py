"""Specific-humidity q(p) profiles for each radiatively active gas (port of
``climatemodel_tpu/spectral/humidity.py``; reference
real_gas_data/specific_humidity.py of the NumPy original).

q = rho_molecule / rho_air at each pressure level, with typical-Earth
profiles digitised from Solomon, "Whole Atmosphere Climate Change" (Fig. 1
red/2003 curves; Fig. 4 for the altitude<->pressure map).  Host NumPy
float64: the real-gas model evaluates them only while it builds its grids
and optical depths, so they give the JAX package's values bit for bit.
"""
from __future__ import annotations

import math

import numpy as np

from ..constants import p_surface_earth

M_air = 28.97                      # molar mass of air (g/mol)
temp_kelvin_to_celsius = 273.15


def p_altitude_convert(altitude=None, p=None):
    """Two-segment log-p <-> altitude map, 90 km break
    (specific_humidity.py:21-48)."""
    h1, p1_log = 0.0, math.log10(p_surface_earth)
    h2, p2_log = 90000.0, -1.0
    h3, p3_log = 130000.0, -3.0
    grad1 = (p2_log - p1_log) / (h2 - h1)
    grad2 = (p3_log - p2_log) / (h3 - h2)
    if p is None:
        log_p = np.where(altitude <= h2, p1_log + grad1 * altitude,
                         p2_log + grad2 * (altitude - h2))
        return 10.0 ** log_p
    log_p = np.log10(p)
    return np.where(log_p >= p2_log, (log_p - p1_log) / grad1,
                    (log_p - p2_log) / grad2 + h2)


def humidity_from_ppmv(conc_ppmv, molecule_name):
    """ppmv -> specific humidity kg/kg (specific_humidity.py:51-59)."""
    return conc_ppmv / 1e6 * molecules[molecule_name]['M'] / M_air


def ppmv_from_humidity(humidity, molecule_name):
    """specific humidity -> ppmv (specific_humidity.py:62-70)."""
    return humidity * 1e6 * M_air / molecules[molecule_name]['M']


def _interp(x, xs, ys):
    return np.interp(x, np.asarray(xs), np.asarray(ys))


def co2(p, q_surface=370, h_change=80000):
    """Constant below h_change, linear fall-off above (specific_humidity.py:73-96)."""
    if q_surface == 0:
        return np.zeros_like(p)
    h = p_altitude_convert(p=p)
    h_toa, q_toa = 120000.0, 60.0
    gradient = (q_surface - q_toa) / (h_change - h_toa)
    intercept = q_surface - gradient * h_change
    q = np.where(h > h_change, intercept + gradient * h,
                 np.full_like(np.asarray(p, dtype=float), q_surface))
    q = np.maximum(q, 0.0)
    return humidity_from_ppmv(q, 'CO2')


_CH4_H = np.array([0, 10, 17, 22, 28, 50, 68, 80, 90], dtype=float) * 1000
_CH4_Q = np.array([1.75, 1.75, 1.68, 1.32, 1.19, 0.4, 0.19, 0.04, 0])


def ch4(p, scale_factor=1):
    """Tabulated CH4 profile (specific_humidity.py:99-127): surface value
    scaled, capped at the (scaled) surface value, zero above 90 km."""
    if scale_factor == 0:
        return np.zeros_like(p)
    q_values = _CH4_Q * scale_factor
    q_values[1] = q_values[0]
    q_values = np.minimum(q_values, q_values[0])
    h = p_altitude_convert(p=p)
    q = np.where(h < _CH4_H.max(), _interp(h, _CH4_H, q_values), 0.0)
    q = np.maximum(q, 0.0)
    return humidity_from_ppmv(q, 'CH4')


_H2O_H = np.arange(0, 90, 5, dtype=float) * 1000
_H2O_Q = np.array([20000, 2500, 250, 12, 4, 4.3, 4.9, 5.1, 5.7, 5.9, 6, 6.1,
                   6, 5.8, 5, 4, 2.5, 1], dtype=float)


def h2o(p, scale_factor=1):
    """Log-interpolated H2O profile, scaled (specific_humidity.py:130-155)."""
    if scale_factor == 0:
        return np.zeros_like(p)
    h = p_altitude_convert(p=p)
    q = np.where(h < _H2O_H.max(),
                 10.0 ** _interp(h, _H2O_H, np.log10(_H2O_Q)), 0.0)
    return humidity_from_ppmv(q, 'H2O') * scale_factor


_O3_H = np.sort(np.concatenate((np.arange(0, 125, 5),
                                np.array([32, 78, 92])))) * 1000.0
_O3_Q = np.array([0.05, 0.07, 0.09, 0.25, 1.8, 5.25, 7.8, 7.9, 7.85, 6, 3.8,
                  2.4, 1.6, 1, 0.75, 0.3, 0.15, 0.1, 0.15, 0.8, 1.75, 1.8,
                  1.7, 1, 0.3, 0.07, 0.05, 0])


def o3(p, scale_factor=1):
    """Stratospheric-peak O3 profile (specific_humidity.py:158-182)."""
    if scale_factor == 0:
        return np.zeros_like(p)
    h = p_altitude_convert(p=p)
    q = np.where(h < _O3_H.max(), _interp(h, _O3_H, _O3_Q * scale_factor), 0.0)
    q = np.maximum(q, 0.0)
    return humidity_from_ppmv(q, 'O3')


def constant_q(p, q_surface, molecule_name):
    """Same ppmv everywhere (specific_humidity.py:185-196)."""
    return humidity_from_ppmv(np.full_like(np.asarray(p, dtype=float),
                                           q_surface), molecule_name.upper())


def gradient_q(p, q_sfc, q_upper, h_upper, molecule_name='CO2'):
    """Linear-in-height ppmv from q_sfc to q_upper at h_upper, constant above
    (specific_humidity.py:198-216)."""
    h = p_altitude_convert(p=p)
    q = np.where(h >= h_upper, q_upper,
                 q_sfc + h * (q_upper - q_sfc) / h_upper)
    return humidity_from_ppmv(q, molecule_name.upper())


def saturation_vapor_pressure(temp):
    """Bolton 1980 eq. 10, Pa (specific_humidity.py:219-238)."""
    t = temp - temp_kelvin_to_celsius
    return 611.2 * np.exp(17.67 * t / (t + 243.5))


def constant_rh(p, temp_func, rh=0.7, h_upper=None, molecule_name='H2O'):
    """Constant relative humidity given a T(p) profile
    (specific_humidity.py:241-258)."""
    vap = rh * saturation_vapor_pressure(temp_func(p))
    conc_ppmv = vap / p * 1e6
    if h_upper is not None:
        h = p_altitude_convert(p=p)
        conc_ppmv = np.where(h >= h_upper, 0.0, conc_ppmv)
    return humidity_from_ppmv(conc_ppmv, molecule_name.upper())


# HITRAN ids, molar masses (g/mol), default q profiles
# (specific_humidity.py:262-266)
molecules = {
    'H2O': {'hitran_id': 1, 'M': 18, 'q': h2o, 'q_args': (1,)},
    'CO2': {'hitran_id': 2, 'M': 44, 'q': co2, 'q_args': (370, 80000)},
    'O3': {'hitran_id': 3, 'M': 48, 'q': o3, 'q_args': (1,)},
    'CH4': {'hitran_id': 6, 'M': 16, 'q': ch4, 'q_args': (1,)},
    'CFC12': {'hitran_id': 10, 'M': 120.91, 'q': o3, 'q_args': (1,)},
}
# alias for the shipped no-shortwave CO2 lookup table (same molecule)
molecules['CO2_NO_SW'] = molecules['CO2']
