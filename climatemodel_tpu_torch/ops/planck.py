"""Planck functions (port of ``climatemodel_tpu/ops/planck.py``; reference
real_gas.py:14-42 of the NumPy original).

The reference forms 2 h f^3 / c^2 directly; f^3 ~ 1e46 overflows float32,
so the constants are grouped as ((2h/c^2)^(1/3) f)^3 and the denominator is
an expm1: identical in exact arithmetic, finite in f32, where deep-Wien
wavenumbers round gracefully to B = 0 (x / inf).

Both functions take NumPy or torch: a NumPy (or Python number) argument
stays float64 on the host, where the grids and bands are built; a tensor
stays on its device in its dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import h_planck, k_boltzmann, speed_of_light

_CBRT_2H_OVER_C2 = float((2.0 * h_planck / speed_of_light ** 2) ** (1.0 / 3.0))
# per-wavenumber (cm^-1) constants: B_nu = ((c1 nu)^3) / expm1(c2 nu / T)
_C1 = float((2.0e8 * h_planck * speed_of_light ** 2) ** (1.0 / 3.0))
_C2 = float(100.0 * h_planck * speed_of_light / k_boltzmann)


def _planck(c1, x, u, T):
    """(c1 x)^3 / expm1(u), in torch if ``x`` or ``T`` is a tensor, else in
    NumPy float64 (an overflowing expm1 gives B = 0 quietly)."""
    if torch.is_tensor(x) or torch.is_tensor(T):
        return (c1 * x) ** 3 / torch.expm1(u)
    with np.errstate(over='ignore'):
        return (c1 * x) ** 3 / np.expm1(u)


def B_freq(freq, T):
    """Planck spectral radiance per frequency: sigma T^4 = integral(pi B df)."""
    return _planck(_CBRT_2H_OVER_C2, freq,
                   h_planck * freq / (k_boltzmann * T), T)


def B_wavenumber(nu, T):
    """Planck spectral radiance per wavenumber (cm^-1):
    sigma T^4 = integral(pi B dnu)."""
    return _planck(_C1, nu, _C2 * nu / T, T)
