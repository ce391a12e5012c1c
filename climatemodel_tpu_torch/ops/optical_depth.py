"""Analytic grey-gas optical-depth profile families.

Re-implements the four tau(p) / q(p) families of the reference
(grey_optical_depth.py of the NumPy original) with hand-derived closed forms
instead of sympy symbolic calculus, so every profile is a pure function of
pressure and a small parameter vector — the same closed forms as
``climatemodel_tpu/ops/optical_depth.py``.  The defining relation is

    dtau = k * q * dp / g          =>   q = (g / k) * dtau/dp

(grey_optical_depth.py:6-20).  Each family keeps the reference's canonical
parameterisation so analytic equilibrium solutions and tests line up 1:1:

  scale_height                      tau = tau_s * (p / p_s)^(alpha+1)
  exponential                       tau = coef * (exp(alpha p) - 1)
  peak_in_atmosphere                piecewise exp about p_max
  scale_height_and_peak_in_atmosphere   sum of the first and third

All functions accept NumPy arrays or torch tensors for ``p``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import g, p_surface_earth


class _TorchNamespace:
    """The few NumPy functions the profile families call, for tensors: the
    scalar arguments stay Python floats, the tensor ones go to torch."""

    @staticmethod
    def exp(x):
        return torch.exp(x) if torch.is_tensor(x) else math.exp(x)

    @staticmethod
    def log(x):
        return torch.log(x) if torch.is_tensor(x) else math.log(x)

    @staticmethod
    def minimum(x, bound):
        return torch.clamp(x, max=bound)

    where = staticmethod(torch.where)


def _ns(x):
    """Array namespace of the argument: host NumPy stays NumPy (float64 grid
    building must not round-trip through a float32 tensor), tensors use
    torch."""
    if isinstance(x, (np.ndarray, np.generic, float, int)):
        return np
    return _TorchNamespace


# --------------------------------------------------------------------------
# alpha parameter converters (grey_optical_depth.py:28-106)
# --------------------------------------------------------------------------

def get_scale_height_alpha(p_width: float, p_surface: float) -> float:
    """alpha for the scale_height profile: larger alpha => q more peaked at surface.

    Reference: grey_optical_depth.py:28-44.
    """
    p_fall_value = p_surface - p_width
    if p_fall_value > p_surface:
        raise ValueError('p_fall_value is above p_max')
    if p_fall_value == 0:
        return 0.0
    return -1.0 / math.log(p_fall_value / p_surface)


def get_exponential_p_width(alpha: float) -> float:
    """Inverse of get_exponential_alpha (grey_optical_depth.py:79-90)."""
    return 1.0 / alpha


def get_exponential_alpha(p_width: float, p_max: float = p_surface_earth) -> float:
    """alpha for the exponential/peaked profiles (grey_optical_depth.py:93-106)."""
    p_fall_value = p_max - p_width
    if p_fall_value > p_max:
        raise ValueError('p_fall_value is larger than p_max')
    return 1.0 / (p_max - p_fall_value)


# --------------------------------------------------------------------------
# Profile object
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GreyOpticalDepth:
    """A grey optical-depth profile: callable tau(p), q(p), dtau/dp(p).

    Mirrors the reference convention where every tau function returns
    (q, tau, sympy_func, params) (grey_optical_depth.py:1-5); here ``params`` is
    the same canonical parameter list and the callables are closed forms.
    """
    name: str
    args: Tuple[float, ...]          # user-facing args (reference arg order, no p)
    params: Tuple[float, ...]        # canonical params (reference 4th return value)
    p_surface: float
    k: float
    _tau: Callable
    _dtau_dp: Callable
    _p_from_tau: Optional[Callable] = None

    def tau(self, p):
        return self._tau(p)

    def dtau_dp(self, p):
        return self._dtau_dp(p)

    def q(self, p):
        """Mass concentration of the absorber: q = (g/k) dtau/dp."""
        return (g / self.k) * self._dtau_dp(p)

    def p_from_tau(self, tau):
        if self._p_from_tau is None:
            raise NotImplementedError(f'p_from_tau not available for {self.name}')
        return self._p_from_tau(tau)

    @property
    def is_zero(self) -> bool:
        """True if any arg is 0 => profile treated as no absorber.

        Matches ``tau_sw_func_args.count(0) > 0`` at grey.py:81.
        """
        return any(a == 0 for a in self.args)

    def __call__(self, p):
        """Reference-style call: returns (q, tau)."""
        return self.q(p), self.tau(p)


# --------------------------------------------------------------------------
# Families
# --------------------------------------------------------------------------

def scale_height(p_width: float = 0.22 * p_surface_earth, tau_surface: float = 4.0,
                 p_surface: float = p_surface_earth, k: float = 1.0) -> GreyOpticalDepth:
    """tau = tau_s (p/p_s)^(alpha+1); absorber scale height H/alpha.

    Reference: grey_optical_depth.py:47-76.
    """
    alpha = get_scale_height_alpha(p_width, p_surface)

    def tau(p):
        return tau_surface * (p / p_surface) ** (alpha + 1.0)

    def dtau_dp(p):
        return tau_surface * (alpha + 1.0) * (p / p_surface) ** alpha / p_surface

    def p_from_tau(t):
        return p_surface * (t / tau_surface) ** (1.0 / (alpha + 1.0))

    return GreyOpticalDepth('scale_height', (p_width, tau_surface, p_surface, k),
                            (tau_surface, alpha), p_surface, k, tau, dtau_dp, p_from_tau)


def exponential(p_width: float = 0.22 * p_surface_earth, tau_surface: float = 4.0,
                p_surface: float = p_surface_earth, k: float = 1.0) -> GreyOpticalDepth:
    """tau = coef (exp(alpha p) - 1): admits the closed-form lw+sw equilibrium.

    Reference: grey_optical_depth.py:109-141.
    """
    alpha = get_exponential_alpha(p_width, p_surface)
    coef = tau_surface / (math.exp(alpha * p_surface) - 1.0)

    def tau(p):
        return coef * (_ns(p).exp(alpha * p) - 1.0)

    def dtau_dp(p):
        return coef * alpha * _ns(p).exp(alpha * p)

    def p_from_tau(t):
        return _ns(t).log(t / coef + 1.0) / alpha

    return GreyOpticalDepth('exponential', (p_width, tau_surface, p_surface, k),
                            (coef, alpha), p_surface, k, tau, dtau_dp, p_from_tau)


def peak_in_atmosphere(p_width: float = 10000.0, p_max: float = 50000.0,
                       tau_surface: float = 4.0, p_surface: float = p_surface_earth,
                       k: float = 1.0) -> GreyOpticalDepth:
    """q peaked at p_max, falling as exp(-alpha |p - p_max|) either side.

    Stratosphere/ozone analogue.  Reference: grey_optical_depth.py:144-208.
    """
    alpha = get_exponential_alpha(p_width, p_max)
    coef = tau_surface / (2.0 - math.exp(-alpha * p_max)
                          - math.exp(alpha * (p_max - p_surface)))

    def tau(p):
        xp = _ns(p)
        # exponents clamped at 0: each branch is only selected where its
        # exponent is <= 0, but both branches are evaluated eagerly
        e_below = xp.minimum(alpha * (p - p_max), 0.0)
        e_above = xp.minimum(alpha * (p_max - p), 0.0)
        below = coef * (xp.exp(e_below) - xp.exp(-alpha * p_max))
        above = coef * (2.0 - xp.exp(-alpha * p_max) - xp.exp(e_above))
        return xp.where(p <= p_max, below, above)

    def dtau_dp(p):
        xp = _ns(p)
        below = coef * alpha * xp.exp(xp.minimum(alpha * (p - p_max), 0.0))
        above = coef * alpha * xp.exp(xp.minimum(alpha * (p_max - p), 0.0))
        return xp.where(p <= p_max, below, above)

    def p_from_tau(t):
        xp = _ns(t)
        tau_thresh = coef * (1.0 - math.exp(-alpha * p_max))  # tau at p = p_max
        below = p_max + xp.log(t / coef + math.exp(-alpha * p_max)) / alpha
        above = p_max - xp.log(2.0 - math.exp(-alpha * p_max) - t / coef) / alpha
        return xp.where(t <= tau_thresh, below, above)

    return GreyOpticalDepth('peak_in_atmosphere', (p_width, p_max, tau_surface, p_surface, k),
                            (coef, alpha, p_max), p_surface, k, tau, dtau_dp, p_from_tau)


def scale_height_and_peak_in_atmosphere(
        p_width1: float = 0.7788 * p_surface_earth, tau_surface1: float = 4.0,
        p_width2: float = 10000.0, p_max2: float = 50000.0, tau_surface2: float = 4.0,
        p_surface: float = p_surface_earth, k: float = 1.0) -> GreyOpticalDepth:
    """Sum of scale_height and peak_in_atmosphere (meso/thermosphere worlds).

    Reference: grey_optical_depth.py:211-300.  Note the reference's symbolic
    p(tau) inversion for this family deliberately drops the peak term
    ("HACK", grey_optical_depth.py:250-260); we reproduce that behaviour in
    ``p_from_tau`` for parity, while ``tau``/``q`` use the correct sum.
    """
    alpha1 = get_scale_height_alpha(p_width1, p_surface)
    alpha2 = get_exponential_alpha(p_width2, p_max2)
    coef2 = tau_surface2 / (2.0 - math.exp(-alpha2 * p_max2)
                            - math.exp(alpha2 * (p_max2 - p_surface)))

    def tau(p):
        xp = _ns(p)
        sh = tau_surface1 * (p / p_surface) ** (alpha1 + 1.0)
        e_below = xp.minimum(alpha2 * (p - p_max2), 0.0)
        e_above = xp.minimum(alpha2 * (p_max2 - p), 0.0)
        below = coef2 * (xp.exp(e_below) - xp.exp(-alpha2 * p_max2))
        above = coef2 * (2.0 - xp.exp(-alpha2 * p_max2) - xp.exp(e_above))
        return sh + xp.where(p <= p_max2, below, above)

    def dtau_dp(p):
        xp = _ns(p)
        sh = tau_surface1 * (alpha1 + 1.0) * (p / p_surface) ** alpha1 / p_surface
        below = coef2 * alpha2 * xp.exp(xp.minimum(alpha2 * (p - p_max2), 0.0))
        above = coef2 * alpha2 * xp.exp(xp.minimum(alpha2 * (p_max2 - p), 0.0))
        return sh + xp.where(p <= p_max2, below, above)

    def p_from_tau(t):
        # scale-height-only inversion, as in the reference HACK.
        return p_surface * (t / tau_surface1) ** (1.0 / (alpha1 + 1.0))

    return GreyOpticalDepth(
        'scale_height_and_peak_in_atmosphere',
        (p_width1, tau_surface1, p_width2, p_max2, tau_surface2, p_surface, k),
        (tau_surface1, alpha1, coef2, alpha2, p_max2), p_surface, k,
        tau, dtau_dp, p_from_tau)


# --------------------------------------------------------------------------
# Registry + reference-style (func, args) construction
# --------------------------------------------------------------------------

PROFILES = {
    'scale_height': scale_height,
    'exponential': exponential,
    'peak_in_atmosphere': peak_in_atmosphere,
    'scale_height_and_peak_in_atmosphere': scale_height_and_peak_in_atmosphere,
}

# index of the p_surface argument in each family's signature (after p is dropped)
_P_SURFACE_ARG = {
    'scale_height': 2,
    'exponential': 2,
    'peak_in_atmosphere': 3,
    'scale_height_and_peak_in_atmosphere': 5,
}


def make_profile(name: str, args: Sequence[float], p_surface: float) -> GreyOpticalDepth:
    """Build a profile from a reference-style (func_name, leading-args) pair,
    pinning the p_surface argument to the model's surface pressure.

    Mirrors GreyGas.ensure_p_surface_correct_in_tau_func (grey.py:108-127): the
    provided ``args`` override the leading defaults, then p_surface is forced.
    """
    if callable(name):           # accept the profile constructor itself
        name = name.__name__
    func = PROFILES[name]
    defaults = list(func.__defaults__)
    full = defaults
    full[:len(args)] = list(args)
    full[_P_SURFACE_ARG[name]] = p_surface
    return func(*full)
