"""Ice-albedo feedback hysteresis sweep (port of
``climatemodel_tpu/models/ice_albedo.py``; reference
``ice_albedo_feedback.py:13-232`` of the NumPy original).

A latitude-grid grey-gas world is marched to equilibrium at a sequence of
forcings (surface long-wave optical depth or stellar constant) ordered
warm -> cold -> warm, with a temperature-dependent step-function albedo
ramped in increments and re-equilibrated until self-consistent.  The
warm-start chaining makes the sweep sequential by physics (hysteresis);
each equilibrium marches all latitudes together on the world's device, with
one dt shared across them, as the reference does.  ``plot`` draws the
hysteresis loop on the host with matplotlib.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

from ..constants import p_surface_earth, p_toa_earth
from .grey import GreyGas


def albedo_step_function(latitude, T_surface=None, albedo_no_ice=0.3,
                         albedo_ice=0.6, T_ice=263):
    """Step-function albedo: icy (high albedo) at or below T_ice
    (ice_albedo_feedback.py:13-37)."""
    albedo = np.ones_like(np.asarray(latitude, dtype=np.float64)) * albedo_no_ice
    if T_surface is not None:
        albedo[np.asarray(T_surface) <= T_ice] = albedo_ice
    return albedo


def nearest_value_in_array(array, value):
    """The element of array closest to value (ice_albedo_feedback.py:9-13)."""
    array = np.asarray(array)
    return array[np.abs(array - value).argmin()]


class GreyAlbedoFeedback:
    """Hysteresis sweep over tau_lw_surface or F_stellar
    (ice_albedo_feedback.py:40-201), on ``device`` (the card unless the
    caller names another) in ``dtype``."""

    def __init__(self, tau_lw_surface_values, stellar_constant_values, nz, ny,
                 tau_lw_func, tau_lw_func_args, tau_sw_func=None,
                 tau_sw_func_args=None, albedo=albedo_step_function,
                 p_surface=p_surface_earth, p_toa=p_toa_earth,
                 dtype=torch.float32, device='cuda'):
        sig = inspect.signature(albedo)
        self.albedo_function = albedo
        self.albedo_no_ice = sig.parameters['albedo_no_ice'].default
        self.albedo_ice = sig.parameters['albedo_ice'].default
        self.T_ice = sig.parameters['T_ice'].default

        if (np.size(tau_lw_surface_values) > 1
                and np.size(stellar_constant_values) == 1):
            self.changing_param = 'tau'
        elif (np.size(stellar_constant_values) > 1
              and np.size(tau_lw_surface_values) == 1):
            self.changing_param = 'stellar'
        else:
            raise ValueError('Must have either tau_lw_surface_values or '
                             'stellar_constant_values be varying and the other '
                             'constant')

        # warmest first, down to coldest, back up: hysteresis ordering
        # (ice_albedo_feedback.py:99-108)
        if self.changing_param == 'tau':
            vals = np.sort(np.asarray(tau_lw_surface_values, dtype=np.float64))
            self.changing_param_values = np.concatenate((vals[::-1], vals[1:]))
            F_stellar_constant = float(
                np.asarray(stellar_constant_values, np.float64).ravel()[0])
            self.tau_args = list(tau_lw_func_args)
            self.tau_args[1] = self.changing_param_values[0]
            lw_args = self.tau_args
        else:
            vals = np.sort(np.asarray(stellar_constant_values,
                                      dtype=np.float64))
            self.changing_param_values = np.concatenate((vals[::-1], vals[1:]))
            F_stellar_constant = self.changing_param_values[0]
            lw_args = tau_lw_func_args

        # start ice-free: the warmest scenario is assumed unfrozen
        self.grey_world = GreyGas(nz, ny, tau_lw_func, lw_args, tau_sw_func,
                                  tau_sw_func_args, float(F_stellar_constant),
                                  self.albedo_no_ice, p_surface=p_surface,
                                  p_toa=p_toa, dtype=dtype, device=device)

        # plotting latitudes including the equator
        # (ice_albedo_feedback.py:116-124)
        lat = self.grey_world.latitude
        if 0 in lat:
            self.latitude_plot = lat
        else:
            mid = 0.5 * (lat[:-1] + lat[1:])
            self.latitude_plot = np.sort(np.concatenate((mid, [0.0])))

    def update_albedo(self, delta_albedo=0.1, delta_net_flux_thresh=1e-3,
                      conv_adjust=False, max_ramp_iterations=200):
        """Equilibrate, re-derive albedo from surface temperature, and ramp
        the changed latitudes in delta_albedo increments, re-equilibrating
        each ramp step (ice_albedo_feedback.py:127-158).

        The reference's ramp loop can cycle forever when a latitude's
        surface temperature oscillates across T_ice between ramp steps
        (ice_albedo_feedback.py:152-158 has no exit);
        ``max_ramp_iterations`` bounds it and raises instead (a deliberate
        divergence, as in the JAX package).
        """
        world = self.grey_world
        march_kw = dict(flux_thresh=delta_net_flux_thresh, save=False,
                        convective_adjust=conv_adjust)
        albedo_last = world.albedo.copy()
        world.evolve_to_equilibrium(**march_kw)
        albedo_new = self.albedo_function(world.latitude, world.T[0, :])
        to_update = np.where(albedo_last != albedo_new)[0]
        ramp = np.sign(albedo_new - albedo_last)[to_update] * delta_albedo
        iterations = 0
        while len(to_update) > 0:
            if iterations >= max_ramp_iterations:
                raise RuntimeError(
                    f'albedo ramp did not converge after {iterations} '
                    f'iterations; latitudes {to_update.tolist()} keep '
                    'oscillating across T_ice (raise max_ramp_iterations or '
                    'loosen delta_albedo)')
            # in place: with no sw absorber the world reads albedo_mod from
            # this array (the reference's aliasing, grey.py:91-96)
            world.albedo[to_update] = np.clip(world.albedo[to_update] + ramp,
                                              self.albedo_no_ice,
                                              self.albedo_ice)
            world.evolve_to_equilibrium(**march_kw)
            to_update = np.where(world.albedo != albedo_new)[0]
            ramp = np.sign(albedo_new - world.albedo)[to_update] * delta_albedo
            iterations += 1

    def run(self, delta_albedo=0.1, delta_net_flux_thresh=1e-3,
            conv_adjust=False, progress=False):
        """Sweep all forcing values, recording albedo, ice-edge latitude and
        surface temperature (ice_albedo_feedback.py:160-201)."""
        albedo_array, ice_latitude, T_surface = [], [], []
        values = self.changing_param_values
        iterator = range(len(values))
        if progress:
            try:
                from tqdm import tqdm
                iterator = tqdm(iterator)
            except ImportError:
                pass
        for i in iterator:
            if self.changing_param == 'tau':
                self.tau_args[1] = values[i]
                self.grey_world.tau_lw_func_args = tuple(self.tau_args)
                self.grey_world.update_grid()
            else:
                self.grey_world.F_stellar_constant = float(values[i])
            self.update_albedo(delta_albedo, delta_net_flux_thresh,
                               conv_adjust)
            albedo_array.append(self.grey_world.albedo.copy())
            icy = np.abs(self.latitude_plot)[
                self.grey_world.albedo == self.albedo_ice]
            ice_latitude.append(float(np.min(np.concatenate((icy, [90.0])))))
            T_surface.append(self.grey_world.T[0, :].copy())
        return albedo_array, ice_latitude, T_surface

    def plot(self, ice_latitude, T_surface, T_latitude=52.4):
        """Hysteresis plot: cooling vs warming branches
        (ice_albedo_feedback.py:203-232)."""
        import matplotlib.pyplot as plt
        T_latitude = nearest_value_in_array(self.grey_world.latitude, T_latitude)
        lat_index = int(np.where(self.grey_world.latitude == T_latitude)[0][0])
        T_surface = np.asarray(T_surface)
        ice_latitude = np.asarray(ice_latitude)
        vals = self.changing_param_values
        cool = np.arange(vals.argmin() + 1)
        warm = np.arange(vals.argmin(), len(vals))
        fig, axs = plt.subplots(2, 1, sharex=True, figsize=(10, 10))
        axs[0].plot(vals[cool], ice_latitude[cool], color='red', label='cooling')
        axs[0].plot(vals[warm], ice_latitude[warm], color='blue', label='warming')
        axs[0].legend()
        axs[0].set_ylabel('Ice edge latitude')
        axs[0].set_ylim((-5, 95))
        axs[1].plot(vals[cool], T_surface[cool, lat_index], color='red')
        axs[1].plot(vals[warm], T_surface[warm, lat_index], color='blue')
        axs[1].axhline(y=self.T_ice, color='k', linestyle=':', label=r'$T_{ice}$')
        axs[1].legend()
        axs[1].set_ylabel(f'$T_{{surface}}$ (K) at {round(T_latitude)}'
                          r'$^{\circ}$ latitude')
        xlab = (r'Long Wave Surface Optical Depth, $\tau_{lw, surface}$'
                if self.changing_param == 'tau'
                else r'Stellar Constant, $F^{\odot}$ (Wm$^{-2}$)')
        axs[1].set_xlabel(xlab)
        return fig
