"""Grey-gas two-stream radiative column model (port of
``climatemodel_tpu/models/grey.py``; reference ``GreyGas``, grey.py:15-504
of the NumPy original).

Grid construction stays host-side float64 NumPy (grey.py:129-249); the
state and forcing are batched tensors on the model's device, with a batch
of one for a single world, so ``GreyGas`` and the ensemble march share
``column.evolve_to_equilibrium``.  Array orientation matches the reference
grey model: level index 0 = surface, nz-1 = top of atmosphere.

Everything is ported: the constructor, grids and ``update_grid``, the
forcing, the state views, ``take_time_step``, ``save_data``,
``evolve_to_equilibrium`` with its snapshot march (``save=True``), chunks,
exit cadences and debug checks, ``equilibrium_sol``, the closed-form
:class:`GreySwEquilibrium` and the host plot ``plot_eqb``.
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from ..constants import (F_sun, SECONDS_PER_YEAR, p_surface_earth,
                         p_toa_earth, sigma)
from ..ops import optical_depth as od
from ..ops.convection import convective_adjustment
from ..ops.two_stream import lw_flux, sw_flux
from ..utils import grids
from . import column
from .column import (ColumnState, TensorStruct, get_isothermal_temp,
                     init_time_step_info, latitudinal_solar_distribution)


@dataclasses.dataclass
class GreyForcing(TensorStruct):
    """Inputs of the grey radiation step, batched over members."""
    dtau: torch.Tensor                 # [B, nz-1, ny] |d tau_lw| across cells
    tau_sw_interface: torch.Tensor     # [B, nz, ny] short-wave optical depth
    albedo_mod: torch.Tensor           # [B, ny] albedo * exp(-2 tau_sw_surface)
    solar_latitude_factor: torch.Tensor  # [B, ny]
    F_stellar: torch.Tensor            # [B] stellar constant (W/m^2)


def up_flux_toa(forcing: GreyForcing):
    """[B, ny] TOA upward lw boundary condition: the net absorbed stellar
    flux (grey.py:265)."""
    return (1.0 - forcing.albedo_mod) * forcing.solar_latitude_factor * \
        forcing.F_stellar[:, None] / 4.0


def grey_sw_fluxes(forcing: GreyForcing):
    """(up_sw, down_sw) [B, nz, ny]: T-independent, hoisted out of marches."""
    return sw_flux(forcing.tau_sw_interface, forcing.albedo_mod,
                   forcing.solar_latitude_factor, forcing.F_stellar[:, None])


def grey_fluxes(T, forcing: GreyForcing):
    """All four interface flux arrays [B, nz, ny] from cell temperatures
    [B, nz-1, ny] (grey.py:251-294)."""
    up_lw, down_lw = lw_flux(T.movedim(0, 1), forcing.dtau.movedim(0, 1),
                             up_flux_toa(forcing), surface_first=True)
    up_sw, down_sw = grey_sw_fluxes(forcing)
    return up_lw.movedim(1, 0), down_lw.movedim(1, 0), up_sw, down_sw


def grey_net_flux_fn(forcing: GreyForcing):
    """The net upward flux at every interface, up_lw - down_lw + up_sw -
    down_sw (grey.py:296-300), as a function of the cell temperatures
    [B, nz-1, ny] alone: the T-independent sw fluxes and TOA boundary are
    computed once, for every step of a march."""
    up_toa = up_flux_toa(forcing)
    up_sw, down_sw = grey_sw_fluxes(forcing)

    def net_fn(T):
        up_lw, down_lw = lw_flux(T.movedim(0, 1), forcing.dtau.movedim(0, 1),
                                 up_toa, surface_first=True)
        return up_lw.movedim(1, 0) - down_lw.movedim(1, 0) + up_sw - down_sw
    return net_fn


def grey_net_flux(T, forcing: GreyForcing):
    """Net upward flux at every interface (:func:`grey_net_flux_fn` of one
    temperature field)."""
    return grey_net_flux_fn(forcing)(T)


class GreyGas:
    """User-facing grey-gas column model mirroring the reference state API
    (grey.py:17-106): same constructor vocabulary, same attribute names,
    plus the ``device`` the state and forcing live on — the card unless the
    caller names another (``device='cpu'``)."""

    def __init__(self, nz, ny, tau_lw_func, tau_lw_func_args, tau_sw_func=None,
                 tau_sw_func_args=None, F_stellar_constant=F_sun, albedo=0.3,
                 temp_change=1.0, delta_temp_change=0.01,
                 p_surface=p_surface_earth, p_toa=p_toa_earth,
                 dtype=torch.float32, device='cuda'):
        self.ny = int(ny)
        self.p_surface = float(p_surface)
        self.p_toa = float(p_toa)
        self.F_stellar_constant = float(F_stellar_constant)
        self.temp_change = float(temp_change)
        self.delta_temp_change = float(delta_temp_change)
        self.dtype = dtype
        self.device = torch.device(device)

        self.latitude = np.linspace(-90, 90, self.ny)
        if callable(albedo):                      # base.py:111-117
            self.albedo = np.asarray(albedo(self.latitude), dtype=np.float64)
        else:
            self.albedo = np.broadcast_to(np.asarray(albedo, np.float64),
                                          (self.ny,)).copy()
        self.solar_latitude_factor = np.asarray(
            latitudinal_solar_distribution(self.latitude), np.float64)
        self.T0 = get_isothermal_temp(self.albedo, self.F_stellar_constant,
                                      self.latitude)

        # tau profiles with p_surface pinned (grey.py:108-127)
        self.tau_lw_func = tau_lw_func
        self.tau_lw_func_args = tuple(tau_lw_func_args)
        self.tau_sw_func = tau_sw_func
        self.tau_sw_func_args = tuple(tau_sw_func_args) if tau_sw_func_args else None
        self._build_profiles()

        # pressure grid: host-side, frozen shapes (grey.py:129-249)
        p_col, self.nz = grids.grey_p_grid(
            self._lw, self._sw if not self.sw_tau_is_zero else None, nz,
            p_surface=self.p_surface, p_toa=self.p_toa)
        self.p_interface = np.tile(p_col[:, None], (1, self.ny))
        self.p = grids.cell_centre_pressure(self.p_interface)
        self._refresh_tau_grids()

        # albedo_mod is FROZEN at construction when an sw absorber is present
        # (reference semantics, grey.py:91-96: set once in __init__ and never
        # recomputed by update_grid).  Without an absorber the reference
        # ALIASES albedo_mod to the albedo array, so in-place albedo
        # mutations propagate — the property returns self.albedo live.
        self._albedo_mod_frozen = (
            None if self.sw_tau_is_zero
            else self.albedo * np.exp(-2 * self.tau_sw_interface[0]))

        # initial condition: isothermal energy balance (grey.py:98-105)
        T = np.ones((self.nz - 1, self.ny)) * self.T0
        up_lw = np.ones((self.nz, self.ny)) * self.F_sw0
        down_lw = np.zeros((self.nz, self.ny))
        shape = self.tau_sw_interface.shape
        up_sw = np.broadcast_to(self.albedo_mod * self.solar_latitude_factor
                                * self.F_stellar_constant / 4.0, shape)
        down_sw = np.broadcast_to(self.solar_latitude_factor
                                  * self.F_stellar_constant / 4.0, shape)
        net = up_lw - down_lw + up_sw - down_sw
        self._state = ColumnState(
            T=self._tensor(T)[None], net_flux=self._tensor(net)[None],
            t=torch.zeros((1,), dtype=self.dtype, device=self.device),
            tsi=init_time_step_info((self.nz - 1) * self.ny, self.temp_change,
                                    self.delta_temp_change, batch=1,
                                    dtype=self.dtype, device=self.device))
        self._fluxes = tuple(self._tensor(a)[None]
                             for a in (up_lw, down_lw, up_sw, down_sw))
        self._equilibrium_info = None

    def _tensor(self, a):
        return torch.tensor(np.asarray(a), dtype=self.dtype,
                            device=self.device)

    # ---------------- host-side grid/profile management ----------------

    def _build_profiles(self):
        self._lw = od.make_profile(self.tau_lw_func, self.tau_lw_func_args,
                                   self.p_surface)
        if self.tau_sw_func is not None:
            self._sw = od.make_profile(self.tau_sw_func, self.tau_sw_func_args
                                       or (), self.p_surface)
        else:
            self._sw = None
        # expose the pinned full arg tuples like the reference does
        self.tau_lw_func_args = self._lw.args
        if self._sw is not None:
            self.tau_sw_func_args = self._sw.args
        self.sw_tau_is_zero = self._sw is None or self._sw.is_zero  # grey.py:81

    def _refresh_tau_grids(self):
        """(Re)compute tau/q grids on the fixed pressure grid — also the
        ``update_grid`` path for changing forcing (grey.py:346-358)."""
        self.tau_interface = np.asarray(self._lw.tau(self.p_interface))
        self.q = np.asarray(self._lw.q(self.p))
        self.tau = np.asarray(self._lw.tau(self.p))
        self.dtau = np.abs(self.tau_interface[1:] - self.tau_interface[:-1])
        if not self.sw_tau_is_zero:
            self.tau_sw_interface = np.asarray(self._sw.tau(self.p_interface))
            self.q_sw = np.asarray(self._sw.q(self.p))
            self.tau_sw = np.asarray(self._sw.tau(self.p))
        else:
            self.tau_sw_interface = np.zeros_like(self.tau_interface)
            self.q_sw = np.zeros_like(self.q)
            self.tau_sw = np.zeros_like(self.tau)

    def update_grid(self):
        """Re-evaluate tau after mutating tau_*_func_args (grey.py:346-358)."""
        self._build_profiles()
        self._refresh_tau_grids()

    @property
    def albedo_mod(self):
        """Albedo corrected for the missing exp(tau_sw_surface) term
        (grey.py:91-96): frozen at the construction-time tau_sw when an sw
        absorber exists, the live ``albedo`` otherwise."""
        if self._albedo_mod_frozen is not None:
            return self._albedo_mod_frozen
        return self.albedo

    @property
    def F_sw0(self):
        """Net absorbed stellar flux per latitude (grey.py:99)."""
        return (1 - self.albedo_mod) * self.solar_latitude_factor * \
            self.F_stellar_constant / 4

    @property
    def forcing(self) -> GreyForcing:
        """This world's forcing as a batch of one member."""
        return GreyForcing(
            dtau=self._tensor(self.dtau)[None],
            tau_sw_interface=self._tensor(self.tau_sw_interface)[None],
            albedo_mod=self._tensor(self.albedo_mod)[None],
            solar_latitude_factor=self._tensor(self.solar_latitude_factor)[None],
            F_stellar=self._tensor([self.F_stellar_constant]))

    # ---------------- state views (reference attribute parity) ----------------

    @property
    def T(self):
        return self._state.T[0].cpu().numpy()

    @T.setter
    def T(self, value):
        self._state = self._state.replace(T=self._tensor(value)[None])

    @property
    def net_flux(self):
        return self._state.net_flux[0].cpu().numpy()

    @property
    def up_lw_flux(self):
        return self._fluxes[0][0].cpu().numpy()

    @property
    def down_lw_flux(self):
        return self._fluxes[1][0].cpu().numpy()

    @property
    def up_sw_flux(self):
        return self._fluxes[2][0].cpu().numpy()

    @property
    def down_sw_flux(self):
        return self._fluxes[3][0].cpu().numpy()

    @property
    def state(self) -> ColumnState:
        """The batch-of-one march state."""
        return self._state

    # ---------------- stepping ----------------

    def _march_inputs(self, forcing):
        """(net flux function, p_interface, p_centre column) of a march."""
        return (grey_net_flux_fn(forcing), self._tensor(self.p_interface),
                self._tensor(self.p[:, 0]))

    def take_time_step(self, t, T_initial=None, changing_tau=False,
                       convective_adjust=False, net_flux_thresh=1e-7,
                       net_flux_percentile=95, conv_thresh=1e-5,
                       conv_t_multiplier=5, return_dt=False):
        """One time step (grey.py:296-344): the fluxes of the current
        temperature, then the temperature update.  The flux views keep the
        step's starting fluxes, as the reference's do.  Returns (t,
        delta_net_flux), or (t, delta_net_flux, dt) with ``return_dt``."""
        if changing_tau:
            self.update_grid()
        if t == 0 and T_initial is not None:
            self.T = T_initial
        self._state = self._state.replace(
            t=torch.full((1,), float(t), dtype=self.dtype, device=self.device))
        forcing = self.forcing
        fluxes = grey_fluxes(self._state.T, forcing)
        up_lw, down_lw, up_sw, down_sw = fluxes
        conv_kw = (dict(convective_adjust=True,
                        p_centre_col=self._tensor(self.p[:, 0]),
                        conv_thresh=conv_thresh,
                        conv_t_multiplier=conv_t_multiplier)
                   if convective_adjust else {})
        self._state, delta = column.update_temp(
            self._state, up_lw - down_lw + up_sw - down_sw,
            self._tensor(self.p_interface), changing_tau=changing_tau,
            net_flux_thresh=net_flux_thresh,
            net_flux_percentile=net_flux_percentile, **conv_kw)
        self._fluxes = fluxes
        out = (float(self._state.t[0]), float(delta[0]))
        if return_dt:
            return out + (float(self._state.tsi.dt.max()),)
        return out

    def evolve_to_equilibrium(self, data_dict=None, flux_thresh=1e-3,
                              T_initial=None, convective_adjust=False, save=True,
                              t_end=4.0, conv_thresh=1e-5, conv_t_multiplier=5,
                              verbose=False, conv_method='reference',
                              chunk_steps=None, check_every=1,
                              dip_memory=False, debug=False,
                              bake_forcing=False) -> dict:
        """March to equilibrium (base.py:266-335).

        ``save=False`` runs the lock-step march; ``save=True`` runs the
        snapshot march in chunks of ``chunk_steps`` (256 by default) steps
        and appends every step's time and temperature (and the lagged
        fluxes and the tau grids where ``data_dict`` holds 'flux' and
        'tau') to ``data_dict``, as the reference's save_data does.
        data_dict=None restarts the clock (base.py:301-306), so every fresh
        call gets the t=0 forced first step.  Raises like the JAX package on
        a non-finite value, a negative temperature, or the step cap.

        :param convective_adjust: adjust to convective stability every step
            (radiative-convective equilibrium), with ``conv_method``
            'reference' (faithful group blend) or 'isotonic' (the iso_fit
            kernel on the card); ``conv_thresh`` and ``conv_t_multiplier``
            as in ``column.update_temp``.
        :param chunk_steps: with ``save=False``, return to the host every
            this many steps (``verbose`` alone makes it 1000 and prints a
            line a chunk); with ``check_every`` a chunk may run up to
            ``check_every - 1`` steps past its end.
        :param check_every, dip_memory: the exit cadence of the save=False
            march (``column.evolve_to_equilibrium``).
        :param debug: the save=False per-step march with the host-side
            checks of ``column.evolve_to_equilibrium``: a failure raises
            ``column.MarchDebugError`` naming where it first appeared.
        :param bake_forcing: accepted for the JAX package's interface, where
            it compiles the march with the forcing as constants.  Here
            there is no compile to bake into: the march always takes the
            forcing as tensors made once a call, with its T-independent sw
            fluxes computed once, so the flag changes nothing and keeps no
            cache.
        """
        del bake_forcing
        if debug and (save or check_every != 1 or dip_memory):
            raise ValueError('debug=True supports the save=False per-step '
                             'march only (check_every=1, dip_memory=False)')
        t_host = 0.0 if data_dict is None else float(data_dict['t'][-1])
        self._state = self._state.replace(
            t=torch.full((1,), t_host, dtype=self.dtype, device=self.device))
        if T_initial is not None and t_host == 0:
            self.T = T_initial
        if data_dict is None:
            data_dict = {'t': [t_host], 'T': [self.T]}
        forcing = self.forcing
        net_fn, p_int, p_c = self._march_inputs(forcing)
        march_kw = dict(convective_adjust=convective_adjust,
                        conv_thresh=conv_thresh,
                        conv_t_multiplier=conv_t_multiplier,
                        conv_method=conv_method)
        if save:
            return self._evolve_saving(data_dict, forcing, net_fn, p_int, p_c,
                                       flux_thresh, t_end, chunk_steps,
                                       verbose, march_kw)

        def march(state, ft, **kw):
            return column.evolve_to_equilibrium(
                state, net_fn, p_int, p_c, flux_thresh=ft,
                check_every=int(check_every), dip_memory=bool(dip_memory),
                debug=debug, **march_kw, **kw)
        if verbose and chunk_steps is None:
            chunk_steps = 1000
        if chunk_steps is None:
            self._state, info = march(self._state, flux_thresh,
                                      t_end=float(t_end))
        else:
            def chunk_evolve(state, ft, *, i0, t_end, max_steps):
                return march(state, ft, t_end=t_end, i0=i0,
                             max_steps=max_steps, final_reset=False)
            self._state, info = column.run_chunked_march(
                self._state, chunk_evolve, t_host_start=data_dict['t'][-1],
                t_end=t_end, chunk_steps=chunk_steps, flux_thresh=flux_thresh,
                verbose=verbose)
        # flux views at the equilibrium temperature
        self._fluxes = grey_fluxes(self._state.T, forcing)
        self._equilibrium_info = column.EquilibriumInfo(
            *(x[0].cpu().numpy() for x in info))
        eq = self._equilibrium_info
        self._raise_on_abort(eq)
        if not bool(eq.equilibrium) and not bool(eq.timed_out):
            raise RuntimeError(
                'march hit the max_steps safety cap without converging '
                'or reaching t_end — use chunk_steps, raise t_end, or '
                'loosen flux_thresh')
        data_dict['t'].append(float(self._state.t[0]))
        data_dict['T'].append(self.T)
        return data_dict

    @staticmethod
    def _raise_on_abort(eq):
        if bool(eq.nan):
            raise FloatingPointError(
                'non-finite temperature or flux encountered during the '
                'march (NaN sentinel) — check forcing inputs')
        if bool(eq.failed):
            raise ValueError('Temperature is below zero')

    def _evolve_saving(self, data_dict, forcing, net_fn, p_int, p_c,
                       flux_thresh, t_end, chunk_steps, verbose, march_kw):
        """The save=True march (JAX grey.py:492-567): chunks of per-step
        snapshots, one host copy a chunk, appended step by step; the
        fluxes stored with a step are those of its starting temperature
        (the reference's save_data lag)."""
        with_fluxes = 'flux' in data_dict
        with_tau = 'tau' in data_dict
        snap_fn = (lambda T: grey_fluxes(T, forcing)) if with_fluxes else None
        chunk = int(chunk_steps) if chunk_steps else 256
        i0 = 0
        ft = flux_thresh
        t_start = t_chunk_start = data_dict['t'][-1]
        flux_keys = ('lw_up', 'lw_down', 'sw_up', 'sw_down')
        while True:
            # t_end is a whole-march budget: each chunk gets the remainder
            t_end_chunk = float(t_end) - (t_chunk_start - t_start) \
                / SECONDS_PER_YEAR
            self._state, info, snaps = column.evolve_snapshots(
                self._state, net_fn, p_int, p_c, n_snaps=chunk,
                snapshot_fn=snap_fn, flux_thresh=ft, t_end=t_end_chunk,
                i0=i0, **march_kw)
            host = {k: (tuple(x[:, 0].cpu().numpy() for x in v)
                        if k == 'extra' else v[:, 0].cpu().numpy())
                    for k, v in snaps.items()}
            prev = i0
            for k in range(chunk):
                if host['steps'][k] <= prev:
                    break                         # march ended mid-chunk
                prev = int(host['steps'][k])
                t_k = float(host['t'][k])
                data_dict['t'].append(t_k)
                data_dict['T'].append(host['T'][k])
                if with_tau:
                    data_dict['tau']['lw'].append(self.tau.copy())
                    data_dict['tau']['sw'].append(self.tau_sw.copy())
                if with_fluxes:
                    for key, fx in zip(flux_keys, host['extra']):
                        data_dict['flux'][key].append(fx[k])
                if verbose:
                    print(f't = {t_k / SECONDS_PER_YEAR:.3f} yr, '
                          f'delta_net_flux = {float(host["delta"][k]):.4f}',
                          end='\r')
            eq = column.EquilibriumInfo(*(x[0].cpu().numpy() for x in info))
            i0 = int(eq.steps)
            ft = info.flux_thresh                # keep the tightened threshold
            t_chunk_start = data_dict['t'][-1]
            self._raise_on_abort(eq)
            if bool(eq.equilibrium) or bool(eq.timed_out):
                break
        # with fluxes: the lagged views of the last step, as the reference
        # holds them; otherwise the fluxes of the final temperature
        if with_fluxes:
            self._fluxes = tuple(self._tensor(data_dict['flux'][key][-1])[None]
                                 for key in flux_keys)
        else:
            self._fluxes = grey_fluxes(self._state.T, forcing)
        self._equilibrium_info = eq
        self._state = self._state.replace(
            tsi=column.reset_time_step_info(self._state.tsi))
        return data_dict

    def save_data(self, data_dict, t):
        """Append snapshot arrays (grey.py:360-383)."""
        data_dict['t'].append(t)
        data_dict['T'].append(self.T.copy())
        if 'tau' in data_dict:
            data_dict['tau']['lw'].append(self.tau.copy())
            data_dict['tau']['sw'].append(self.tau_sw.copy())
        if 'flux' in data_dict:
            data_dict['flux']['lw_up'].append(self.up_lw_flux)
            data_dict['flux']['lw_down'].append(self.down_lw_flux)
            data_dict['flux']['sw_up'].append(self.up_sw_flux)
            data_dict['flux']['sw_down'].append(self.down_sw_flux)
        return data_dict

    # ---------------- analytic equilibrium oracles (grey.py:385-451) ----------

    def equilibrium_sol(self, convective_adjust=False):
        """Analytic radiative-equilibrium profiles for the current grids.

        Returns (up_lw, down_lw, T_eqb, up_sw, down_sw, correct_solution), where
        correct_solution is False if the short-wave absorber had to be ignored
        (only exponential lw+sw with integer alpha ratio < 10 admits the closed
        form, grey.py:406-428).  ``convective_adjust`` passes T_eqb through
        the reference-method adjustment in float64 on the world's device.
        """
        if self.sw_tau_is_zero:
            correct = True
        elif self._lw.name == 'exponential' and self._sw.name == 'exponential':
            alpha_lw = self._lw.params[1]
            alpha_sw = self._sw.params[1]
            ratio = alpha_lw / alpha_sw
            correct = abs(round(ratio) - ratio) < 1e-5 and ratio < 10
            if not correct:
                warnings.warn(
                    'Exact solution needs integer alpha_lw/alpha_sw < 10; got '
                    f'{ratio}. Returning the tau_sw = 0 solution.')
        else:
            warnings.warn(
                'Exact solution needs exponential lw and sw profiles; got '
                f'{self._lw.name} / {self._sw.name}. Returning the tau_sw = 0 '
                'solution.')
            correct = False

        if not self.sw_tau_is_zero and correct:
            # the sw closed form is single-latitude (grey.py:529-530)
            if np.size(self.albedo_mod) > 1:
                raise ValueError('Must provide a single latitude bin')
            calc = GreySwEquilibrium(self.F_stellar_constant,
                                     float(np.asarray(self.albedo_mod).ravel()[0]),
                                     self._lw, self._sw)
            up_lw = calc.up_lw_flux(self.tau_sw_interface)
            down_lw = calc.down_lw_flux(self.tau_sw_interface)
            T_eqb = calc.T(self.tau_sw)
            up_sw = calc.up_sw_flux(self.tau_sw_interface)
            down_sw = calc.down_sw_flux(self.tau_sw_interface)
        else:
            # closed form with no short-wave absorber (grey.py:441-448)
            up_lw = 0.5 * self.F_sw0 * (2 + self.tau_interface)
            down_lw = 0.5 * self.F_sw0 * self.tau_interface
            T_eqb = np.power((self.F_sw0 / (2 * sigma)) * (1 + self.tau), 0.25)
            up_sw = np.ones_like(up_lw) * self.albedo_mod * \
                self.F_stellar_constant / 4
            down_sw = np.ones_like(up_lw) * self.F_stellar_constant / 4
        if convective_adjust:
            f64 = dict(dtype=torch.float64, device=self.device)
            T_eqb = convective_adjustment(
                torch.tensor(self.p[:, 0], **f64),
                torch.tensor(np.asarray(T_eqb), **f64)).cpu().numpy()
        return up_lw, down_lw, T_eqb, up_sw, down_sw, correct

    def plot_eqb(self, up_lw_flux_eqb, down_lw_flux_eqb, T_eqb, up_sw_flux_eqb,
                 down_sw_flux_eqb):
        """Optical depth / equilibrium T / equilibrium flux triple panel
        (grey.py:453-501).  Takes the arrays returned by ``equilibrium_sol``;
        with a short-wave absorber present, overlays the tau_sw = 0 world's
        analytic solution as dotted curves for comparison."""
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(1, 3, sharey=True, figsize=(12, 5))
        sw_color = '#1f77b4'
        lw_color = '#ff7f0e'
        if not self.sw_tau_is_zero:
            ax[0].plot(self.tau_sw_interface, self.p_interface,
                       label=r'short wave, $\tau_{sw}$', color=sw_color)
        ax[0].plot(self.tau_interface, self.p_interface,
                   label=r'long wave, $\tau_{lw}$', color=lw_color)
        ax[0].set_xlabel(r'Optical depth, $\tau$')
        ax[0].set_ylabel('Pressure / Pa')
        ax[1].plot(T_eqb, self.p, label=r'$\tau_{sw}\neq0$', color=sw_color)
        ax[1].set_xlabel('Temperature / K')
        net_flux = up_lw_flux_eqb + up_sw_flux_eqb - down_lw_flux_eqb \
            - down_sw_flux_eqb
        F_norm = self.F_stellar_constant / 4
        ax[2].plot(up_sw_flux_eqb / F_norm, self.p_interface, color=sw_color)
        sw_suffix = r'(\tau_{sw}\neq0)' if not self.sw_tau_is_zero else ''
        ax[2].plot(-down_sw_flux_eqb / F_norm, self.p_interface, color=sw_color,
                   label=rf'$F_{{sw}}{sw_suffix}$')
        ax[2].plot(up_lw_flux_eqb / F_norm, self.p_interface, color=lw_color,
                   label=rf'$F_{{lw}}{sw_suffix}$')
        ax[2].plot(-down_lw_flux_eqb / F_norm, self.p_interface, color=lw_color)
        ax[2].plot(net_flux / F_norm, self.p_interface, label=r'$F_{net}$',
                   color='#d62728')
        ax[2].set_xlabel(r'Radiation Flux, $F$, as fraction of Incoming Solar, '
                         r'$\frac{F^\odot}{4}$')
        ax[0].invert_yaxis()
        if not self.sw_tau_is_zero:
            # dotted overlays from a no-short-wave twin world (grey.py:487-500)
            ax[0].plot(self.tau_sw_interface * 0, self.p_interface,
                       color=sw_color, linestyle='dotted',
                       label=r'$\tau_{sw}=0$')
            ax[0].legend()
            no_sw = GreyGas(self.nz, self.ny, self.tau_lw_func,
                            self.tau_lw_func_args,
                            F_stellar_constant=self.F_stellar_constant,
                            albedo=self.albedo,
                            p_surface=self.p_surface, p_toa=self.p_toa,
                            dtype=self.dtype, device=self.device)
            up_lw0, down_lw0, T0, up_sw0, down_sw0, _ = no_sw.equilibrium_sol()
            ax[1].plot(T0, no_sw.p, label=r'$\tau_{sw}=0$', color=sw_color,
                       linestyle='dotted')
            ax[1].legend()
            ax[2].plot(up_sw0 / F_norm, no_sw.p_interface, color=sw_color,
                       linestyle='dotted', label=r'$F_{sw}(\tau_{sw}=0)$')
            ax[2].plot(-down_sw0 / F_norm, no_sw.p_interface, color=sw_color,
                       linestyle='dotted')
            ax[2].plot(up_lw0 / F_norm, no_sw.p_interface, color=lw_color,
                       linestyle='dotted', label=r'$F_{lw}(\tau_{sw}=0)$')
            ax[2].plot(-down_lw0 / F_norm, no_sw.p_interface, color=lw_color,
                       linestyle='dotted')
        ax[2].legend()
        return fig, ax

    def __str__(self):
        return 'Grey Gas'


class GreySwEquilibrium:
    """Closed-form radiative equilibrium with exponential lw + sw absorbers
    (host NumPy; the same closed form as the JAX package's).

    With tau_lw = c1 (e^{a1 p} - 1) and tau_sw = c2 (e^{a2 p} - 1) and integer
    n = a1/a2, tau_lw(tau_sw) = c1 ((t2/c2 + 1)^n - 1), so D = d tau1/d tau2 =
    (c1 n / c2)(t2/c2 + 1)^{n-1} and the optical-depth integral

        I(t2) = int D(t2) (e^{-t2} - A e^{t2}) dt2

    expands binomially into sums of int t^k e^{-/+t} dt, which have elementary
    antiderivatives.  The flux/temperature formulas follow grey.py:608-627:

        sigma T^4 = F/8 [ (e^{-t2} + A e^{t2}) / D + I(t2) + C ],
        C = 1 - A - I(0),
        F_lw_down = sigma T^4 - F/8 [ (e^{-t2} + A e^{t2}) / D + e^{-t2} - A e^{t2} ],
        F_lw_up = F_lw_down + F_sw_down - F_sw_up.
    """

    def __init__(self, F_stellar_const, albedo_mod, lw_profile, sw_profile):
        if np.size(albedo_mod) > 1:
            raise ValueError(
                'Must provide a single latitude bin to get analytical solution')
        c1, a1 = lw_profile.params
        c2, a2 = sw_profile.params
        n = a1 / a2
        if abs(round(n) - n) > 1e-5 or n >= 10:
            raise ValueError('alpha_lw/alpha_sw must be an integer < 10')
        self.n = int(round(n))
        self.c1, self.c2 = float(c1), float(c2)
        self.F = float(F_stellar_const)
        self.A = float(albedo_mod)
        self._I0 = self._integral(np.array(0.0))
        self.C = 1 - self.A - self._I0

    def _D(self, t2):
        """d tau_lw / d tau_sw."""
        return (self.c1 * self.n / self.c2) * (t2 / self.c2 + 1) ** (self.n - 1)

    @staticmethod
    def _int_tk_exp_neg(t, k):
        """Antiderivative of t^k e^{-t}: -e^{-t} sum_j k!/j! t^j."""
        s = sum(math.factorial(k) / math.factorial(j) * t ** j
                for j in range(k + 1))
        return -np.exp(-t) * s

    @staticmethod
    def _int_tk_exp_pos(t, k):
        """Antiderivative of t^k e^{+t}: e^{t} sum_j (-1)^{k-j} k!/j! t^j."""
        s = sum((-1) ** (k - j) * math.factorial(k) / math.factorial(j) * t ** j
                for j in range(k + 1))
        return np.exp(t) * s

    def _integral(self, t2):
        """I(t2) = int D (e^{-t} - A e^{t}) dt, constant-free antiderivative."""
        t2 = np.asarray(t2, dtype=np.float64)
        pref = self.c1 * self.n / self.c2
        total = np.zeros_like(t2)
        for k in range(self.n):
            binom = math.comb(self.n - 1, k) * self.c2 ** (-k)
            total = total + binom * (self._int_tk_exp_neg(t2, k)
                                     - self.A * self._int_tk_exp_pos(t2, k))
        return pref * total

    def sigma_T4(self, t2):
        t2 = np.asarray(t2, dtype=np.float64)
        return self.F / 8 * ((np.exp(-t2) + self.A * np.exp(t2)) / self._D(t2)
                             + self._integral(t2) + self.C)

    def T(self, t2):
        return (self.sigma_T4(t2) / sigma) ** 0.25

    def up_sw_flux(self, t2):
        return self.A * self.F / 4 * np.exp(np.asarray(t2, np.float64))

    def down_sw_flux(self, t2):
        return self.F / 4 * np.exp(-np.asarray(t2, np.float64))

    def down_lw_flux(self, t2):
        t2 = np.asarray(t2, dtype=np.float64)
        return self.sigma_T4(t2) - self.F / 8 * (
            (np.exp(-t2) + self.A * np.exp(t2)) / self._D(t2)
            + np.exp(-t2) - self.A * np.exp(t2))

    def up_lw_flux(self, t2):
        return self.down_lw_flux(t2) + self.down_sw_flux(t2) - self.up_sw_flux(t2)
