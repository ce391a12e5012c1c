"""Real-gas band radiative column model (port of
``climatemodel_tpu/models/real_gas.py``; reference ``RealGas``,
real_gas.py:187-841 of the NumPy original).

Line-by-line HITRAN absorption collapsed into lookup tables, band-averaged
transmission-function flux integrals, and the shared adaptive-dt march to
equilibrium:

  * wavenumber machinery, band construction, tau and the absorption-weighted
    'auto' pressure grid stay host NumPy float64 (shape-determining), bit-
    equal to the JAX package;
  * everything tau-dependent is folded once per composition into a
    :class:`TransmissionCache` (attenuation vectors, the flux-integral weight
    products), so a march step is a batched matrix product of the cached
    long-wave operator against the Planck factors of the current
    temperatures, plus rank-1 terms.  With one composition shared by B
    members it is one ``torch.matmul`` over the L long-wave bands with the
    members as the product's N;
  * the reference's cubic-spline T(p_interface) is linear in the data, so it
    enters as a precomputed [nz, nz-1] matrix;
  * the march is ``column.evolve_to_equilibrium`` with TOA-first
    orientation (``p_descending=False``) and a net flux function that
    returns (net, net_diff), the per-band adjacent-interface difference.

Array orientation matches the reference real-gas model: level index 0 = top
of atmosphere (ascending pressure).  Device tensors carry a leading member
axis B (a single world is B = 1): T [B, nz-1], T_g [B], fluxes
[B, nz, n_bands].

Everything is ported, the host plots ``plot_olr`` and
``plot_incoming_short_wave`` included.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from scipy import optimize
from scipy.interpolate import InterpolatedUnivariateSpline, interp1d

from ..constants import (AU, R_sun, SECONDS_PER_YEAR, T_sun, g,
                         p_surface_earth, p_toa_earth, sigma)
from ..ops import transmission as tr
from ..ops.planck import B_wavenumber
from ..spectral import bands as bands_mod
from ..spectral import hitran
from ..spectral.humidity import molecules, ppmv_from_humidity
from . import column
from .column import (ColumnState, TensorStruct, get_isothermal_temp,
                     init_time_step_info)


@dataclasses.dataclass
class BandArrays(TensorStruct):
    """Packed band structure + integration weights on the model's device
    (index fields int64, the others the model's float dtype)."""
    idx: torch.Tensor        # [n_bands, K] nu indices
    w: torch.Tensor          # [n_bands, K] trapz weights
    delta: torch.Tensor      # [n_bands]
    centre: torch.Tensor     # [n_bands]
    lw_idx: torch.Tensor     # [n_lw, K_lw]
    lw_w: torch.Tensor       # [n_lw, K_lw]
    lw_delta: torch.Tensor   # [n_lw]
    lw_centre: torch.Tensor  # [n_lw]
    lw_list: torch.Tensor    # [n_lw] band indices (unique)
    W_up: torch.Tensor       # [nz, nz+1]
    W_down: torch.Tensor     # [nz, nz+1]
    S: torch.Tensor          # [nz, nz-1] spline interpolation matrix
    dp_int: torch.Tensor     # [nz-1] interface pressure differences


@dataclasses.dataclass
class TransmissionCache(TensorStruct):
    """tau-dependent factors of the flux equations, constant during a march
    (the optical depth changes with composition, not temperature): the
    per-band attenuation vectors, and the flux-integral weight products
    W x dTr folded into matmul-ready operators.  A cache of B compositions
    (``stack_caches``) has a leading member axis on every field.

    The march only ever consumes the SUM of the two interior operators, so
    the cache carries a march operator besides the per-direction ones the
    diagnostics need:

    * full precision: ``M_sum = M_up + M_down`` [L, nz, nz-1];
    * reduced ``cache_dtype`` (bf16): the ROW-DIFFERENCED sum
      ``D_sum[b, i, :] = M_sum[b, i+1, :] - M_sum[b, i, :]`` in the reduced
      dtype plus the full-precision first row.  The heating tendency
      consumes adjacent-row flux differences, and quantizing D bounds the
      tendency noise by eps_bf16 * |local flux divergence| instead of
      eps_bf16 * |flux| (directly quantized operators put a biased spurious
      tendency on micro-mass TOA levels).  The per-direction operators are
      kept in the reduced dtype too, for the diagnostics.
    """
    att_up: torch.Tensor       # [n_bands, nz]
    att_down: torch.Tensor     # [n_bands, nz]
    M_up: torch.Tensor         # [L, nz, nz-1]  interior-up operator
    M_down: torch.Tensor       # [L, nz, nz-1]  interior-down operator
    lo_up: torch.Tensor        # [L, nz]  lower-interface term coefficients
    sf_up: torch.Tensor        # [L, nz]  surface term coefficients
    toa_down: torch.Tensor     # [L, nz]  TOA term coefficients
    hi_down: torch.Tensor      # [L, nz]  upper-interface term coefficients
    M_sum: Optional[torch.Tensor] = None     # [L, nz, nz-1] (full layout)
    D_sum: Optional[torch.Tensor] = None     # [L, nz-1, nz-1] (reduced)
    row0_sum: Optional[torch.Tensor] = None  # [L, nz-1] first row of M_sum


def precompute_transmission(tau_interface, ba: BandArrays,
                            cache_dtype=None) -> TransmissionCache:
    """Fold everything tau-dependent out of the per-step flux computation.

    :param tau_interface: [nz, n_nu] optical depth at interfaces, on the
        device and in the dtype of ``ba``.
    :param cache_dtype: optional storage dtype of the interior operators
        (e.g. ``torch.bfloat16``): the row-differenced layout of
        :class:`TransmissionCache`, for memory-constrained caches; every
        product upcasts it to the carrier dtype (the JAX package's non-TPU
        branch).
    """
    nz = tau_interface.shape[0]
    att_up = tr.band_attenuation(tau_interface, ba.idx, ba.w, ba.delta,
                                 ref_level=nz - 1)
    att_down = tr.band_attenuation(tau_interface, ba.idx, ba.w, ba.delta,
                                   ref_level=0)
    Tr = tr.band_transmission_matrices(tau_interface, ba.lw_idx, ba.lw_w,
                                       ba.lw_delta)
    dTr_up = torch.diff(Tr, dim=2) / ba.dp_int[None, None, :]
    dTr_dn = torch.diff(Tr, dim=1) / ba.dp_int[None, :, None]
    del Tr

    diag_up = torch.diagonal(dTr_up, dim1=1, dim2=2)
    diag_up = torch.cat([diag_up, torch.zeros_like(diag_up[:, :1])], 1)
    lo_up = ba.W_up[None, :, 0] * diag_up
    sf_up = ba.W_up[None, :, nz] * dTr_up[:, :, nz - 2]
    M_up = ba.W_up[None, :, 1:nz] * dTr_up

    diag_dn = torch.diagonal(dTr_dn, offset=1, dim1=1, dim2=2)
    diag_dn = torch.cat([torch.zeros_like(diag_dn[:, :1]), diag_dn], 1)
    toa_down = ba.W_down[None, :, 0] * dTr_dn[:, 0, :]
    hi_down = ba.W_down[None, :, nz] * diag_dn
    # M_down[b, j, m] = W_down[j, 1+m] * dTr_dn[b, m, j]
    M_down = (dTr_dn.transpose(1, 2) * ba.W_down[None, :, 1:nz]).contiguous()
    M_sum = M_up + M_down
    if cache_dtype is not None:
        D_sum = (M_sum[:, 1:, :] - M_sum[:, :-1, :]).to(cache_dtype)
        return TransmissionCache(att_up=att_up, att_down=att_down,
                                 M_up=M_up.to(cache_dtype),
                                 M_down=M_down.to(cache_dtype),
                                 lo_up=lo_up, sf_up=sf_up, toa_down=toa_down,
                                 hi_down=hi_down, D_sum=D_sum,
                                 row0_sum=M_sum[:, 0, :].contiguous())
    return TransmissionCache(att_up=att_up, att_down=att_down, M_up=M_up,
                             M_down=M_down, lo_up=lo_up, sf_up=sf_up,
                             toa_down=toa_down, hi_down=hi_down, M_sum=M_sum)


def stack_caches(caches) -> TransmissionCache:
    """One cache of B compositions from B single caches (a leading member
    axis on every field)."""
    return caches[0].map(lambda *xs: torch.stack(xs), *caches[1:])


# --------------------------------------------------------------------------
# per-step flux evaluation (members on the leading axis)
# --------------------------------------------------------------------------

def _band_matvec(M, B_c):
    """out[b, l, i] = sum_m M[(b,) l, i, m] B_c[b, l, m]: the cached
    operator against the Planck factors, accumulated in B_c's dtype (a
    reduced-precision operator is upcast first).  A shared operator [L, nz_r,
    nz-1] takes every member in one batched matmul over the L bands; a
    stacked one [B, L, nz_r, nz-1] one matrix-vector product per member and
    band."""
    if M.dtype != B_c.dtype:
        M = M.to(B_c.dtype)
    if M.ndim == 3:
        return torch.matmul(M, B_c.permute(1, 2, 0)).permute(2, 0, 1)
    return torch.matmul(M, B_c[..., None])[..., 0]


def _add_lw(x, lw_list, y):
    """``x`` [(B,) n_bands, nz] with ``y`` [B, L, nz] added to the rows
    ``lw_list``.  The long-wave band indices are unique, so this is a
    gather, an add and a scatter with no collisions (no atomic adds that
    could reorder sums)."""
    x = torch.broadcast_to(x, y.shape[:1] + x.shape[-2:])
    return x.index_copy(1, lw_list, x.index_select(1, lw_list) + y)


def _planck_terms(T, T_g, ba: BandArrays):
    """(B_c [B, L, nz-1], B_int [B, L, nz], B_g [B, L]): pi B at the cell
    temperatures, at the interface temperatures (the spline of T, the
    ground pinned to T_g) and at the ground, at the long-wave band
    centres."""
    T_int = torch.matmul(T, ba.S.T)
    T_int = torch.cat([T_int[:, :-1], T_g[:, None]], dim=1)
    nu = ba.lw_centre[None, :, None]
    B_c = math.pi * B_wavenumber(nu, T[:, None, :])
    B_int = math.pi * B_wavenumber(nu, T_int[:, None, :])
    B_g = math.pi * B_wavenumber(ba.lw_centre[None, :], T_g[:, None])
    return B_c, B_int, B_g


def real_gas_fluxes_cached(T, T_g, cache: TransmissionCache, ba: BandArrays,
                           F_star_factor):
    """Up/down band fluxes at interfaces [B, nz, n_bands] with the
    tau-dependent factors precomputed: only the Planck factors depend on T,
    so the long-wave integrals reduce to one batched matmul per direction
    plus rank-1 corrections (the diagnostics path; marches go through
    :func:`real_gas_net_and_diff_cached`).

    :param T: [B, nz-1] cell temperatures (TOA first); ``T_g`` [B].
    :param F_star_factor: [n_bands] or [B, n_bands] stellar flux per band.
    """
    up0 = math.pi * B_wavenumber(ba.centre[None, :], T_g[:, None])   # [B, nb]
    up = up0[:, :, None] * cache.att_up
    down = F_star_factor[..., None] * cache.att_down
    B_c, B_int, B_g = _planck_terms(T, T_g, ba)
    m_up = _band_matvec(cache.M_up, B_c)
    m_down = _band_matvec(cache.M_down, B_c)
    integral_up = -(cache.lo_up * B_int + m_up + cache.sf_up * B_g[..., None])
    integral_down = (cache.toa_down * B_int[..., :1] + m_down
                     + cache.hi_down * B_int)
    up = _add_lw(up, ba.lw_list, integral_up)
    down = _add_lw(down, ba.lw_list, integral_down)
    return up.transpose(1, 2), down.transpose(1, 2)


def real_gas_fluxes(T, T_g, tau_interface, ba: BandArrays, F_star_factor):
    """Up/down band fluxes at interfaces [B, nz, n_bands] of one composition
    (real_gas.py:629-669): the transmission folded from ``tau_interface``
    [nz, n_nu], then :func:`real_gas_fluxes_cached`."""
    return real_gas_fluxes_cached(
        T, T_g, precompute_transmission(tau_interface, ba), ba, F_star_factor)


def _net_flux(T, T_g, cache: TransmissionCache, ba: BandArrays,
              F_star_factor, delta):
    """Net upward flux at interfaces [B, nz]: the band sum of (up - down)."""
    up, down = real_gas_fluxes_cached(T, T_g, cache, ba, F_star_factor)
    return ((up - down) * delta).sum(-1)


def _net_and_diff(up, down, delta):
    """(net [B, nz], net_diff [B, nz-1]) from band fluxes [B, nz, n_bands],
    with the adjacent-interface difference taken PER BAND before the band
    reduction.

    The heating tendency divides ``net[k+1] - net[k]`` by dp; differencing
    the two ~1e2 W/m^2 band sums directly leaves f32 reduction-order noise
    of ~|net| * eps on the difference, which at micro-mass TOA levels
    (dp ~ 0.1 Pa) becomes a spurious heating of radiatively decoupled
    layers (it cooled one member of the JAX package's 64-member earth
    ensemble to the negative-T abort).  Differencing per band first bounds
    the noise by ~sqrt(L) * eps * |band contribution| instead.  In f64 the
    two forms agree to machine epsilon."""
    ud = up - down
    net = (ud * delta).sum(-1)
    net_diff = ((ud[:, 1:, :] - ud[:, :-1, :]) * delta).sum(-1)
    return net, net_diff


def real_gas_net_and_diff_cached(T, T_g, cache: TransmissionCache,
                                 ba: BandArrays, F_star_factor, delta):
    """March-path (net [B, nz], net_diff [B, nz-1]) — the per-step function.

    Full-precision layout: the product with M_sum materialises the per-band
    m_sum rows, so the adjacent-interface difference is taken PER BAND
    before the band reduction (see :func:`_net_and_diff`).

    Reduced layout: band-reduce FIRST, reconstruct after.  The per-band m
    rows never materialise — only their band-weighted sum enters net — so
    the heavy work is one product with D_sum (upcast to T's dtype),
    followed by rank-1 base terms and one [nz-1]-vector prefix (a
    triangular matvec, not a cumsum).  The operator part of net_diff IS the
    quantized product: tendency noise is bounded by the local flux
    divergence, not the absolute flux."""
    up0 = math.pi * B_wavenumber(ba.centre[None, :], T_g[:, None])   # [B, nb]
    B_c, B_int, B_g = _planck_terms(T, T_g, ba)

    # base (everything except the interior operators): rank-1 terms
    ud_base = up0[:, :, None] * cache.att_up \
        - F_star_factor[..., None] * cache.att_down               # [B, nb, nz]
    lw_base = -(cache.lo_up * B_int + cache.sf_up * B_g[..., None]) \
        - (cache.toa_down * B_int[..., :1] + cache.hi_down * B_int)

    if cache.M_sum is not None:
        m_sum = _band_matvec(cache.M_sum, B_c)                     # [B, L, nz]
        ud = _add_lw(ud_base, ba.lw_list, lw_base - m_sum)
        w = ud * delta[:, None]                                # [B, nb, nz]
        net = w.sum(1)
        net_diff = (w[:, :, 1:] - w[:, :, :-1]).sum(1)
        return net, net_diff

    ud_base = _add_lw(ud_base, ba.lw_list, lw_base)
    w = ud_base * delta[:, None]
    net_base = w.sum(1)                                            # [B, nz]
    diff_base = (w[:, :, 1:] - w[:, :, :-1]).sum(1)                # [B, nz-1]

    E = _band_matvec(cache.D_sum, B_c)                         # [B, L, nz-1]
    dl = delta[ba.lw_list]                                         # [L]
    c0 = -(dl * (cache.row0_sum * B_c).sum(-1)).sum(-1)            # [B]
    g_ = -torch.matmul(dl, E)                                      # [B, nz-1]
    nz_i = g_.shape[-1] + 1
    ar = torch.arange(nz_i, device=g_.device)
    tri = (ar[:, None] > ar[None, :-1]).to(g_.dtype)               # [nz, nz-1]
    net = net_base + c0[:, None] + torch.matmul(g_, tri.T)
    net_diff = diff_base + g_
    return net, net_diff


def real_gas_net_fn(T_g, cache: TransmissionCache, ba: BandArrays,
                    F_star_factor, delta):
    """The march's net flux function: T [B, nz-1, 1] -> (net [B, nz, 1],
    net_diff [B, nz-1, 1])."""
    def net_fn(T):
        net, diff = real_gas_net_and_diff_cached(T[..., 0], T_g, cache, ba,
                                                 F_star_factor, delta)
        return net[..., None], diff[..., None]
    return net_fn


# --------------------------------------------------------------------------
# the march
# --------------------------------------------------------------------------

def _real_gas_evolve(state: ColumnState, T_g, tau_interface, ba: BandArrays,
                     F_star_factor, delta, p_interface, p_centre_col,
                     flux_thresh, convective_adjust=False, t_end=4.0,
                     conv_thresh=1e-5, conv_t_multiplier=5.0,
                     net_flux_thresh=1e-7, net_flux_percentile=95,
                     max_steps=500_000, conv_method='reference', i0=0,
                     final_reset=True, cache_dtype=None, check_every=1,
                     dip_memory=False, debug=False, cache=None):
    """The march of one composition to equilibrium (JAX
    ``_real_gas_evolve_core``; ``debug=True`` is its checkify form, here the
    column march's device-side checks).  tau is fixed during the march, so
    the transmission is folded once (or taken from ``cache``); each step is
    then a batched product over the Planck factors.

    :param T_g: [B] ground temperatures; the other inputs as
        :func:`real_gas_net_and_diff_cached` takes them.
    :return: (state, ``column.EquilibriumInfo``)
    """
    if cache is None:
        cache = precompute_transmission(tau_interface, ba, cache_dtype)
    return column.evolve_to_equilibrium(
        state, real_gas_net_fn(T_g, cache, ba, F_star_factor, delta),
        p_interface, p_centre_col, flux_thresh=flux_thresh,
        convective_adjust=convective_adjust, t_end=t_end,
        conv_thresh=conv_thresh, conv_t_multiplier=conv_t_multiplier,
        net_flux_thresh=net_flux_thresh,
        net_flux_percentile=net_flux_percentile, max_steps=max_steps,
        conv_method=conv_method, i0=i0, final_reset=final_reset,
        check_every=check_every, dip_memory=dip_memory, debug=debug,
        p_descending=False)


def _real_gas_evolve_snapshots(state: ColumnState, T_g, tau_interface,
                               ba: BandArrays, F_star_factor, delta, delta_lw,
                               delta_sw, p_interface, p_centre_col,
                               flux_thresh, n_snaps, convective_adjust=False,
                               t_end=4.0, conv_thresh=1e-5,
                               conv_t_multiplier=5.0, conv_method='reference',
                               i0=0, with_fluxes=False, cache_dtype=None,
                               cache=None):
    """Save-mode march: a snapshot of (t, T) after every step, and with
    ``with_fluxes`` the lw/sw-split flux sums the reference's save_data
    records (real_gas.py:720-746) at the post-step temperature, from the
    march's cache."""
    if cache is None:
        cache = precompute_transmission(tau_interface, ba, cache_dtype)

    snap_fn = None
    if with_fluxes:
        def snap_fn(T):
            up, down = real_gas_fluxes_cached(T[..., 0], T_g, cache, ba,
                                              F_star_factor)
            return (up @ delta_lw, down @ delta_lw,
                    up @ delta_sw, down @ delta_sw)

    return column.evolve_snapshots(
        state, real_gas_net_fn(T_g, cache, ba, F_star_factor, delta),
        p_interface, p_centre_col, n_snaps=n_snaps, steps_per_snap=1,
        snapshot_fn=snap_fn, snapshot_on='post', flux_thresh=flux_thresh,
        convective_adjust=convective_adjust, t_end=t_end,
        conv_thresh=conv_thresh, conv_t_multiplier=conv_t_multiplier,
        conv_method=conv_method, i0=i0, p_descending=False)


def _raise_on_abort(eq):
    if bool(eq.nan):
        raise FloatingPointError(
            'non-finite temperature or flux encountered during the march '
            '(NaN sentinel) — check forcing/table inputs')
    if bool(eq.failed):
        raise ValueError('Temperature is below zero')


class RealGas:
    """User-facing real-gas band column model (real_gas.py:187-299 ctor
    API), plus the ``device`` its state lives on — the card unless the
    caller names another (``device='cpu'``) — and its float ``dtype``."""

    def __init__(self, nz, ny, molecule_names, T_g=None, q_funcs=None,
                 q_funcs_args=None, n_nu_bands=40, T_star=T_sun, R_star=R_sun,
                 star_planet_dist=AU, albedo=0.3, temp_change=1.0,
                 delta_temp_change=0.01, T_func=None,
                 p_surface=p_surface_earth, p_toa=p_toa_earth,
                 table_folder=None, dtype=torch.float32, cache_dtype=None,
                 device='cuda'):
        if ny != 1:
            raise NotImplementedError('RealGas supports ny=1 (like the '
                                      'reference); batch columns with the '
                                      'real-gas ensembles')
        self.ny = 1
        self.p_surface = float(p_surface)
        self.p_toa = float(p_toa)
        self.table_folder = table_folder
        # optional storage dtype of the cached transmission operators (e.g.
        # torch.bfloat16): a memory/precision trade for the march
        self.cache_dtype = cache_dtype
        self.dtype = dtype
        self.device = torch.device(device)
        self.star = {'T': float(T_star), 'R': float(R_star),
                     'star_planet_dist': float(star_planet_dist)}
        self.F_stellar_constant = sigma * self.star['T'] ** 4 * \
            self.star['R'] ** 2 / self.star['star_planet_dist'] ** 2
        self.latitude = np.zeros(1)
        self.albedo = float(np.asarray(albedo).ravel()[0])
        self.solar_latitude_factor = np.ones(1)
        self.temp_change = float(temp_change)
        self.delta_temp_change = float(delta_temp_change)
        self.T0 = get_isothermal_temp(self.albedo, self.F_stellar_constant)
        self.T_func = T_func
        solve_T_g = T_g is None and T_func is None
        if T_g is None:
            if T_func is not None:
                self.T_g = float(T_func(np.array(self.p_surface)))
            else:
                self.T_g = float(self.T0) + 20.0      # greenhouse guess
        else:
            self.T_g = float(T_g)

        self.molecule_names = list(molecule_names)
        if q_funcs is None:
            q_funcs = {m: molecules[m]['q'] for m in self.molecule_names}
            default_args = {m: molecules[m]['q_args']
                            for m in self.molecule_names}
        else:
            default_args = None
        self.q_funcs = q_funcs
        if q_funcs_args is None:
            if default_args is None:
                raise ValueError('q_funcs_args required with custom q_funcs')
            self.q_funcs_args = default_args
        elif list(q_funcs_args.keys()) == list(self.q_funcs.keys()):
            self.q_funcs_args = q_funcs_args
        else:
            raise ValueError("Keys don't match in q_funcs and q_funcs_args")

        # wavenumber spacing from the first molecule's table
        # (real_gas.py:275-277)
        self._tables = {m: hitran.load_table(m, self.table_folder)
                        for m in self.molecule_names}
        nu0 = self._tables[self.molecule_names[0]]['nu']
        self.d_nu = float(nu0[1] - nu0[0])
        self.n_nu_bands = int(n_nu_bands)
        self._build_wavenumber_machinery()

        p_col = self.get_p_grid(nz)
        self.p_interface = np.sort(p_col)[:, None]    # ascending, [nz, 1]
        self.p = 0.5 * (self.p_interface[:-1] + self.p_interface[1:])
        if T_func is None:
            T = np.ones_like(self.p) * self.T_g
            T_interface = np.ones(self.nz) * self.T_g
        else:
            T = np.asarray(T_func(self.p))
            T_interface = np.asarray(T_func(self.p_interface[:, 0]))
        self._refresh_tau(T_interface)
        self._build_weights()

        self._state = ColumnState(
            T=self._tensor(T)[None],
            net_flux=torch.zeros((1, self.nz, 1), dtype=self.dtype,
                                 device=self.device),
            t=torch.zeros((1,), dtype=self.dtype, device=self.device),
            tsi=init_time_step_info(self.nz - 1, self.temp_change,
                                    self.delta_temp_change, batch=1,
                                    dtype=self.dtype, device=self.device))
        self._equilibrium_info = None
        self._set_initial_net_flux()
        if solve_T_g:
            self.inital_Tg_guess()

    def _tensor(self, a):
        return torch.tensor(np.asarray(a), dtype=self.dtype,
                            device=self.device)

    def _set_initial_net_flux(self):
        """Flux views of the current state, and the host net flux band sum
        (real_gas.py:296-299) as the state's previous net flux."""
        self.up_flux, self.down_flux = self.get_flux()
        self.net_flux = (self.up_flux * self.nu_bands['delta']).sum(axis=1) - \
            (self.down_flux * self.nu_bands['delta']).sum(axis=1)
        self._state = self._state.replace(
            net_flux=self._tensor(self.net_flux)[None, :, None])

    # ------------- host-side construction -------------

    def _build_wavenumber_machinery(self):
        self.nu, self.nu_lw, self._nu_overlap, self.nu_sw = \
            bands_mod.get_wavenumber_array(self.T_g, self.star['T'], self.d_nu)
        self.nu_bands = bands_mod.get_wavenumber_bands(
            self.n_nu_bands, self.T_g, self.star['T'], self.nu_lw,
            self._nu_overlap, self.nu_sw)
        self._packed = tr.PackedBands(self.nu_bands, self.nu)
        self._drop_device_cache()

    def _absorption_lookup(self, p, T, wavenumber, name):
        return tr.crop_lookup(p, T, wavenumber, self._tables[name])

    def _refresh_tau(self, T_interface):
        """(Re)compute tau at interfaces for the current composition
        (real_gas.py:291-292)."""
        self.tau_interface = tr.optical_depth(
            self.p_interface[:, 0], T_interface, self.nu, self.molecule_names,
            self.q_funcs, self.q_funcs_args, self._absorption_lookup, g)
        self._drop_device_cache()

    def _build_weights(self):
        """Static flux-integral weights + the spline interpolation matrix."""
        self._W_up, self._W_down = tr.flux_integral_weights(
            self.p_interface[:, 0], self.p[:, 0])
        # InterpolatedUnivariateSpline is linear in the data: its matrix is
        # the interpolation of the unit vectors (exact FITPACK parity)
        n = self.nz - 1
        S = np.zeros((self.nz, n))
        pc = self.p[:, 0]
        pi = self.p_interface[:, 0]
        k = min(3, n - 1)
        for j in range(n):
            e = np.zeros(n)
            e[j] = 1.0
            S[:, j] = InterpolatedUnivariateSpline(pc, e, k=k)(pi)
        self._S = S
        self._drop_device_cache()

    def _drop_device_cache(self):
        self._band_arrays_cache = None
        self._F_star_cache = None
        self._tau_device = None
        self._geom_device_cache = None
        self._transmission_cache = {}

    @property
    def band_arrays(self) -> BandArrays:
        """Packed bands on the model's device, cached until the bands or
        tau change."""
        if getattr(self, '_band_arrays_cache', None) is not None:
            return self._band_arrays_cache
        pk = self._packed
        ix = lambda a: torch.as_tensor(np.asarray(a, np.int64),  # noqa: E731
                                       device=self.device)
        self._band_arrays_cache = BandArrays(
            idx=ix(pk.idx), w=self._tensor(pk.w), delta=self._tensor(pk.delta),
            centre=self._tensor(pk.centre), lw_idx=ix(pk.lw_idx),
            lw_w=self._tensor(pk.lw_w), lw_delta=self._tensor(pk.lw_delta),
            lw_centre=self._tensor(pk.lw_centre), lw_list=ix(pk.lw_list),
            W_up=self._tensor(self._W_up), W_down=self._tensor(self._W_down),
            S=self._tensor(self._S),
            dp_int=self._tensor(np.diff(self.p_interface[:, 0])))
        return self._band_arrays_cache

    @property
    def _geom_device(self):
        """Device copies of the static per-step geometry: band widths,
        interface pressures [nz, 1] and cell-centre pressures [nz-1]."""
        if getattr(self, '_geom_device_cache', None) is not None:
            return self._geom_device_cache
        self._geom_device_cache = (self._tensor(self.nu_bands['delta']),
                                   self._tensor(self.p_interface),
                                   self._tensor(self.p[:, 0]))
        return self._geom_device_cache

    @property
    def _F_star_factor(self):
        """pi B(nu, T_star) R^2/d^2 (1 - albedo)/4 per band [n_bands]."""
        if getattr(self, '_F_star_cache', None) is not None:
            return self._F_star_cache
        self._F_star_cache = self._tensor(
            np.pi * np.asarray(B_wavenumber(self._packed.centre,
                                            self.star['T']))
            * self.star['R'] ** 2 / self.star['star_planet_dist'] ** 2
            * (1 - self.albedo) / 4)
        return self._F_star_cache

    @property
    def tau_device(self):
        if getattr(self, '_tau_device', None) is not None:
            return self._tau_device
        self._tau_device = self._tensor(self.tau_interface)
        return self._tau_device

    def transmission(self, cache_dtype=None) -> TransmissionCache:
        """The :class:`TransmissionCache` of the current composition in
        ``cache_dtype`` (None: full precision), folded once and kept until
        the bands or tau change."""
        key = str(cache_dtype)
        if key not in self._transmission_cache:
            self._transmission_cache[key] = precompute_transmission(
                self.tau_device, self.band_arrays, cache_dtype)
        return self._transmission_cache[key]

    def _T_g_tensor(self):
        return torch.full((1,), self.T_g, dtype=self.dtype, device=self.device)

    def get_p_grid(self, nz, min_absorb_coef_use=10e-6,
                   min_log_p_spacing_factor=5000, max_log_p_spacing_factor=50,
                   max_max_log_p_spacing=0.2):
        """Absorption-weighted adaptive pressure grid (real_gas.py:404-503):
        log-p spacing shrinks where specific humidity x absorption is large."""
        auto = nz == 'auto'
        p_initial_size = int(1e6) if auto else int(nz * 1000)
        p_interface = np.logspace(np.log10(self.p_surface),
                                  np.log10(self.p_toa), p_initial_size)
        q = np.zeros_like(p_interface)
        for name in self.molecule_names:
            table = self._tables[name]
            k_all = tr.nearest_lookup(table['p'],
                                      np.ones_like(table['p']) * self.T_g,
                                      table['nu'], table)
            use_nu = np.max(k_all, axis=0) > min_absorb_coef_use
            k_mean = np.mean(k_all[:, use_nu], axis=1)
            k_mean = k_mean / np.max(k_mean)
            if len(k_mean) > 1:
                coef_interp = interp1d(table['p'], k_mean)
                to_interp = np.where(p_interface >= table['p'].min())[0]
                k_of_p = np.ones_like(p_interface)
                k_of_p[to_interp] = coef_interp(p_interface[to_interp])
                k_of_p[p_interface < table['p'].min()] = k_of_p[to_interp[-1]]
            else:
                k_of_p = np.ones_like(p_interface)
            q_mol = np.asarray(self.q_funcs[name](p_interface,
                                                  *self.q_funcs_args[name]))
            q = q + q_mol * k_of_p

        log_p = np.log10(p_interface)
        if auto:
            log_q = np.log10(q)
            log_q[q == 0] = log_q[q > 0].min()
            min_sp = -log_q.max() / min_log_p_spacing_factor
            max_sp = np.clip(-log_q.min() / max_log_p_spacing_factor, min_sp,
                             max_max_log_p_spacing)
            fract_large = (q > 0.9 * q.max()).sum() / q.size
            min_sp = fract_large * max_sp + (1 - fract_large) * min_sp

            if log_q.min() == log_q.max():
                spacing_of = lambda lq: min_sp  # noqa: E731
            else:
                gradient = (max_sp - min_sp) / (log_q.min() - log_q.max())
                intercept = max_sp - gradient * log_q.min()
                spacing_of = lambda lq: gradient * lq + intercept  # noqa: E731

            current = log_p[0]
            out = []
            while current > log_p[-1]:
                out.append(current)
                ind = np.abs(log_p - current).argmin()
                current = out[-1] - spacing_of(log_q[ind])
            out = np.array(out)
            cum = np.cumsum(np.abs(np.ediff1d(out)))
            cum = cum * (log_p[0] - log_p[-1]) / cum[-1]
            log_p_final = np.concatenate((out[:1], out[0] - cum))
            self.nz = len(log_p_final)
        else:
            alpha = np.log10(log_p[0] - log_p[-1] + 1) / (nz - 1)
            log_p_final = log_p[0] + 1 - 10 ** (alpha * np.arange(nz))
            # the reference checks exact float equality here
            # (real_gas.py:499-500) and crashes on rounding for many nz
            # values (e.g. 36, 40); the endpoint is snapped when it is merely
            # rounding
            if not np.isclose(log_p_final[-1], log_p[-1], rtol=0, atol=1e-9):
                raise ValueError('Too few grid points to cover pressure grid')
            log_p_final[-1] = log_p[-1]
            self.nz = int(nz)
        return 10 ** log_p_final

    # ------------- state views -------------

    @property
    def T(self):
        """[nz-1, 1] cell temperatures on the host."""
        return self._state.T[0].cpu().numpy()

    @T.setter
    def T(self, value):
        self._state = self._state.replace(T=self._tensor(value)[None])

    @property
    def state(self) -> ColumnState:
        """The batch-of-one march state."""
        return self._state

    # ------------- fluxes -------------

    def get_flux(self, include_olr_breakdown=False):
        """Up/down band fluxes [nz, n_nu_bands] on the host
        (real_gas.py:629-669), from the full-precision transmission."""
        ba = self.band_arrays
        up, down = real_gas_fluxes_cached(
            self._state.T[:, :, 0], self._T_g_tensor(), self.transmission(),
            ba, self._F_star_factor)
        up, down = up[0].cpu().numpy(), down[0].cpu().numpy()
        if include_olr_breakdown:
            # surface vs atmosphere contributions to OLR (real_gas.py:643-665)
            att = self.transmission().att_up.cpu().numpy()
            surface = np.pi * np.asarray(
                B_wavenumber(self._packed.centre, self.T_g)) * att[:, 0]
            olr_cont = {'surface': surface, 'atmos': up[0] - surface}
            return up, down, olr_cont
        return up, down

    def take_time_step(self, t, T_initial=None, changing_tau=False,
                       convective_adjust=False, net_flux_thresh=1e-7,
                       net_flux_percentile=95, conv_thresh=1e-5,
                       conv_t_multiplier=5):
        """One adaptive step (real_gas.py:671-718): the net flux of the
        current temperature (the band sum of up - down), then the
        temperature update.  Returns (t, delta_net_flux)."""
        if t == 0 and T_initial is not None:
            self.T = T_initial
        self._state = self._state.replace(
            t=torch.full((1,), float(t), dtype=self.dtype, device=self.device))
        delta_nu, p_int, p_c = self._geom_device
        net = _net_flux(self._state.T[:, :, 0], self._T_g_tensor(),
                        self.transmission(), self.band_arrays,
                        self._F_star_factor, delta_nu)
        conv_kw = (dict(convective_adjust=True, p_centre_col=p_c,
                        conv_thresh=conv_thresh,
                        conv_t_multiplier=conv_t_multiplier)
                   if convective_adjust else {})
        self._state, delta = column.update_temp(
            self._state, net[..., None], p_int, changing_tau=changing_tau,
            net_flux_thresh=net_flux_thresh,
            net_flux_percentile=net_flux_percentile, p_descending=False,
            **conv_kw)
        self.net_flux = self._state.net_flux[0, :, 0].cpu().numpy()
        return float(self._state.t[0]), float(delta[0])

    def _march_args(self):
        """(T_g, tau, band arrays, F_star_factor, delta, p_interface,
        p_centre) of a march of this world, on its device."""
        delta_nu, p_int, p_c = self._geom_device
        return (self._T_g_tensor(), self.tau_device, self.band_arrays,
                self._F_star_factor, delta_nu, p_int, p_c)

    def evolve_to_equilibrium(self, data_dict=None, flux_thresh=1e-3,
                              T_initial=None, convective_adjust=False,
                              save=False, t_end=4.0, conv_thresh=1e-5,
                              conv_t_multiplier=5, conv_method='reference',
                              chunk_steps=None, verbose=False, check_every=1,
                              dip_memory=False, debug=False):
        """March to equilibrium (base.py:266-335).

        ``save=False`` runs the lock-step march; ``save=True`` the snapshot
        march in chunks of ``chunk_steps`` (256 by default) steps, appending
        every step's time and temperature (and, where ``data_dict`` holds
        'flux' and 'q', the lw/sw flux sums at the post-step temperature and
        the ppmv profiles) to ``data_dict``, as the reference's save_data
        does.  data_dict=None restarts the clock (base.py:301-306).  Raises
        like the JAX package on a non-finite value, a negative temperature,
        or the step cap.

        :param convective_adjust: adjust to convective stability every step,
            with ``conv_method`` 'reference' or 'isotonic' (the iso_fit
            kernel on the card) on the TOA-first column.
        :param chunk_steps: with ``save=False``, return to the host every
            this many steps (``verbose`` alone makes it 1000 and prints a
            line a chunk).
        :param check_every, dip_memory: the exit cadence of the save=False
            march (``column.evolve_to_equilibrium``).
        :param debug: the save=False per-step march with the column march's
            checks: a failure raises ``column.MarchDebugError`` naming the
            first non-finite flux interface, non-finite or negative
            temperature level, its step and simulated time.
        """
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
        march_kw = dict(convective_adjust=convective_adjust,
                        conv_thresh=conv_thresh,
                        conv_t_multiplier=conv_t_multiplier,
                        conv_method=conv_method,
                        cache=self.transmission(self.cache_dtype))
        if save:
            return self._evolve_saving(data_dict, flux_thresh, t_end,
                                       chunk_steps, march_kw)
        if verbose and chunk_steps is None:
            chunk_steps = 1000
        args = self._march_args()

        def march(state, ft, **kw):
            return _real_gas_evolve(state, *args, ft,
                                    check_every=int(check_every),
                                    dip_memory=bool(dip_memory), debug=debug,
                                    **march_kw, **kw)
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
        self._equilibrium_info = eq = column.EquilibriumInfo(
            *(x[0].cpu().numpy() for x in info))
        _raise_on_abort(eq)
        if not bool(eq.equilibrium) and not bool(eq.timed_out):
            raise RuntimeError(
                'march hit the max_steps safety cap without converging or '
                'reaching t_end — use chunk_steps, raise t_end, or loosen '
                'flux_thresh')
        self.up_flux, self.down_flux = self.get_flux()
        self.net_flux = self._state.net_flux[0, :, 0].cpu().numpy()
        data_dict['t'].append(float(self._state.t[0]))
        data_dict['T'].append(self.T)
        return data_dict

    def _evolve_saving(self, data_dict, flux_thresh, t_end, chunk_steps,
                       march_kw):
        """The save=True march (JAX real_gas.py:838-914): chunks of
        per-step snapshots, one host copy a chunk, appended step by step."""
        with_fluxes = 'flux' in data_dict
        with_q = 'q' in data_dict
        sw_mask = self.nu_bands['sw']
        d_nu = self.nu_bands['delta']
        args = self._march_args()
        delta_lw = self._tensor(np.where(sw_mask, 0.0, d_nu))
        delta_sw = self._tensor(np.where(sw_mask, d_nu, 0.0))
        chunk = int(chunk_steps) if chunk_steps else 256
        i0 = 0
        ft = flux_thresh
        t_start = t_chunk_start = data_dict['t'][-1]
        flux_keys = ('lw_up', 'lw_down', 'sw_up', 'sw_down')
        while True:
            # t_end is a whole-march budget: each chunk gets the remainder
            t_end_chunk = float(t_end) - (t_chunk_start - t_start) \
                / SECONDS_PER_YEAR
            self._state, info, snaps = _real_gas_evolve_snapshots(
                self._state, *args[:5], delta_lw, delta_sw, *args[5:], ft,
                n_snaps=chunk, t_end=t_end_chunk, i0=i0,
                with_fluxes=with_fluxes, **march_kw)
            host = {k: (tuple(x[:, 0].cpu().numpy() for x in v)
                        if k == 'extra' else v[:, 0].cpu().numpy())
                    for k, v in snaps.items()}
            prev = i0
            for k in range(chunk):
                if host['steps'][k] <= prev:
                    break                         # march ended mid-chunk
                prev = int(host['steps'][k])
                data_dict['t'].append(float(host['t'][k]))
                data_dict['T'].append(host['T'][k])
                if with_fluxes:
                    for key, fx in zip(flux_keys, host['extra']):
                        data_dict['flux'][key].append(fx[k])
                if with_q:
                    for name in data_dict['q']:
                        q_mol = np.asarray(self.q_funcs[name](
                            self.p[:, 0], *self.q_funcs_args[name]))
                        data_dict['q'][name].append(
                            ppmv_from_humidity(q_mol, name))
            eq = column.EquilibriumInfo(*(x[0].cpu().numpy() for x in info))
            i0 = int(eq.steps)
            ft = info.flux_thresh                # keep the tightened threshold
            t_chunk_start = data_dict['t'][-1]
            _raise_on_abort(eq)
            if bool(eq.equilibrium) or bool(eq.timed_out):
                break
        self._equilibrium_info = eq
        self._state = self._state.replace(
            tsi=column.reset_time_step_info(self._state.tsi))
        self.up_flux, self.down_flux = self.get_flux()
        self.net_flux = self._state.net_flux[0, :, 0].cpu().numpy()
        return data_dict

    # ------------- T_g solvers (real_gas.py:505-562) -------------

    def inital_Tg_guess(self):
        """Newton-solve T_g so the initial column-summed net flux vanishes,
        then rebuild bands/tau at the solution (real_gas.py:505-528)."""
        delta, _p_int, _p_c = self._geom_device
        cache, ba, F = self.transmission(), self.band_arrays, \
            self._F_star_factor

        def f(x):
            T_g = float(np.asarray(x).ravel()[0])
            T_g_t = torch.full((1,), T_g, dtype=self.dtype, device=self.device)
            net = _net_flux(torch.full((1, self.nz - 1), T_g, dtype=self.dtype,
                                       device=self.device),
                            T_g_t, cache, ba, F, delta)
            return float(net.sum())

        self.T_g = float(optimize.newton(f, self.T_g))
        self.T = np.ones_like(self.p) * self.T_g
        T_interface = np.ones(self.nz) * self.T_g
        self._build_wavenumber_machinery()
        self._refresh_tau(T_interface)
        self._set_initial_net_flux()

    def find_Tg(self, flux_thresh=0.1, tol=0.5, convective_adjust=False,
                verbose=False):
        """Outer Newton (secant, scipy) on the TOA flux balance, each
        iteration a full equilibrium march (real_gas.py:530-562)."""
        def f(x):
            self.T_g = float(np.asarray(x).ravel()[0])
            if verbose:
                print(f'Trying T_g = {self.T_g:.1f} K')
            self.evolve_to_equilibrium(flux_thresh=flux_thresh, save=False,
                                       convective_adjust=convective_adjust)
            return float(self.net_flux[0])
        root = optimize.newton(f, self.T_g, tol=tol)
        return float(np.asarray(root).ravel()[0])

    def evolve_change_compos(self, T_g, q_args, data_dict=None,
                             flux_thresh=1e-3, convective_adjust=False,
                             t_end=2.0):
        """Staged composition/T_g sequence, re-equilibrating after each
        change (real_gas.py:748-785)."""
        self.T_g = float(T_g[0])
        self.T = np.ones_like(self.p) * self.T_g
        self._build_wavenumber_machinery()
        T_interface = np.ones(self.nz) * self.T_g
        self.q_funcs_args = q_args[0]
        self._refresh_tau(T_interface)
        for i in range(len(T_g)):
            self.T_g = float(T_g[i])
            self.q_funcs_args = q_args[i]
            self._refresh_tau(T_interface)
            data_dict = self.evolve_to_equilibrium(
                data_dict, flux_thresh=flux_thresh,
                convective_adjust=convective_adjust, t_end=t_end)
            # avoid a slow restart of the next stage (real_gas.py:784)
            tsi = self._state.tsi
            self._state = self._state.replace(
                tsi=tsi.replace(delta_t=tsi.max_delta_t.clone()))
        return data_dict

    # ------------- data -------------

    def save_data(self, data_dict, t):
        """Append T and lw/sw-split flux sums (real_gas.py:720-746)."""
        data_dict['t'].append(t)
        data_dict['T'].append(self.T.copy())
        if 'flux' in data_dict:
            self.up_flux, self.down_flux = self.get_flux()
            sw = self.nu_bands['sw']
            lw = ~sw
            d = self.nu_bands['delta']
            data_dict['flux']['lw_up'].append(
                (self.up_flux[:, lw] * d[lw]).sum(axis=1))
            data_dict['flux']['lw_down'].append(
                (self.down_flux[:, lw] * d[lw]).sum(axis=1))
            data_dict['flux']['sw_up'].append(
                (self.up_flux[:, sw] * d[sw]).sum(axis=1))
            data_dict['flux']['sw_down'].append(
                (self.down_flux[:, sw] * d[sw]).sum(axis=1))
        if 'q' in data_dict:
            for name in data_dict['q']:
                q_mol = np.asarray(self.q_funcs[name](
                    self.p[:, 0], *self.q_funcs_args[name]))
                data_dict['q'][name].append(ppmv_from_humidity(q_mol, name))
        return data_dict

    def plot_olr(self, olr_label='Top of atmosphere', ax=None, show_bands=True):
        """OLR spectrum vs the surface blackbody (real_gas.py:787-810)."""
        import matplotlib.pyplot as plt
        from .column import round_any
        surface_up = np.asarray(B_wavenumber(self.nu_lw, self.T_g)) * np.pi
        if ax is None:
            _, ax = plt.subplots(1, 1)
        ax.plot(self.nu_lw, surface_up, color='k',
                label=f'$T_g={self.T_g:.0f}$K blackbody')
        use = ~self.nu_bands['sw']
        use[np.where(~use == True)[0][0] if (~use).any() else -1] = True
        centres = self.nu_bands['centre'][use]
        if show_bands:
            ax.scatter(centres, np.asarray(B_wavenumber(centres, self.T_g))
                       * np.pi, color='k', s=10)
        ax.plot(centres, self.up_flux[0, use], label=olr_label)
        ax.set_xlim((0, round_any(self.nu_lw.max(), 500, 'ceil')))
        ax.set_ylim((0, round_any(surface_up.max(), 0.05, 'ceil')))
        ax.set_xlabel('Wavenumber cm$^{-1}$')
        ax.set_ylabel('Flux Density ((W/m$^2$)/cm$^{-1}$)')
        ax.legend()
        ax.set_title('Upward Planetary Radiation')
        return ax

    def plot_incoming_short_wave(self, sw_label='Surface', ax=None,
                                 show_bands=True):
        """Incoming solar spectrum at TOA vs surface (real_gas.py:812-837)."""
        import matplotlib.pyplot as plt
        from .column import round_any

        def solar_flux(nu):
            return np.asarray(B_wavenumber(nu, self.star['T'])) * np.pi * \
                self.star['R'] ** 2 / self.star['star_planet_dist'] ** 2 * \
                (1 - self.albedo) / 4
        toa = solar_flux(self.nu_sw)
        if ax is None:
            _, ax = plt.subplots(1, 1)
        ax.plot(self.nu_sw, toa, color='k', label='Top of atmosphere')
        use = self.nu_bands['sw']
        centres = self.nu_bands['centre'][use]
        if show_bands:
            ax.scatter(centres, solar_flux(centres), color='k', s=10)
        ax.plot(centres, self.down_flux[-1, use], label=sw_label)
        ax.set_xlim((0, round_any(self.nu_sw.max(), 10000, 'ceil')))
        ax.set_ylim((0, round_any(toa.max(), 0.005, 'ceil')))
        ax.set_xlabel('Wavenumber cm$^{-1}$')
        ax.set_ylabel('Flux Density ((W/m$^2$)/cm$^{-1}$)')
        ax.legend()
        ax.set_title('Downward Solar Radiation')
        return ax

    def __str__(self):
        return 'Real Gas'
