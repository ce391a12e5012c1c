"""Column-model base machinery: state dataclasses, the adaptive time-step
controller, and the march to equilibrium (port of
``climatemodel_tpu/models/column.py``; reference ``Atmosphere`` base class,
base.py:76-335 of the NumPy original).

Every state here is BATCHED by construction: ``T`` is [B, nz-1, ny] and
every per-march scalar of the JAX package (simulated time, adaptive dt, the
oscillation counters, the loop counter, the exit flags) is a [B] tensor.
A single column is B = 1.  Where the JAX package vmaps a ``lax.while_loop``
over members, the port runs one lock-step loop over the batch: each member
computes ``stop = eqb | failed | nan | timed_out | (i >= max_steps)`` and
every update goes through ``torch.where(stop, old, new)``, so a stopped
member is frozen exactly like a vmapped while-loop's select freezes it.

Ported: the radiative(-convective) march with per-step checks.  Not yet
ported (ROADMAP Queue 1): ``check_every > 1``, ``dip_memory``, ``debug``,
``run_chunked_march`` and ``evolve_snapshots``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..constants import g, c_p_dry, sigma, SECONDS_PER_DAY, SECONDS_PER_YEAR
from ..ops.convection import convective_adjustment
from ..ops.two_stream import percentile_topk_params

# The march loop asks the device whether any member is still running once
# every this many lock-step iterations (one host sync each).  Stopped members
# are frozen, so the up to SYNC_EVERY - 1 iterations past the last member's
# stop are no-ops.  See PERF.md for why 8.
SYNC_EVERY = 8


# --------------------------------------------------------------------------
# Host-side helpers (base.py:10-73)
# --------------------------------------------------------------------------

def round_any(x, base, round_type='round'):
    """Round x to the nearest multiple of base (base.py:10-20)."""
    fn = {'round': np.round, 'ceil': np.ceil, 'floor': np.floor}[round_type]
    return base * fn(x / base)


def t_years_days(t):
    """Seconds -> (whole years, remaining days) (base.py:23-27)."""
    t_full_days = t / SECONDS_PER_DAY
    t_years, t_days = divmod(t_full_days, 365)
    return t_years, t_days


def latitudinal_solar_distribution(latitude, c=0.477):
    """Annually-averaged insolation factor S(phi) = 1 - c/2 (3 sin^2 phi - 1),
    trapz-normalised so integral(0.5 S cos phi dphi) = 1 (base.py:30-48,
    North 1975)."""
    latitude = np.asarray(latitude, dtype=np.float64)
    if latitude.size > 1:
        lat_r = np.radians(latitude)
        lat_dist = 1 - 0.5 * c * (3 * np.sin(lat_r) ** 2 - 1)
        norm = np.trapz(0.5 * lat_dist * np.cos(lat_r), lat_r)
        return lat_dist / norm
    return np.ones_like(latitude)


def get_isothermal_temp(albedo, F_stellar=None, latitude=None, T_star=None,
                        R_star=None, star_planet_dist=None):
    """Equilibrium temperature of a bare planet (base.py:51-73)."""
    if F_stellar is None:
        F_stellar = sigma * T_star ** 4 * R_star ** 2 / star_planet_dist ** 2
    if latitude is not None:
        F_stellar = F_stellar * latitudinal_solar_distribution(latitude)
    return np.power(F_stellar / sigma * (1 - np.asarray(albedo)) / 4, 0.25)


# --------------------------------------------------------------------------
# State dataclasses
# --------------------------------------------------------------------------

class TensorStruct:
    """Dataclass-of-tensors helpers (the port's counterpart of
    ``flax.struct``): ``replace`` and a field-wise ``map`` that recurses into
    nested structs."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def map(self, fn, *others):
        """A new struct with ``fn(field, *other_fields)`` for every tensor
        field (nested structs are mapped field by field)."""
        out = {}
        for f in dataclasses.fields(self):
            mine = getattr(self, f.name)
            theirs = [getattr(o, f.name) for o in others]
            out[f.name] = (mine.map(fn, *theirs)
                           if isinstance(mine, TensorStruct)
                           else fn(mine, *theirs))
        return type(self)(**out)


@dataclasses.dataclass
class TimeStepInfo(TensorStruct):
    """Vectorised form of the reference time_step_info dict
    (base.py:125-128); every field has a leading batch axis."""
    delta_t: torch.Tensor          # [B] 'DeltaT': target max |dT| per step (K)
    max_delta_t: torch.Tensor      # [B] 'MaxDeltaT': ceiling for delta_t
    delta_t_step: torch.Tensor     # [B] 'DeltaT_step': increment for delta_t
    max_tend: torch.Tensor         # [B] 'MaxTend': tendency at controlling level
    max_tend_ind: torch.Tensor     # [B] int32 'MaxTendInd': flat index of it
    dt: torch.Tensor               # [B] 'dt': current time step (s)
    n_same_1: torch.Tensor         # [B] int32 'nSameMaxInd' (oscillation count)
    n_same_2: torch.Tensor         # [B] int32 'nSameMaxInd2' (agreement count)
    removed: torch.Tensor          # [B, (nz-1)*ny] bool 'RemoveInd' mask
    convective: torch.Tensor       # [B, (nz-1)*ny] bool 'convective_levels'


@dataclasses.dataclass
class ColumnState(TensorStruct):
    """Batched radiative column state (grey orientation: surface first)."""
    T: torch.Tensor                # [B, nz-1, ny] cell temperatures
    net_flux: torch.Tensor         # [B, nz, ny] net interface flux (up - down)
    t: torch.Tensor                # [B] simulated time (s)
    tsi: TimeStepInfo


def init_time_step_info(n_levels_flat: int, temp_change: float = 1.0,
                        delta_temp_change: float = 0.01, *, batch: int = 1,
                        dtype=torch.float32, device='cuda') -> TimeStepInfo:
    """Fresh TimeStepInfo for ``batch`` marches (reference time_step_info
    defaults, base.py:125-128), on the card unless ``device`` names another."""
    def f(v):
        return torch.full((batch,), v, dtype=dtype, device=device)

    def i(v):
        return torch.full((batch,), v, dtype=torch.int32, device=device)

    return TimeStepInfo(
        delta_t=f(temp_change), max_delta_t=f(temp_change),
        delta_t_step=f(delta_temp_change), max_tend=f(0.0),
        max_tend_ind=i(-1), dt=f(0.0), n_same_1=i(0), n_same_2=i(0),
        removed=torch.zeros((batch, n_levels_flat), dtype=torch.bool,
                            device=device),
        convective=torch.zeros((batch, n_levels_flat), dtype=torch.bool,
                               device=device))


def reset_time_step_info(tsi: TimeStepInfo) -> TimeStepInfo:
    """Post-equilibrium reset (base.py:329-334)."""
    return tsi.replace(removed=torch.zeros_like(tsi.removed),
                       n_same_1=torch.zeros_like(tsi.n_same_1),
                       n_same_2=torch.zeros_like(tsi.n_same_2),
                       max_tend_ind=torch.full_like(tsi.max_tend_ind, -1))


def _rows(mask, x):
    """``mask`` [B] broadcast against a [B, ...] tensor ``x``."""
    return mask.reshape((-1,) + (1,) * (x.ndim - 1))


def where_members(mask, a, b):
    """Per-member select over structs or tensors: member k takes ``a`` where
    ``mask[k]``, else ``b``."""
    if isinstance(a, TensorStruct):
        return a.map(lambda x, y: torch.where(_rows(mask, x), x, y), b)
    return torch.where(_rows(mask, a), a, b)


# --------------------------------------------------------------------------
# Adaptive time step (base.py:197-246)
# --------------------------------------------------------------------------

def update_time_step(tsi: TimeStepInfo, T_tendency_flat, allowed) -> TimeStepInfo:
    """Pick dt so the fastest-changing allowed level moves by delta_t kelvin,
    with oscillation shrink / agreement grow / freeze bookkeeping.

    :param T_tendency_flat: [B, (nz-1)*ny] temperature tendencies (K/s).
    :param allowed: bool [B, (nz-1)*ny], the ``levels_to_update`` mask.
    """
    masked = torch.where(allowed, torch.abs(T_tendency_flat),
                         float('-inf'))
    # argmax takes the first index among equal maxima, like jnp.argmax
    max_ind = torch.argmax(masked, dim=1).to(torch.int32)
    idx = max_ind.long()[:, None]
    max_tend = torch.gather(T_tendency_flat, 1, idx)[:, 0]

    same = max_ind == tsi.max_tend_ind
    flipped = torch.sign(max_tend) != torch.sign(tsi.max_tend)
    osc = same & flipped                                   # base.py:211-217
    grow = same & ~flipped & (tsi.delta_t < tsi.max_delta_t)  # base.py:218-225
    reset = ~osc & ~grow                                   # base.py:226-228

    delta_t = torch.where(
        osc, torch.maximum(tsi.delta_t - tsi.delta_t_step, tsi.delta_t_step),
        torch.where(grow, torch.minimum(tsi.delta_t + tsi.delta_t_step,
                                        tsi.max_delta_t), tsi.delta_t))
    zero = torch.zeros_like(tsi.n_same_1)
    n1 = torch.where(osc, tsi.n_same_1 + 1,
                     torch.where(reset, zero, tsi.n_same_1))
    n2 = torch.where(grow, tsi.n_same_2 + 1,
                     torch.where(reset, zero, tsi.n_same_2))

    # prolonged oscillation/stagnation freezes the controlling level
    # (base.py:230-239)
    n_removed = tsi.removed.sum(dim=1)
    freeze = ((n1 > 1) & (n2 > 10)) | ((n1 > 20) & (n2 == 0)) | \
             ((n_removed > 3) & ((n1 + n2) > 0))
    was = torch.gather(tsi.removed, 1, idx)[:, 0]
    removed = tsi.removed.scatter(1, idx, (was | freeze)[:, None])
    n1 = torch.where(freeze, zero, n1)
    n2 = torch.where(freeze, zero, n2)

    dt = delta_t / torch.abs(max_tend)
    dt = torch.where(torch.isfinite(dt), dt, float(SECONDS_PER_DAY))  # :244-246
    return tsi.replace(delta_t=delta_t, max_tend=max_tend, max_tend_ind=max_ind,
                       dt=dt, n_same_1=n1, n_same_2=n2, removed=removed)


def _percentile_topk(x, pct):
    """Exact per-member percentile of a [B, ...] tensor via ``torch.topk``
    order statistics — the same two order statistics and the same lerp as
    the default linear-interpolation percentile, selecting only the top
    ~(100-pct)% tail.  A NaN anywhere in a member's values makes that
    member's result NaN (the JAX package reads it from a NaN-first top_k;
    here it is tested directly, which does not depend on where the device's
    top-k sorts NaN)."""
    x = x.reshape(x.shape[0], -1)
    n = x.shape[1]
    m, frac = percentile_topk_params(n, pct)
    top = torch.topk(x, m, dim=1).values
    nan_in = torch.isnan(x).any(dim=1)
    val = top[:, m - 1] if (frac == 0.0 or m < 2) else \
        top[:, m - 1] * (1 - frac) + top[:, m - 2] * frac
    return torch.where(nan_in, float('nan'), val)


def _percentile_from_stats(top1, top_hi, top_lo, n, pct):
    """:func:`_percentile_topk` evaluated from precomputed order statistics
    (the fused net+stats operator's outputs): same two order statistics,
    same lerp, same NaN sentinel.  ``top_hi``/``top_lo`` are the (m-1)-th /
    m-th largest values; when m == 1 the m-th largest IS the maximum, which
    the producer returns as ``top1``."""
    m, frac = percentile_topk_params(n, pct)
    if m < 2:
        val = top1
    elif frac == 0.0:
        val = top_lo
    else:
        val = top_lo * (1 - frac) + top_hi * frac
    return torch.where(torch.isnan(top1), float('nan'), val)


# --------------------------------------------------------------------------
# Temperature update (base.py:130-195)
# --------------------------------------------------------------------------

def update_temp(state: ColumnState, net_flux, p_interface,
                convective_adjust: bool = False,
                net_flux_thresh: float = 1e-7, net_flux_percentile: float = 95,
                delta_stats=None, p_centre_col=None,
                conv_thresh: float = 1e-5, conv_t_multiplier: float = 5.0,
                conv_method: str = 'reference'):
    """One finite-volume temperature update with adaptive dt, per member.

    :param net_flux: [B, nz, ny] freshly computed net flux.
    :param p_interface: [nz, ny] interface pressures (shared by the batch).
    :param delta_stats: optional (top1, top_hi, top_lo) [B] order statistics
        of ``|net_flux - state.net_flux|`` precomputed by the fused
        flux+stats operator (ops/two_stream.grey_net_with_stats).
    :param p_centre_col: [nz-1] cell-centre pressures (surface first), for
        the convective adjustment.
    :param conv_thresh: |T change| above which an allowed level counts as
        convective (base.py:190-192).
    :param conv_t_multiplier: dt factor when the controlling level is
        convective (base.py:182-183).
    :param conv_method: 'reference' or 'isotonic' (ops/convection.py).
    :return: (new_state, delta_net_flux [B])
    """
    T = state.T
    tsi = state.tsi
    B = T.shape[0]
    # finite volume tendency dT/dt = g/c_p * dF/dp (base.py:166-168)
    flux_diff = net_flux[:, 1:, :] - net_flux[:, :-1, :]
    T_tendency = g / c_p_dry * flux_diff / (
        p_interface[1:, :] - p_interface[:-1, :])
    tend_flat = T_tendency.reshape(B, -1)

    first_or_forced = state.t <= 0
    # stagnant levels (|net flux| small) and frozen levels stop updating
    # (base.py:169-177)
    active = torch.abs(net_flux[:, :-1, :].reshape(B, -1)) > net_flux_thresh
    allowed = first_or_forced[:, None] | (active & ~tsi.removed)
    pctl = (_percentile_from_stats(*delta_stats, net_flux[0].numel(),
                                   net_flux_percentile)
            if delta_stats is not None else
            _percentile_topk(torch.abs(net_flux - state.net_flux),
                             net_flux_percentile))
    delta_net_flux = torch.where(first_or_forced, 1e6, pctl.to(T.dtype))

    any_allowed = allowed.any(dim=1)
    tsi = where_members(any_allowed, update_time_step(tsi, tend_flat, allowed),
                        tsi)
    dt = tsi.dt
    if convective_adjust:
        # convective-region speed-up (base.py:182-183).  max_tend_ind is -1
        # for a member that has no allowed level and kept a reset controller;
        # the JAX package's gather wraps it to the last level and masks the
        # result with any_allowed, so any in-range index does here.
        ind = tsi.max_tend_ind.long().clamp(min=0)[:, None]
        in_conv = torch.gather(tsi.convective, 1, ind)[:, 0]
        dt = torch.where(any_allowed & in_conv, dt * conv_t_multiplier, dt)
        tsi = tsi.replace(dt=dt)
    T_new = torch.where(allowed.reshape(T.shape),
                        T + dt[:, None, None] * T_tendency, T)
    if convective_adjust:
        T_adj = convective_adjustment(p_centre_col, T_new, descending=True,
                                      method=conv_method)
        conv_mask = allowed & ((T_adj - T_new).abs().reshape(B, -1)
                               > conv_thresh)             # base.py:190-192
        tsi = tsi.replace(convective=conv_mask)
        T_new = T_adj
    new_state = state.replace(T=T_new, net_flux=net_flux, t=state.t + dt,
                              tsi=tsi)
    return new_state, delta_net_flux


def check_equilibrium(net_flux, delta_net_flux, flux_thresh=1e-3,
                      use_delta_exit=True, net_absmax=None):
    """Per member: max|F_net| < thresh or (optionally) delta F < thresh
    (base.py:248-264).  ``net_absmax`` optionally supplies a precomputed
    [B] max|net_flux| (the fused flux+stats operator's)."""
    absmax = (torch.amax(torch.abs(net_flux).reshape(net_flux.shape[0], -1),
                         dim=1)
              if net_absmax is None else net_absmax)
    eqb = absmax < flux_thresh
    if use_delta_exit:
        eqb = eqb | (delta_net_flux < flux_thresh)
    return eqb


# --------------------------------------------------------------------------
# March to equilibrium (base.py:266-335)
# --------------------------------------------------------------------------

class EquilibriumInfo(NamedTuple):
    """Per-member exit telemetry ([B] each): step count, final delta
    statistic, the (possibly tightened) threshold and the disjoint exit
    flags."""
    steps: torch.Tensor
    delta_net_flux: torch.Tensor
    flux_thresh: torch.Tensor
    failed: torch.Tensor           # temperature went negative (base.py:319-320)
    equilibrium: torch.Tensor      # TRUE convergence (flux/delta criterion)
    nan: torch.Tensor              # non-finite T or flux appeared
    timed_out: torch.Tensor        # hit the t_end cap WITHOUT converging


def _exit_flags(st, net, delta, ft, t0, t_end, use_delta_exit, absmax=None):
    """The per-step stop criteria of every member, evaluated in one place
    (column.py:517-528 of the JAX package)."""
    B = st.T.shape[0]
    eqb = check_equilibrium(st.net_flux, delta, ft, use_delta_exit,
                            net_absmax=absmax)
    failed = torch.amin(st.T.reshape(B, -1), dim=1) < 0
    # NaN/inf sentinel: stop the member on the first non-finite T or flux
    nan = ~(torch.isfinite(st.T).reshape(B, -1).all(dim=1)
            & torch.isfinite(net).reshape(B, -1).all(dim=1))
    tout = ((st.t - t0) / SECONDS_PER_YEAR > t_end) & ~eqb
    return eqb, failed, nan, tout


def march_step(st: ColumnState, ft, i, t0, net_flux_fn, p_interface, *,
               t_end, net_flux_thresh=1e-7, net_flux_percentile=95,
               use_delta_exit=True, net_stats_fn=None, **conv_kw):
    """One march step of every member, unmasked: the port's counterpart of
    the body of the JAX package's while-loop (column.py:578-633).

    :param ft, i, t0: [B] exit threshold, step count before this step, and
        simulated time at the start of the march.
    :param conv_kw: ``convective_adjust``, ``p_centre_col``, ``conv_thresh``,
        ``conv_t_multiplier`` and ``conv_method`` of :func:`update_temp`.
    :return: (state, ft, delta, eqb, failed, nan, timed_out) after the step.
    """
    if net_stats_fn is not None:
        net, top1, top_hi, top_lo, absmax = net_stats_fn(st.T, st.net_flux)
        stats = (top1, top_hi, top_lo)
    else:
        net = net_flux_fn(st.T)
        stats = absmax = None
    st, delta = update_temp(st, net, p_interface,
                            net_flux_thresh=net_flux_thresh,
                            net_flux_percentile=net_flux_percentile,
                            delta_stats=stats, **conv_kw)
    # the second iteration tightens the threshold (base.py:315-317)
    ft = torch.where(i == 1, torch.minimum(ft, 0.99 * delta), ft)
    flags = _exit_flags(st, net, delta, ft, t0, t_end, use_delta_exit,
                        absmax=absmax)
    return (st, ft, delta) + flags


def evolve_to_equilibrium(state: ColumnState, net_flux_fn: Callable,
                          p_interface, p_centre_col=None, *,
                          flux_thresh=1e-3, convective_adjust: bool = False,
                          t_end: float = 4.0, conv_thresh: float = 1e-5,
                          conv_t_multiplier: float = 5.0,
                          net_flux_thresh: float = 1e-7,
                          net_flux_percentile: float = 95,
                          max_steps: int = 500_000, use_delta_exit: bool = True,
                          conv_method: str = 'reference',
                          i0=0, final_reset: bool = True, check_every: int = 1,
                          dip_memory: bool = False, debug: bool = False,
                          net_stats_fn: Callable | None = None):
    """Lock-step march of a batch of columns to radiative equilibrium.

    Each member follows its own march exactly as the JAX package's vmapped
    ``lax.while_loop`` does: its own adaptive dt and controller, its own
    clock, loop counter and threshold (tightened at its second step,
    base.py:315-317), and it freezes at its own first stop event
    (equilibrium, negative T, non-finite values, t_end, or ``max_steps``).

    :param net_flux_fn: T [B, nz-1, ny] -> net flux [B, nz, ny].
    :param p_centre_col: [nz-1] cell-centre pressures (surface first), for
        the convective adjustment; unused by the radiative march.
    :param flux_thresh: float or [B] exit threshold.
    :param convective_adjust: adjust every step to convective stability
        (ops/convection.py) with ``conv_method`` 'reference' or 'isotonic';
        ``conv_thresh`` and ``conv_t_multiplier`` as in :func:`update_temp`.
    :param t_end: cap in simulated years (base.py:322).
    :param i0: starting step count (float or [B]).
    :param final_reset: reset the time-step bookkeeping on exit
        (base.py:329-334).
    :param net_stats_fn: optional fused flux+statistics operator
        ``(T, prev_net) -> (net, top1, top_hi, top_lo, max|net|)``
        (ops/two_stream.grey_net_with_stats) replacing ``net_flux_fn`` and
        the in-march percentile/flux-balance reductions.
    :return: (final ColumnState, EquilibriumInfo)
    """
    if check_every != 1 or dip_memory or debug:
        raise NotImplementedError(
            'check_every > 1, dip_memory and debug are not ported yet '
            '(ROADMAP Queue 1)')
    T = state.T
    B, dtype, device = T.shape[0], T.dtype, T.device

    def per_member(v, dt):
        return torch.broadcast_to(
            torch.as_tensor(v, dtype=dt, device=device), (B,)).clone()

    t0 = state.t
    st = state
    ft = per_member(flux_thresh, dtype)
    delta = per_member(1e6, dtype)
    i = per_member(i0, torch.int32)
    no = torch.zeros((B,), dtype=torch.bool, device=device)
    eqb, failed, nan, tout = no, no, no, no
    conv_kw = (dict(convective_adjust=True, p_centre_col=p_centre_col,
                    conv_thresh=conv_thresh,
                    conv_t_multiplier=conv_t_multiplier,
                    conv_method=conv_method) if convective_adjust else {})

    it = 0
    while True:
        stop = eqb | failed | nan | tout | (i >= max_steps)
        # one device->host sync every SYNC_EVERY iterations; stopped members
        # are frozen, so the iterations in between are no-ops for them
        if it % SYNC_EVERY == 0 and bool(stop.all()):
            break
        it += 1
        new = march_step(st, ft, i, t0, net_flux_fn, p_interface,
                         t_end=t_end, net_flux_thresh=net_flux_thresh,
                         net_flux_percentile=net_flux_percentile,
                         use_delta_exit=use_delta_exit,
                         net_stats_fn=net_stats_fn, **conv_kw)
        st, ft, delta, eqb, failed, nan, tout = (
            where_members(stop, old, upd) for old, upd in
            zip((st, ft, delta, eqb, failed, nan, tout), new))
        i = torch.where(stop, i, i + 1)
    if final_reset:
        st = st.replace(tsi=reset_time_step_info(st.tsi))
    return st, EquilibriumInfo(steps=i, delta_net_flux=delta, flux_thresh=ft,
                               failed=failed, equilibrium=eqb, nan=nan,
                               timed_out=tout)
