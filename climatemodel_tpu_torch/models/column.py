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

The march runs with per-step checks, with ``check_every`` steps a check
(optionally with ``dip_memory``), under the host-side ``debug`` check, in
host-driven chunks (:func:`run_chunked_march`) or stacking a snapshot a
step (:func:`evolve_snapshots`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..constants import g, c_p_dry, sigma, SECONDS_PER_DAY, SECONDS_PER_YEAR
from ..ops.convection import convective_adjustment
from ..ops.two_stream import percentile_topk_params
from ..utils import timing

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
        field (nested structs are mapped field by field; a field that is
        None stays None)."""
        out = {}
        for f in dataclasses.fields(self):
            mine = getattr(self, f.name)
            theirs = [getattr(o, f.name) for o in others]
            out[f.name] = (None if mine is None else
                           mine.map(fn, *theirs)
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
    """Batched radiative column state, in the owning model's orientation
    (grey: surface first; real gas: TOA first)."""
    T: torch.Tensor                # [B, nz-1, ny] cell temperatures
    net_flux: torch.Tensor         # [B, nz, ny] net interface flux (up - down)
    t: torch.Tensor                # [B] simulated time (s)
    tsi: TimeStepInfo


def init_time_step_info(n_levels_flat: int, temp_change: float = 1.0,
                        delta_temp_change: float = 0.01, dtype=torch.float32,
                        *, batch: int = 1, device='cuda') -> TimeStepInfo:
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

def update_temp(state: ColumnState, net_flux, p_interface, p_centre_col=None,
                changing_tau: bool = False, convective_adjust: bool = False,
                net_flux_thresh: float = 1e-7, net_flux_percentile: float = 95,
                conv_thresh: float = 1e-5, conv_t_multiplier: float = 5.0,
                p_descending: bool = True, conv_method: str = 'reference',
                net_flux_diff=None, compute_delta: bool = True,
                delta_stats=None):
    """One finite-volume temperature update with adaptive dt, per member.

    :param net_flux: [B, nz, ny] freshly computed net flux.
    :param p_interface: [nz, ny] interface pressures (shared by the batch),
        in the model's own orientation.
    :param changing_tau: the forcing changed since the last step: every
        level updates and the delta statistic reads 1e6, as on the first
        step (base.py:169-177).
    :param compute_delta: False skips the delta statistic and returns None
        for it (the reduced steps of a ``check_every`` march).
    :param delta_stats: optional (top1, top_hi, top_lo) [B] order statistics
        of ``|net_flux - state.net_flux|`` precomputed by the fused
        flux+stats operator (ops/two_stream.grey_net_with_stats).
    :param p_centre_col: [nz-1] cell-centre pressures (the model's
        orientation), for the convective adjustment.
    :param conv_thresh: |T change| above which an allowed level counts as
        convective (base.py:190-192).
    :param conv_t_multiplier: dt factor when the controlling level is
        convective (base.py:182-183).
    :param conv_method: 'reference' or 'isotonic' (ops/convection.py).
    :param p_descending: the orientation of the pressure axis: True for the
        grey model (surface first), False for the real-gas model (TOA
        first); the convective adjustment reads it.
    :param net_flux_diff: optional [B, nz-1, ny] adjacent-interface
        difference ``net_flux[:, 1:] - net_flux[:, :-1]`` formed by the
        caller in a better-conditioned order (the real-gas model differences
        each band before the band sum); the tendency uses it in place of
        the difference of ``net_flux`` (JAX column.py:235-244).
    :return: (new_state, delta_net_flux [B])
    """
    T = state.T
    tsi = state.tsi
    B = T.shape[0]
    # finite volume tendency dT/dt = g/c_p * dF/dp (base.py:166-168)
    flux_diff = (net_flux[:, 1:, :] - net_flux[:, :-1, :]
                 if net_flux_diff is None else net_flux_diff)
    T_tendency = g / c_p_dry * flux_diff / (
        p_interface[1:, :] - p_interface[:-1, :])
    tend_flat = T_tendency.reshape(B, -1)

    first_or_forced = (state.t <= 0) | bool(changing_tau)
    # stagnant levels (|net flux| small) and frozen levels stop updating
    # (base.py:169-177)
    active = torch.abs(net_flux[:, :-1, :].reshape(B, -1)) > net_flux_thresh
    allowed = first_or_forced[:, None] | (active & ~tsi.removed)
    delta_net_flux = None
    if compute_delta:
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
        T_adj = convective_adjustment(p_centre_col, T_new,
                                      descending=p_descending,
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


def split_net(out):
    """(net, net_diff) of a net flux function's result: it returns either
    the net flux or (net, net_diff) with a better-conditioned
    adjacent-interface difference (see :func:`update_temp`)."""
    return out if isinstance(out, tuple) else (out, None)


def march_step(st: ColumnState, ft, i, t0, net_flux_fn, p_interface, *,
               t_end, net_flux_thresh=1e-7, net_flux_percentile=95,
               use_delta_exit=True, net_stats_fn=None, **conv_kw):
    """One march step of every member, unmasked: the port's counterpart of
    the body of the JAX package's while-loop (column.py:578-633).

    :param ft, i, t0: [B] exit threshold, step count before this step, and
        simulated time at the start of the march.
    :param net_flux_fn: T -> net flux, or T -> (net, net_diff).
    :param conv_kw: ``convective_adjust``, ``p_centre_col``, ``conv_thresh``,
        ``conv_t_multiplier``, ``conv_method`` and ``p_descending`` of
        :func:`update_temp`.
    :return: (state, ft, delta, eqb, failed, nan, timed_out) after the step.
    """
    net_diff = None
    if net_stats_fn is not None:
        net, top1, top_hi, top_lo, absmax = net_stats_fn(st.T, st.net_flux)
        stats = (top1, top_hi, top_lo)
    else:
        net, net_diff = split_net(net_flux_fn(st.T))
        stats = absmax = None
    st, delta = update_temp(st, net, p_interface,
                            net_flux_thresh=net_flux_thresh,
                            net_flux_percentile=net_flux_percentile,
                            delta_stats=stats, net_flux_diff=net_diff,
                            **conv_kw)
    # the second iteration tightens the threshold (base.py:315-317)
    ft = torch.where(i == 1, torch.minimum(ft, 0.99 * delta), ft)
    flags = _exit_flags(st, net, delta, ft, t0, t_end, use_delta_exit,
                        absmax=absmax)
    return (st, ft, delta) + flags


class MarchDebugError(RuntimeError):
    """Raised by a ``debug=True`` march: names the first non-finite net flux
    interface, non-finite temperature level or negative temperature level,
    with its step and simulated time."""


class _DebugRecord:
    """The first failure of each member of a ``debug`` march, recorded on
    the device without a host sync.  ``kind`` is 0 (none), 1 (non-finite
    net flux), 2 (non-finite temperature) or 3 (negative temperature): the
    order in which the JAX package checks them (column.py:599-624), so the
    first failing check of the first failing step is kept, as checkify
    keeps it."""

    _MESSAGES = {
        1: 'march debug: non-finite net flux first at flat interface {lev} '
           '(step {i}, t={t} s) — the radiation operator produced NaN/inf '
           'from this state',
        2: 'march debug: non-finite temperature first at flat level {lev} '
           '(step {i}, t={t} s)',
        3: 'march debug: temperature {tmin} K below zero first at flat level '
           '{lev} (step {i}, t={t} s) — the reference aborts here too '
           '(base.py:319-320)'}

    def __init__(self, B, dtype, device):
        self.kind = torch.zeros((B,), dtype=torch.int32, device=device)
        self.lev = torch.zeros((B,), dtype=torch.int64, device=device)
        self.step = torch.zeros((B,), dtype=torch.int32, device=device)
        self.t = torch.zeros((B,), dtype=dtype, device=device)
        self.tmin = torch.zeros((B,), dtype=dtype, device=device)

    def update(self, st, go, step):
        """Record the failures of the step that produced ``st`` (its net
        flux is ``st.net_flux``) for the members in ``go`` that have none
        yet; ``step`` [B] is the step count after it."""
        B = st.T.shape[0]
        bad_net = ~torch.isfinite(st.net_flux).reshape(B, -1)
        T = st.T.reshape(B, -1)
        bad_T = ~torch.isfinite(T)
        tmin = torch.amin(T, dim=1)
        kind = torch.where(bad_net.any(dim=1), 1, torch.where(
            bad_T.any(dim=1), 2, torch.where(tmin < 0, 3, 0)))
        # argmax takes the first index among equal maxima
        lev = torch.where(kind == 1, bad_net.to(torch.uint8).argmax(dim=1),
                          torch.where(kind == 2,
                                      bad_T.to(torch.uint8).argmax(dim=1),
                                      T.argmin(dim=1)))
        new = go & (self.kind == 0) & (kind > 0)
        self.kind = torch.where(new, kind.to(torch.int32), self.kind)
        self.lev = torch.where(new, lev, self.lev)
        self.step = torch.where(new, step, self.step)
        self.t = torch.where(new, st.t, self.t)
        self.tmin = torch.where(new, tmin, self.tmin)

    def raise_first(self, offset=0, n_members=None):
        """Raise :class:`MarchDebugError` for the first member (by index)
        that recorded a failure; return if none did.  ``offset``: the index
        of this record's first member among ``n_members`` (a shard's)."""
        kind = self.kind.cpu()
        failing = torch.nonzero(kind > 0)
        if len(failing) == 0:
            return
        m = int(failing[0, 0])
        msg = self._MESSAGES[int(kind[m])].format(
            lev=int(self.lev[m]), i=int(self.step[m]), t=float(self.t[m]),
            tmin=float(self.tmin[m]))
        raise MarchDebugError(msg if (n_members or kind.numel()) == 1 else
                              f'member {offset + m}: {msg}')


class _Lockstep:
    """The carry of a lock-step march of B members: the state, exit
    threshold, delta statistic and exit flags (``carry``) and the step
    count ``i``.  A member is stopped once it converged, failed, went
    non-finite, timed out or reached ``max_steps``; every step keeps the
    members it is told to freeze exactly as they were, as a vmapped
    while-loop's select keeps them."""

    def __init__(self, state, net_flux_fn, p_interface, *, flux_thresh, i0,
                 max_steps, t_end, net_flux_thresh, net_flux_percentile,
                 use_delta_exit, net_stats_fn, conv_kw, debug=False):
        B, dtype, device = state.T.shape[0], state.T.dtype, state.T.device

        def per_member(v, dt):
            return torch.broadcast_to(
                torch.as_tensor(v, dtype=dt, device=device), (B,)).clone()

        no = torch.zeros((B,), dtype=torch.bool, device=device)
        self.no = no
        self.carry = (state, per_member(flux_thresh, dtype),
                      per_member(1e6, dtype), no, no, no, no)
        self.i = per_member(i0, torch.int32)
        self.t0 = state.t
        self.max_steps = max_steps
        self.net_flux_fn, self.p_interface = net_flux_fn, p_interface
        self.net_stats_fn = net_stats_fn
        # update_temp's keywords, and march_step's
        self.update_kw = dict(net_flux_thresh=net_flux_thresh,
                              net_flux_percentile=net_flux_percentile,
                              **conv_kw)
        self.step_kw = dict(t_end=t_end, use_delta_exit=use_delta_exit,
                            net_stats_fn=net_stats_fn, **self.update_kw)
        self.record = _DebugRecord(B, dtype, device) if debug else None

    def stopped(self):
        _st, _ft, _delta, eqb, failed, nan, tout = self.carry
        return eqb | failed | nan | tout | (self.i >= self.max_steps)

    def _full(self, st, i):
        return march_step(st, self.carry[1], i, self.t0, self.net_flux_fn,
                          self.p_interface, **self.step_kw)

    def _keep(self, frozen, new, i_new):
        self.carry = tuple(where_members(frozen, old, upd)
                           for old, upd in zip(self.carry, new))
        self.i = torch.where(frozen, self.i, i_new)

    def step(self, frozen):
        """One fully checked step (JAX column.py:578-633 with
        ``check_every=1``)."""
        new = self._full(self.carry[0], self.i)
        if self.record is not None:
            self.record.update(new[0], ~frozen, self.i + 1)
        self._keep(frozen, new, self.i + 1)

    def chunk(self, K, frozen):
        """K - 1 reduced steps (physics and the dt controller, no delta
        statistic), then one fully checked step; a negative or non-finite
        value in a reduced step is kept and reported at the check
        (JAX column.py:582-597)."""
        st, i = self.carry[0], self.i
        failed = nan = self.no
        for _ in range(K - 1):
            net_diff = None
            if self.net_stats_fn is not None:
                net = self.net_stats_fn(st.T, st.net_flux)[0]
            else:
                net, net_diff = split_net(self.net_flux_fn(st.T))
            st, _ = update_temp(st, net, self.p_interface,
                                compute_delta=False, net_flux_diff=net_diff,
                                **self.update_kw)
            B = st.T.shape[0]
            failed = failed | (torch.amin(st.T.reshape(B, -1), dim=1) < 0)
            nan = nan | ~(torch.isfinite(st.T).reshape(B, -1).all(dim=1)
                          & torch.isfinite(net).reshape(B, -1).all(dim=1))
            i = i + 1
        st, ft, delta, eqb, f_now, n_now, tout = self._full(st, i)
        self._keep(frozen, (st, ft, delta, eqb, failed | f_now, nan | n_now,
                            tout), i + 1)

    def info(self):
        st, ft, delta, eqb, failed, nan, tout = self.carry
        return EquilibriumInfo(steps=self.i, delta_net_flux=delta,
                               flux_thresh=ft, failed=failed, equilibrium=eqb,
                               nan=nan, timed_out=tout)


def _conv_kw(convective_adjust, p_centre_col, conv_thresh, conv_t_multiplier,
             conv_method, p_descending):
    return (dict(convective_adjust=True, p_centre_col=p_centre_col,
                 conv_thresh=conv_thresh, conv_t_multiplier=conv_t_multiplier,
                 conv_method=conv_method, p_descending=p_descending)
            if convective_adjust else {})


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
                          net_stats_fn: Callable | None = None,
                          p_descending: bool = True):
    """Lock-step march of a batch of columns to radiative equilibrium.

    Each member follows its own march exactly as the JAX package's vmapped
    ``lax.while_loop`` does: its own adaptive dt and controller, its own
    clock, loop counter and threshold (tightened at its second step,
    base.py:315-317), and it freezes at its own first stop event
    (equilibrium, negative T, non-finite values, t_end, or ``max_steps``).

    :param net_flux_fn: T [B, nz-1, ny] -> net flux [B, nz, ny], or ->
        (net, net_diff [B, nz-1, ny]) with the tendency's flux difference
        (see :func:`update_temp`).
    :param p_centre_col: [nz-1] cell-centre pressures, for the convective
        adjustment; unused by the radiative march.
    :param p_descending: the grid's orientation (True: surface first, the
        grey model; False: TOA first, the real-gas model).
    :param flux_thresh: float or [B] exit threshold.
    :param convective_adjust: adjust every step to convective stability
        (ops/convection.py) with ``conv_method`` 'reference' or 'isotonic';
        ``conv_thresh`` and ``conv_t_multiplier`` as in :func:`update_temp`.
    :param t_end: cap in simulated years (base.py:322).
    :param i0: starting step count (float or [B]).
    :param final_reset: reset the time-step bookkeeping on exit
        (base.py:329-334).
    :param check_every: K > 1 checks the exit every K steps (JAX
        column.py:370-388): the first two steps are fully checked, so the
        i == 1 tightening samples the same delta, then each chunk runs K - 1
        reduced steps (physics and the dt controller, no delta statistic)
        and one fully checked step.  A member stops at the first check that
        sees a stop event, up to K - 1 steps past the per-step exit (and
        past ``max_steps``); a negative or non-finite value in a reduced
        step still stops it at that check.
    :param dip_memory: with K > 1, every step of a chunk is fully checked
        and a member freezes at its first stop event, the step cap
        included, so the march is the per-step one bit for bit, only its
        detection deferred (JAX column.py:389-404).  The loop here already
        freezes each member at its own stop event and reads the stop flags
        once every SYNC_EVERY iterations, so it runs that loop.
    :param debug: check every step on the device for a non-finite net
        flux, a non-finite temperature and a negative temperature, and
        after the march raise :class:`MarchDebugError` naming the first
        failure's flat index, step and simulated time (the JAX package's
        checkify checks, column.py:405-415).  Per-step checks only; a
        healthy debug march is bit-identical to a plain one.
    :param net_stats_fn: optional fused flux+statistics operator
        ``(T, prev_net) -> (net, top1, top_hi, top_lo, max|net|)``
        (ops/two_stream.grey_net_with_stats) replacing ``net_flux_fn`` and
        the in-march percentile/flux-balance reductions.
    :return: (final ColumnState, EquilibriumInfo)
    """
    [(st, info)], _ = evolve_to_equilibrium_sharded(
        [state], [net_flux_fn], [p_interface], [p_centre_col],
        net_stats_fns=[net_stats_fn], flux_thresh=flux_thresh,
        convective_adjust=convective_adjust, t_end=t_end,
        conv_thresh=conv_thresh, conv_t_multiplier=conv_t_multiplier,
        net_flux_thresh=net_flux_thresh,
        net_flux_percentile=net_flux_percentile, max_steps=max_steps,
        use_delta_exit=use_delta_exit, conv_method=conv_method, i0=i0,
        final_reset=final_reset, check_every=check_every,
        dip_memory=dip_memory, debug=debug, p_descending=p_descending)
    return st, info


@timing.spanned('march', top=True)
def evolve_to_equilibrium_sharded(states, net_flux_fns, p_interfaces,
                                  p_centre_cols=None, *, net_stats_fns=None,
                                  flux_thresh=1e-3,
                                  convective_adjust: bool = False,
                                  t_end: float = 4.0,
                                  conv_thresh: float = 1e-5,
                                  conv_t_multiplier: float = 5.0,
                                  net_flux_thresh: float = 1e-7,
                                  net_flux_percentile: float = 95,
                                  max_steps: int = 500_000,
                                  use_delta_exit: bool = True,
                                  conv_method: str = 'reference', i0=0,
                                  final_reset: bool = True,
                                  check_every: int = 1,
                                  dip_memory: bool = False,
                                  debug: bool = False,
                                  p_descending: bool = True,
                                  member_offsets=None, n_members=None):
    """:func:`evolve_to_equilibrium` of S shards of members at once, one
    lock-step march per shard, each on its own tensors' device: the shards
    of a member-sharded ensemble (``parallel/ensemble.py``).

    Every iteration steps each shard that has not stopped (queued on its
    own device, so the cards run while the host dispatches), and the host
    reads every shard's stop flags once every SYNC_EVERY iterations.  The
    call is the span ``march`` (``utils/timing.py``), each shard's step the
    span ``march.step``, each read of the stop flags ``march.stop_check``;
    the counter ``march.iterations`` counts the iterations that step.  A
    member's march is the unsharded one step for step: members are
    independent, and a stopped member is frozen.  The keywords are
    :func:`evolve_to_equilibrium`'s.

    :param states, net_flux_fns, p_interfaces: per-shard lists.
    :param p_centre_cols, net_stats_fns: per-shard lists, or None.
    :param flux_thresh: a float, or a per-shard list (of floats or of a
        shard's [B_s] tensors).
    :param member_offsets, n_members: each shard's first member in the
        whole ensemble, and its size, for a debug march's message (default:
        the shards one after the other, the whole ensemble theirs).
    :return: (per-shard list of (final ColumnState, EquilibriumInfo), the
        lock-step iterations each shard ran).
    """
    if debug and check_every > 1:
        raise ValueError('debug=True needs per-step checks (check_every=1): '
                         'the failing step/level is the whole point')
    n = len(states)
    p_centre_cols = p_centre_cols or [None] * n
    net_stats_fns = net_stats_fns or [None] * n

    if not isinstance(flux_thresh, list):
        flux_thresh = [flux_thresh] * n
    marches = [
        _Lockstep(st, fn, p_int, flux_thresh=ft, i0=i0,
                  max_steps=max_steps, t_end=t_end,
                  net_flux_thresh=net_flux_thresh,
                  net_flux_percentile=net_flux_percentile,
                  use_delta_exit=use_delta_exit, net_stats_fn=stats_fn,
                  conv_kw=_conv_kw(convective_adjust, p_c, conv_thresh,
                                   conv_t_multiplier, conv_method,
                                   p_descending),
                  debug=debug)
        for st, fn, p_int, p_c, stats_fn, ft in zip(
            states, net_flux_fns, p_interfaces, p_centre_cols,
            net_stats_fns, flux_thresh)]
    chunked = check_every > 1 and not dip_memory
    if chunked:
        # the fully checked two-step prefix (a no-op where i0 >= 2)
        for _ in range(2):
            for march in marches:
                march.step(march.stopped() | (march.i >= 2))
    # one device->host sync a shard every SYNC_EVERY steps; stopped members
    # are frozen, so the iterations in between are no-ops for them
    per_sync = max(1, SYNC_EVERY // check_every) if chunked else SYNC_EVERY
    iterations = [0] * n
    running = list(range(n))
    it = 0
    while running:
        stops = {k: marches[k].stopped() for k in running}
        if it % per_sync == 0:
            done = {k: s.all() for k, s in stops.items()}  # queued first
            with timing.span('march.stop_check'):
                running = [k for k in running if not bool(done[k])]
            if not running:
                break
        it += 1
        timing.count('march.iterations')
        for k in running:
            iterations[k] += 1
            with timing.span('march.step'):
                if chunked:
                    marches[k].chunk(int(check_every), stops[k])
                else:
                    marches[k].step(stops[k])
    sizes = [m.i.numel() for m in marches]
    if member_offsets is None:
        member_offsets = [sum(sizes[:k]) for k in range(n)]
    for march, offset in zip(marches, member_offsets):
        if march.record is not None:
            march.record.raise_first(offset, n_members or sum(sizes))
    out = []
    for march in marches:
        st = march.carry[0]
        if final_reset:
            st = st.replace(tsi=reset_time_step_info(st.tsi))
        out.append((st, march.info()))
    return out, iterations


def run_chunked_march(state: ColumnState, evolve: Callable, *, t_host_start,
                      t_end, chunk_steps, flux_thresh, verbose=False):
    """Drive the save=False march of a single world (a batch of one) in
    chunks of ``chunk_steps`` steps, back on the host between chunks (JAX
    column.py:637-678).

    ``evolve(state, ft, i0=, t_end=, max_steps=)`` runs the march with
    ``final_reset=False`` and returns ``(state, EquilibriumInfo)``.  Each
    chunk gets what is left of the whole march's t_end budget and carries
    the tightened threshold on; ``verbose`` prints the reference's
    per-chunk line (base.py:324-327).  Returns ``(state, info)`` with the
    controller reset (base.py:329-334).
    """
    i0 = 0
    ft = flux_thresh
    t_start = t_chunk_start = t_host_start
    while True:
        t_end_chunk = float(t_end) - (t_chunk_start - t_start) \
            / SECONDS_PER_YEAR
        state, info = evolve(state, ft, i0=i0, t_end=t_end_chunk,
                             max_steps=i0 + int(chunk_steps))
        i0 = int(info.steps[0])
        ft = info.flux_thresh                # keep the tightened threshold
        t_chunk_start = float(state.t[0])
        if verbose:
            print(f'step {i0}: t = {t_chunk_start / SECONDS_PER_YEAR:.3f} yr, '
                  f'delta_net_flux = {float(info.delta_net_flux[0]):.4f}')
        if bool((info.equilibrium | info.timed_out | info.failed
                 | info.nan)[0]):
            break
    state = state.replace(tsi=reset_time_step_info(state.tsi))
    return state, info


def evolve_snapshots(state: ColumnState, net_flux_fn: Callable, p_interface,
                     p_centre_col=None, *, n_snaps: int,
                     steps_per_snap: int = 1,
                     snapshot_fn: Callable | None = None,
                     flux_thresh=1e-3, convective_adjust: bool = False,
                     t_end: float = 4.0, conv_thresh: float = 1e-5,
                     conv_t_multiplier: float = 5.0,
                     net_flux_thresh: float = 1e-7,
                     net_flux_percentile: float = 95,
                     use_delta_exit: bool = True,
                     conv_method: str = 'reference', i0=0,
                     snapshot_on: str = 'pre', p_descending: bool = True):
    """March that stacks a snapshot every ``steps_per_snap`` steps, for
    ``n_snaps`` snapshots (JAX column.py:680-758): the per-step march, each
    member frozen at its stop event (there is no step cap but the
    snapshots).  Once every member has stopped, the remaining snapshots
    repeat the final state, as the JAX package's scan emits them; callers
    truncate by the snapshots' ``steps``.

    :param snapshot_fn: optional ``T -> tuple of tensors`` of extra
        per-snapshot arrays (the grey model's four flux fields, the
        real-gas model's lw/sw flux sums).
    :param snapshot_on: 'pre' evaluates ``snapshot_fn`` on the temperature
        before the snapshot's steps (the grey reference's save_data stores
        the fluxes of a step's starting temperature, grey.py:296-383);
        'post' on the temperature after them.
    :return: (final state, EquilibriumInfo, snaps): snaps maps 't', 'T',
        'delta', 'steps', 'equilibrium', 'failed', 'nan' and 'timed_out'
        (and 'extra', a tuple, with ``snapshot_fn``) to tensors stacked
        along a leading [n_snaps] axis before the member axis.
    """
    if snapshot_on not in ('pre', 'post'):
        raise ValueError(f'snapshot_on must be pre or post, got '
                         f'{snapshot_on!r}')
    march = _Lockstep(state, net_flux_fn, p_interface, flux_thresh=flux_thresh,
                      i0=i0, max_steps=torch.iinfo(torch.int32).max,
                      t_end=t_end, net_flux_thresh=net_flux_thresh,
                      net_flux_percentile=net_flux_percentile,
                      use_delta_exit=use_delta_exit, net_stats_fn=None,
                      conv_kw=_conv_kw(convective_adjust, p_centre_col,
                                       conv_thresh, conv_t_multiplier,
                                       conv_method, p_descending))

    def snap(extra):
        st, _ft, delta, eqb, failed, nan, tout = march.carry
        out = {'t': st.t, 'T': st.T, 'delta': delta, 'steps': march.i,
               'equilibrium': eqb, 'failed': failed, 'nan': nan,
               'timed_out': tout}
        if extra is not None:
            out['extra'] = tuple(extra)
        return out

    def extra_of(when):
        if snapshot_fn is None or snapshot_on != when:
            return None
        return snapshot_fn(march.carry[0].T)

    snaps = []
    while len(snaps) < n_snaps:
        if len(snaps) % SYNC_EVERY == 0 and bool(march.stopped().all()):
            # the JAX scan's remaining iterations are no-ops
            snaps += [snap(None if snapshot_fn is None else
                           snapshot_fn(march.carry[0].T))] * (
                n_snaps - len(snaps))
            break
        extra = extra_of('pre')
        limit = march.i + steps_per_snap
        for _ in range(steps_per_snap):
            march.step(march.stopped() | (march.i >= limit))
        snaps.append(snap(extra if extra is not None else extra_of('post')))
    stacked = {k: torch.stack([s[k] for s in snaps])
               for k in snaps[0] if k != 'extra'}
    if 'extra' in snaps[0]:
        stacked['extra'] = tuple(torch.stack(x) for x in
                                 zip(*(s['extra'] for s in snaps)))
    return march.carry[0], march.info(), stacked
