"""A plain march of grey columns to equilibrium, in any dtype.

The semantics of the NumPy original's ``Atmosphere`` march (base.py:130-335)
over a batch of independent members: the finite-volume temperature update,
the adaptive time step with its oscillation and freeze bookkeeping, the
convective adjustment, the 95th-percentile flux-change exit with the
threshold tightened at the second step, and the t_end cap.  A stopped member
is frozen.  This is the benchmark's control: put in the program's place in
a precision below the configuration's, it must fail the comparison
(``benchmark/reference/compare.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .convection import adjust, factors
from .radiation import net_flux, sw_fluxes
from .world import C_P_DRY, G, SECONDS_PER_DAY, SECONDS_PER_YEAR, SIGMA


def percentile(x, pct):
    """Per-row linear-interpolation percentile of [B, N] (np.percentile's
    default), in x's dtype; a row holding NaN gives NaN."""
    N = x.shape[1]
    q = (N - 1) * pct / 100.0
    k = int(q)
    s = torch.sort(torch.nan_to_num(x, nan=float('inf')), dim=1).values
    hi = s[:, min(k + 1, N - 1)]
    val = s[:, k] + (hi - s[:, k]) * (q - k)
    return torch.where(torch.isnan(x).any(1), float('nan'), val)


def initial_temperature(F, albedo):
    """[B] isothermal energy balance of the bare planet (base.py:51-73)."""
    return (F * (1 - albedo) / 4 / SIGMA) ** 0.25


def march(F, world, *, dtype, device, flux_thresh, max_steps, t_end=4.0,
          albedo=0.3, convective_adjust=False, conv_thresh=1e-5,
          conv_t_multiplier=5.0, net_flux_thresh=1e-7, pct=95):
    """March members forced by stellar constants F [B] to equilibrium.

    :return: dict of T [B, n], net [B, n + 1] (the flux of the last step's
        starting temperatures, as the program's state holds it), t, steps,
        equilibrium, failed, nan, timed_out ([B] each).
    """
    F = torch.as_tensor(F, dtype=torch.float64, device=device)
    B, n = F.shape[0], world.n
    Fd = F.to(dtype)
    sw = sw_fluxes(Fd, world, dtype, device)
    # the grid's coefficients are formed in float64, then held in dtype
    coef = torch.as_tensor(G / C_P_DRY / np.diff(world.p_interface),
                           dtype=dtype, device=device)
    pi, w = factors(world.p_centre, dtype, device)

    def full(v, dt=dtype):
        return torch.full((B,), v, dtype=dt, device=device)

    T = initial_temperature(F, albedo).to(dtype)[:, None].expand(B, n).clone()
    net_prev = torch.zeros((B, n + 1), dtype=dtype, device=device)
    t = full(0.0)
    delta_t, step_t = full(world.temp_change), full(world.delta_temp_change)
    max_delta_t = delta_t.clone()
    max_tend, ind, dt = full(0.0), full(-1, torch.int64), full(0.0)
    n1, n2 = full(0, torch.int64), full(0, torch.int64)
    removed = torch.zeros((B, n), dtype=torch.bool, device=device)
    convective = torch.zeros_like(removed)
    ft = full(flux_thresh)
    i = full(0, torch.int64)
    no = torch.zeros((B,), dtype=torch.bool, device=device)
    eqb, failed, nan, tout = no, no, no, no
    rows = torch.arange(B, device=device)
    while True:
        stop = eqb | failed | nan | tout | (i >= max_steps)
        if bool(stop.all()):
            break
        go = ~stop
        net = net_flux(T, Fd, world, sw)
        tend = (net[:, 1:] - net[:, :-1]) * coef
        first = t <= 0
        allowed = first[:, None] | ((net[:, :-1].abs() > net_flux_thresh)
                                    & ~removed)
        delta = torch.where(first, torch.full_like(t, 1e6),
                            percentile((net - net_prev).abs(), pct))
        # adaptive time step (base.py:197-246)
        upd = go & allowed.any(1)
        m_ind = torch.where(allowed, tend.abs(), float('-inf')).argmax(1)
        m_tend = tend[rows, m_ind]
        same = m_ind == ind
        flip = torch.sign(m_tend) != torch.sign(max_tend)
        osc, grow = same & flip, same & ~flip & (delta_t < max_delta_t)
        reset = ~osc & ~grow
        dlt = torch.where(osc, torch.maximum(delta_t - step_t, step_t),
                          torch.where(grow, torch.minimum(delta_t + step_t,
                                                          max_delta_t),
                                      delta_t))
        c1 = torch.where(osc, n1 + 1, torch.where(reset, 0, n1))
        c2 = torch.where(grow, n2 + 1, torch.where(reset, 0, n2))
        freeze = ((c1 > 1) & (c2 > 10)) | ((c1 > 20) & (c2 == 0)) | \
            ((removed.sum(1) > 3) & ((c1 + c2) > 0))
        rem = removed.clone()
        rem[rows, m_ind] |= freeze
        c1, c2 = torch.where(freeze, 0, c1), torch.where(freeze, 0, c2)
        dt_new = dlt / m_tend.abs()
        dt_new = torch.where(torch.isfinite(dt_new), dt_new,
                             torch.full_like(dt_new, SECONDS_PER_DAY))
        delta_t = torch.where(upd, dlt, delta_t)
        n1, n2 = torch.where(upd, c1, n1), torch.where(upd, c2, n2)
        removed = torch.where(upd[:, None], rem, removed)
        max_tend = torch.where(upd, m_tend, max_tend)
        ind = torch.where(upd, m_ind, ind)
        dt = torch.where(upd, dt_new, dt)
        if convective_adjust:
            in_conv = convective[rows, ind.clamp(min=0)]
            dt = torch.where(allowed.any(1) & in_conv, dt * conv_t_multiplier,
                             dt)
        T_new = torch.where(allowed, T + dt[:, None] * tend, T)
        if convective_adjust:
            T_adj = adjust(T_new, pi, w)
            conv_new = allowed & ((T_adj - T_new).abs() > conv_thresh)
            convective = torch.where(go[:, None], conv_new, convective)
            T_new = T_adj
        t_new = t + dt
        ft = torch.where(go & (i == 1), torch.minimum(ft, 0.99 * delta), ft)
        e = (net.abs().amax(1) < ft) | (delta < ft)
        f = T_new.amin(1) < 0
        nn = ~(torch.isfinite(T_new).all(1) & torch.isfinite(net).all(1))
        to = (t_new / SECONDS_PER_YEAR > t_end) & ~e
        T = torch.where(go[:, None], T_new, T)
        net_prev = torch.where(go[:, None], net, net_prev)
        t = torch.where(go, t_new, t)
        eqb, failed = torch.where(go, e, eqb), torch.where(go, f, failed)
        nan, tout = torch.where(go, nn, nan), torch.where(go, to, tout)
        i = torch.where(go, i + 1, i)
    return dict(T=T, net=net_prev, t=t, steps=i, equilibrium=eqb,
                failed=failed, nan=nan, timed_out=tout)
