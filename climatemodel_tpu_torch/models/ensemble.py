"""Ensemble (batched) column marches (port of
``climatemodel_tpu/models/ensemble.py``): the grey ensembles and the
real-gas ones.

The JAX package vmaps one member's march over a leading ensemble axis; here
the march is batched by construction (``column.evolve_to_equilibrium``), so
an ensemble is a batch of B members that run lock-step until every member
has stopped, each with its own adaptive dt, RemoveInd mask and simulated
time.  Real-gas members that share one composition share one
``TransmissionCache``, so a step's flux is one batched matmul over the
long-wave bands with the members as its N.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import sigma
from ..utils import timing
from . import column
from .column import ColumnState, where_members
from .grey import (GreyForcing, GreyGas, grey_net_flux_fn, grey_sw_fluxes,
                   up_flux_toa)


def broadcast_state(state: ColumnState, n: int) -> ColumnState:
    """Tile a batch-of-one state to ``n`` members."""
    return state.map(lambda x: x.expand((n,) + x.shape[1:]).clone())


def grey_ensemble_forcing(world: GreyGas, F_stellar_values) -> GreyForcing:
    """Batched forcing varying the stellar constant across members."""
    n = len(F_stellar_values)
    base = world.forcing
    tiled = base.map(lambda x: x.expand((n,) + x.shape[1:]).clone())
    return tiled.replace(F_stellar=torch.as_tensor(
        np.asarray(F_stellar_values, np.float64), device=base.F_stellar.device
    ).to(base.F_stellar.dtype))


def grey_ensemble(world: GreyGas, F_stellar_values):
    """Batched (states, forcings, grids) from a template world."""
    n = len(F_stellar_values)
    states = broadcast_state(world.state, n)
    # isothermal initial condition consistent with each member's forcing —
    # from the RAW albedo exactly like the reference ctor (base.py:120 ->
    # get_isothermal_temp(self.albedo, ...)), NOT albedo_mod (ensemble.py:465)
    F = np.asarray(F_stellar_values, dtype=np.float64)[:, None]       # [n, 1]
    T0 = (F * world.solar_latitude_factor[None]
          * (1 - world.albedo[None]) / 4 / sigma) ** 0.25             # [n, ny]
    T_init = np.broadcast_to(T0[:, None, :], (n,) + world.T.shape)
    states = states.replace(T=world._tensor(T_init),
                            net_flux=torch.zeros_like(states.net_flux))
    forcings = grey_ensemble_forcing(world, F_stellar_values)
    p_int = world._tensor(world.p_interface)
    p_c = world._tensor(world.p[:, 0])
    return states, forcings, p_int, p_c


def grey_march_fns(forcings: GreyForcing, net_shape, fused_stats=True,
                   net_flux_percentile=95):
    """(net_flux_fn, net_stats_fn) of a grey ensemble march.  With
    ``fused_stats`` the stats function computes the net flux AND the
    per-member exit statistics in one pass (ops/two_stream.
    grey_net_with_stats: the K3 kernel on CUDA for single columns), with
    the T-independent sw fluxes and TOA boundary hoisted out of the loop;
    without it the stats function is None and the march takes the flux (K1
    on CUDA) and the statistics separately."""
    from ..ops.two_stream import grey_net_with_stats

    net_fn = grey_net_flux_fn(forcings)
    if not fused_stats:
        return net_fn, None
    up_toa = up_flux_toa(forcings)
    up_sw, down_sw = grey_sw_fluxes(forcings)
    up_sw = torch.broadcast_to(up_sw, net_shape).contiguous()
    down_sw = torch.broadcast_to(down_sw, net_shape).contiguous()

    def stats_fn(T, prev):
        return grey_net_with_stats(T, forcings.dtau, up_toa, up_sw, down_sw,
                                   prev, pct=net_flux_percentile)
    return net_fn, stats_fn


def grey_evolve_ensemble(states: ColumnState, forcings: GreyForcing,
                         p_interface, p_centre_col, flux_thresh,
                         convective_adjust=False, t_end=4.0, conv_thresh=1e-5,
                         conv_t_multiplier=5.0, net_flux_thresh=1e-7,
                         net_flux_percentile=95, max_steps=500_000,
                         use_delta_exit=True, conv_method='reference',
                         check_every=1, dip_memory=False, fused_stats=True):
    """March every member of (states, forcings) to equilibrium; the
    pressure grid is shared.  ``fused_stats`` picks the fused net+stats
    step (default) or the split one (see :func:`grey_march_fns`);
    ``convective_adjust`` adds the convective adjustment of every step with
    ``conv_method`` 'reference' or 'isotonic' (ops/convection.py)."""
    net_fn, stats_fn = grey_march_fns(forcings, states.net_flux.shape,
                                      fused_stats, net_flux_percentile)
    return column.evolve_to_equilibrium(
        states, net_fn, p_interface, p_centre_col, flux_thresh=flux_thresh,
        convective_adjust=convective_adjust, t_end=t_end,
        conv_thresh=conv_thresh, conv_t_multiplier=conv_t_multiplier,
        net_flux_thresh=net_flux_thresh,
        net_flux_percentile=net_flux_percentile, max_steps=max_steps,
        use_delta_exit=use_delta_exit, conv_method=conv_method,
        check_every=check_every,
        dip_memory=dip_memory, net_stats_fn=stats_fn)


def grey_evolve_ensemble_robust(states: ColumnState, forcings: GreyForcing,
                                p_interface, p_centre_col, flux_thresh,
                                finish_repeats: int = 8,
                                finish_max_steps: int = 1_000, **march_kw):
    """Ensemble march plus an f64 finishing pass for precision-blocked
    members (see :func:`grey_finish_unconverged_f64`).

    :return: (final states, info, finished) where ``finished`` is the int
        array of member indices completed by the f64 pass.
    """
    fs, info = grey_evolve_ensemble(states, forcings, p_interface,
                                    p_centre_col, flux_thresh, **march_kw)
    return grey_finish_unconverged_f64(
        fs, info, forcings, p_interface, p_centre_col, flux_thresh,
        finish_repeats=finish_repeats, finish_max_steps=finish_max_steps,
        **march_kw)


@timing.spanned('finish', top=True)
def grey_finish_unconverged_f64(fs: ColumnState, info, forcings: GreyForcing,
                                p_interface, p_centre_col, flux_thresh,
                                finish_repeats: int = 8,
                                finish_max_steps: int = 1_000, **march_kw):
    """Re-march ONLY the timed-out members of an already-marched ensemble in
    float64, by the reference's unchanged exit criterion, and scatter them
    back in the ensemble's dtype.

    A small tail of f32 members (high insolation) cannot satisfy the
    delta-percentile exit (base.py:248-264): the 95th-percentile flux-change
    statistic has an f32 noise floor above the 1e-3 threshold, so the member
    marches to the t_end cap although the same member converges in f64.
    Each of up to ``finish_repeats`` fresh calls (t=0 restart, base.py:
    301-306) runs at most ``finish_max_steps`` steps on the ensemble's
    device; a member that converges in one repeat is frozen for the rest.
    The counters ``finish.repeats`` and ``finish.members`` count the
    repeats and the candidates re-marched.

    :return: (states, info, finished member indices)
    """
    with timing.span('finish.sync'):
        eqb = info.equilibrium.cpu().numpy()
        failed = info.failed.cpu().numpy()
        nan = info.nan.cpu().numpy()
    # only timed-out members are finishing candidates: failed/nan are real
    # aborts the caller must see
    cand = ~eqb & ~failed & ~nan
    if not cand.any() or fs.T.dtype == torch.float64:
        return fs, info, np.zeros((0,), np.int64)
    bad_np = np.where(cand)[0]
    timing.count('finish.members', len(bad_np))
    bad = torch.as_tensor(bad_np, device=fs.T.device)
    f64 = torch.float64

    def sub64(x):
        x = x[bad]
        return x.to(f64) if x.is_floating_point() else x

    st64 = fs.map(sub64)
    fo64 = forcings.map(sub64)
    p_i64, p_c64 = p_interface.to(f64), p_centre_col.to(f64)
    # the threshold as the ensemble's dtype held it (ensemble.py:183)
    ft64 = float(torch.as_tensor(flux_thresh, dtype=fs.T.dtype))
    t_base = st64.t.clone()
    steps_extra = torch.zeros_like(info.steps[bad])
    kw64 = dict(march_kw, max_steps=int(finish_max_steps))
    done = torch.zeros(len(bad_np), dtype=torch.bool, device=fs.T.device)
    fin64 = info64 = None
    for _ in range(int(finish_repeats)):
        timing.count('finish.repeats')
        # fresh-call restart (base.py:301-306): t=0, forced first step
        st64 = st64.replace(t=torch.zeros_like(st64.t))
        st64, step_info = grey_evolve_ensemble(st64, fo64, p_i64, p_c64,
                                               ft64, **kw64)
        steps_extra = steps_extra + torch.where(done, 0, step_info.steps)
        t_base = t_base + torch.where(done, 0.0, st64.t)
        # a member that converged in an earlier repeat keeps that result
        fin64 = st64 if fin64 is None else where_members(done, fin64, st64)
        info64 = step_info if info64 is None else column.EquilibriumInfo(
            *(where_members(done, a, b) for a, b in zip(info64, step_info)))
        done = done | step_info.equilibrium
        with timing.span('finish.sync'):
            settled = bool(done.all())
        if settled:
            break

    def scatter(full, part):
        out = full.clone()
        out[bad] = part.to(full.dtype)
        return out

    fs_out = fs.map(scatter, fin64)
    # total simulated time = the f32 march's plus every finishing call's
    fs_out = fs_out.replace(t=scatter(fs.t, t_base))
    info_out = column.EquilibriumInfo(
        steps=scatter(info.steps, info.steps[bad] + steps_extra),
        delta_net_flux=scatter(info.delta_net_flux, info64.delta_net_flux),
        flux_thresh=info.flux_thresh,
        failed=scatter(info.failed, info64.failed),
        equilibrium=scatter(info.equilibrium, info64.equilibrium),
        nan=scatter(info.nan, info64.nan),
        timed_out=scatter(info.timed_out,
                          info64.timed_out & ~info64.equilibrium))
    return fs_out, info_out, bad_np


def grey_latitude_ensemble(world: GreyGas):
    """Split a latitude-grid world into ny independent single-column
    members, each with its own adaptive-dt controller (JAX
    models/ensemble.py:239-276).

    The reference shares one dt across all latitudes (base.py:197-246),
    which drags convergence to the slowest column; latitudes never couple
    in this model, so marching them as an ensemble converges each on its
    own clock.

    :return: (states, forcings, p_interface [nz, 1], p_centre [nz-1]) with
        a leading ny axis, as :func:`grey_evolve_ensemble` and
        :func:`grey_finish_unconverged_f64` take them; the world's
        temperature field is ``states.T[:, :, 0].T``.
    """
    ny, n_lev = world.ny, world.nz - 1
    base = world.forcing

    def col(x):                             # [1, ..., ny] -> [ny, ..., 1]
        return x[0].movedim(-1, 0)[..., None].contiguous()

    forcings = GreyForcing(
        dtau=col(base.dtau), tau_sw_interface=col(base.tau_sw_interface),
        albedo_mod=base.albedo_mod[0][:, None].contiguous(),
        solar_latitude_factor=base.solar_latitude_factor[0][:, None]
        .contiguous(),
        F_stellar=base.F_stellar.expand(ny).clone())
    st = world.state
    tsi = st.tsi.map(lambda x: (x.expand(ny).clone() if x.ndim == 1 else
                                x[0].reshape(n_lev, ny).T.contiguous()))
    states = ColumnState(T=col(st.T), net_flux=col(st.net_flux),
                         t=st.t.expand(ny).clone(), tsi=tsi)
    p_int = world._tensor(world.p_interface[:, :1])
    p_c = world._tensor(world.p[:, 0])
    return states, forcings, p_int, p_c


# --------------------------------------------------------------------------
# real-gas ensembles (JAX models/ensemble.py:274-459)
# --------------------------------------------------------------------------

def real_gas_evolve_ensemble(states: ColumnState, F_scales, T_gs,
                             tau_interface, ba, F_star_factor, delta,
                             p_interface, p_centre_col, flux_thresh,
                             convective_adjust=False, t_end=4.0,
                             conv_thresh=1e-5, conv_t_multiplier=5.0,
                             max_steps=500_000, use_delta_exit=True,
                             conv_method='reference', stacked_tau=False,
                             cache_dtype=None, check_every=1,
                             dip_memory=False, cache=None):
    """Lock-step real-gas march of B members (TOA-first columns).

    With ``stacked_tau=False`` members share one composition: the
    TransmissionCache is folded ONCE (or taken from ``cache``), and the
    per-step flux is one batched matmul over the long-wave bands with the
    member axis as its N.  Per member: insolation scale ``F_scales`` [B] and
    ground temperature ``T_gs`` [B] (the stellar-sweep workloads,
    centa_presentation/script.py:40-74).

    With ``stacked_tau=True``, ``tau_interface`` [B, nz, n_nu] carries one
    composition per member, each folded into its own cache (memory ~ B * L *
    nz^2 floats): the GHG-ladder workload the reference runs as a
    sequential loop of full marches (real_gas_script.py:27-40).

    :return: (final states, ``column.EquilibriumInfo``)
    """
    from .real_gas import (precompute_transmission, real_gas_net_fn,
                           stack_caches)
    if cache is None:
        cache = (stack_caches([precompute_transmission(t, ba, cache_dtype)
                               for t in tau_interface]) if stacked_tau else
                 precompute_transmission(tau_interface, ba, cache_dtype))
    F = F_star_factor[None, :] * F_scales[:, None]
    return column.evolve_to_equilibrium(
        states, real_gas_net_fn(T_gs, cache, ba, F, delta), p_interface,
        p_centre_col, flux_thresh=flux_thresh,
        convective_adjust=convective_adjust, t_end=t_end,
        conv_thresh=conv_thresh, conv_t_multiplier=conv_t_multiplier,
        max_steps=max_steps, use_delta_exit=use_delta_exit,
        conv_method=conv_method, check_every=check_every,
        dip_memory=dip_memory, p_descending=False)


def real_gas_ensemble(gas, F_scales=None, T_g_values=None):
    """Batched (states, scales, T_gs, march args) from a template RealGas.

    Each member starts from its own isothermal T_g profile with a FRESH march
    state — t = 0 and a re-initialised adaptive-dt controller (the
    reference's per-world initialisation, real_gas.py:296-299) — even when
    the template has already been marched: a converged template's shrunk
    delta_t would otherwise restart every member up to ~10x slower.
    Composition — and hence the transmission cache — is shared; the march
    args are (tau, band arrays, F_star_factor, delta, p_interface,
    p_centre).
    """
    n = len(F_scales) if F_scales is not None else len(T_g_values)
    states = broadcast_state(gas.state, n)
    scales = gas._tensor(np.ones(n) if F_scales is None else
                         np.asarray(F_scales, np.float64))
    T_gs = gas._tensor(np.full(n, gas.T_g) if T_g_values is None else
                       np.asarray(T_g_values, np.float64))
    T0 = torch.broadcast_to(T_gs[:, None, None], states.T.shape).clone()
    states = states.replace(
        T=T0, net_flux=torch.zeros_like(states.net_flux),
        t=torch.zeros_like(states.t),
        tsi=column.init_time_step_info(gas.nz - 1, gas.temp_change,
                                       gas.delta_temp_change, batch=n,
                                       dtype=gas.dtype, device=gas.device))
    delta, p_int, p_c = gas._geom_device
    args = (gas.tau_device, gas.band_arrays, gas._F_star_factor, delta,
            p_int, p_c)
    return states, scales, T_gs, args


def real_gas_find_Tg_ensemble(states, scales, T_gs0, args, flux_thresh=0.1,
                              tol=0.5, max_iter=12, stacked_tau=False,
                              verbose=False, **march_kw):
    """Batched ground-temperature solve: the reference's ``find_Tg`` Newton
    (real_gas.py:530-562, optimize.newton with no derivative = secant) as a
    vectorised secant iteration — every trial is ONE lock-step equilibrium
    march of all members.

    :param states, scales, T_gs0, args: from :func:`real_gas_ensemble`
        (shared composition) or :func:`real_gas_compos_ensemble` (+
        ``stacked_tau=True``, one composition per member).
    :param tol: per-member secant step tolerance (reference tol=0.5 K).
    :return: (T_g [B], final states, {'converged', 'iterations',
        'residual'})
    """
    from .real_gas import precompute_transmission, stack_caches
    tsi_fresh = states.tsi
    tau, ba = args[0], args[1]
    cache_dtype = march_kw.pop('cache_dtype', None)
    # the composition is fixed: fold its transmission once for every trial
    cache = (stack_caches([precompute_transmission(t, ba, cache_dtype)
                           for t in tau]) if stacked_tau else
             precompute_transmission(tau, ba, cache_dtype))

    def march(prev_states, T_gs):
        # warm-start the temperature field, fresh march bookkeeping
        st = prev_states.replace(t=torch.zeros_like(prev_states.t),
                                 net_flux=torch.zeros_like(
                                     prev_states.net_flux),
                                 tsi=tsi_fresh)
        out, _info = real_gas_evolve_ensemble(
            st, scales, T_gs, *args, flux_thresh, stacked_tau=stacked_tau,
            cache=cache, **march_kw)
        return out, out.net_flux[:, 0, 0]          # TOA net flux per member

    x0 = T_gs0
    st, f0 = march(states, x0)
    x1 = x0 * (1 + 1e-4) + 1e-4                    # scipy newton secant seed
    st, f1 = march(st, x1)
    done = torch.zeros(x0.shape, dtype=torch.bool, device=x0.device)
    iters = 0
    for iters in range(1, max_iter + 1):
        denom = f1 - f0
        zero = denom == 0
        # a zero denominator means the flux response fell below the march's
        # resolution — probe a fixed step toward balance (net > 0 at TOA =
        # net cooling = ground too warm) instead of silently declaring the
        # unbalanced T_g converged (scipy raises on a zero derivative)
        probe = torch.sign(f1) * max(tol, 1.0)
        step = torch.where(zero, probe,
                           f1 * (x1 - x0) / torch.where(zero, 1.0, denom))
        x2 = torch.where(done, x1, x1 - step)
        done = done | ((torch.abs(x2 - x1) < tol) & ~zero)
        x0, f0 = x1, f1
        st, f2 = march(st, x2)
        x1, f1 = x2, f2
        if verbose:
            print(f'find_Tg iter {iters}: {int(done.sum())}/{done.numel()}'
                  f' converged, T_g in [{float(x1.min()):.2f}, '
                  f'{float(x1.max()):.2f}]')
        if bool(done.all()):
            break
    # hand back march-ready states: a converged trial's shrunk delta_t would
    # restart follow-up marches ~10x slower (real_gas.py:781-784)
    st = st.replace(t=torch.zeros_like(st.t),
                    net_flux=torch.zeros_like(st.net_flux), tsi=tsi_fresh)
    return x1, st, {'converged': done, 'iterations': iters, 'residual': f1}


def real_gas_compos_ensemble(gases, T_g_values=None):
    """Batched march inputs from one RealGas PER COMPOSITION (the GHG-ladder
    workload, real_gas_script.py:27-40): members stack their own
    tau_interface; pass the result to :func:`real_gas_evolve_ensemble` with
    ``stacked_tau=True``.

    All members must share the grid and wavenumber machinery (same molecules
    and nz — only the humidity/abundance args may differ between them).
    """
    g0 = gases[0]
    for gas in gases[1:]:
        if gas.nz != g0.nz or gas.tau_device.shape != g0.tau_device.shape:
            raise ValueError('composition members must share nz and the '
                             'band/wavenumber structure')
        # star/albedo/distance all fold into F_star_factor — members that
        # differ there would silently march with g0's insolation
        if not np.allclose(gas._F_star_factor.cpu().numpy(),
                           g0._F_star_factor.cpu().numpy()):
            raise ValueError('composition members must share the stellar '
                             'forcing (T_star/R_star/distance/albedo); only '
                             'humidity/abundance args may differ')
    n = len(gases)
    states = gases[0].state.map(lambda *xs: torch.cat(xs),
                                *[gas.state for gas in gases[1:]])
    T_gs = g0._tensor([gas.T_g for gas in gases] if T_g_values is None
                      else np.asarray(T_g_values, np.float64))
    scales = g0._tensor(np.ones(n))
    taus = torch.stack([gas.tau_device for gas in gases])
    delta, p_int, p_c = g0._geom_device
    args = (taus, g0.band_arrays, g0._F_star_factor, delta, p_int, p_c)
    return states, scales, T_gs, args
