"""Equilibrium sensitivities by implicit differentiation (port of
``climatemodel_tpu/diagnostics/sensitivity.py``).

A marched equilibrium satisfies F(T*, theta) = 0, where F is the cellwise
heating tendency dT/dt = g/c_p * dF_net/dp, so by the implicit function
theorem

    dT*/dtheta = -(dF/dT)^{-1} (dF/dtheta)        evaluated AT equilibrium

— one Jacobian (``torch.func.jacfwd`` of the tendency, an [n, n] matrix
with n = nz-1 cells) and one linear solve, instead of a re-march per
parameter.  The Jacobian's diagonal is the Planck feedback, which keeps
the system well conditioned.

The tendency is differentiated through plain PyTorch: the grey lw fluxes
through :func:`~climatemodel_tpu_torch.ops.two_stream.lw_flux_plain` (the
log-depth scan), never through ``lw_flux``, whose CUDA kernel sits behind
ctypes and has no forward-mode rule.  The real-gas tendency rebuilds the
transmission operators from tau inside, so a tau perturbation flows
through them.  Every function runs on the device of the world it is
given.

Caveats (as in the JAX package):

* valid for RADIATIVE equilibria; a radiative-convective equilibrium takes
  the pooled marginal-neutrality solve of the ``*_rce_*`` functions;
* the full-system solve is the default; an ``active`` mask pins genuinely
  decoupled micro-mass levels to dT = 0;
* the response is LINEAR.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import R_specific, c_p_dry, g, p_surface_earth


def _masked_solve(J, b, active=None):
    """Solve J dT = b; with an ``active`` mask, inactive rows and columns
    are replaced by identity rows (their dT is forced to b = 0), keeping
    one dense solve of the full size."""
    if active is None:
        return torch.linalg.solve(J, b)
    n = J.shape[0]
    both = active[:, None] & active[None, :]
    eye = torch.eye(n, dtype=J.dtype, device=J.device)
    J_m = torch.where(both, J, eye)
    b_m = torch.where(active, b, torch.zeros_like(b))
    return torch.linalg.solve(J_m, b_m)


def equilibrium_sensitivity(tendency_fn, T_eq, d_tendency, active=None):
    """dT* in a perturbation direction, by the implicit function theorem.

    :param tendency_fn: T [n] -> heating tendency [n] (K/s) at fixed
        parameters, in out-of-place tensor ops (``torch.func.jacfwd``
        batches it).
    :param T_eq: [n] equilibrium temperatures (tendency_fn(T_eq) ~ 0).
    :param d_tendency: [n] directional derivative of the tendency with
        respect to the perturbed parameter at T_eq (``torch.func.jvp``).
    :param active: optional [n] bool; cells outside it are pinned to
        dT = 0.  None (default) solves the full system.
    :return: [n] equilibrium shift dT* per unit of the perturbation.
    """
    J = torch.func.jacfwd(tendency_fn)(T_eq)
    return _masked_solve(J, -d_tendency, active)


# --------------------------------------------------------------------------
# Grey model front-end
# --------------------------------------------------------------------------

def _grey_tendency(T_col, forcing, p_int_col):
    """Heating tendency [n] of one column: ``forcing`` is a one-member,
    one-latitude ``GreyForcing``, ``p_int_col`` [nz]."""
    from ..models.grey import grey_sw_fluxes, up_flux_toa
    from ..ops.two_stream import lw_flux_plain
    up_lw, down_lw = lw_flux_plain(T_col[:, None], forcing.dtau[0],
                                   up_flux_toa(forcing)[0],
                                   surface_first=True)
    up_sw, down_sw = grey_sw_fluxes(forcing)
    net = (up_lw - down_lw + up_sw[0] - down_sw[0])[:, 0]
    return g / c_p_dry * (net[1:] - net[:-1]) / (p_int_col[1:] - p_int_col[:-1])


def _column(forcing, j):
    """Latitude j of a one-member forcing, as a one-latitude forcing."""
    return forcing.map(lambda x: x[..., j:j + 1] if x.ndim >= 2 else x)


def _unit_insolation(forcing):
    """The default perturbation: 1 W/m^2 of stellar constant."""
    zeros = forcing.map(torch.zeros_like)
    return zeros.replace(F_stellar=torch.ones_like(forcing.F_stellar))


def _grey_J_dF(T_col, p_col, f_col, df_col):
    """(J [n, n], dF [n]) of one column's tendency at T_col."""
    names = [f.name for f in dataclasses.fields(f_col)]

    def tend_of_forcing(*xs):
        return _grey_tendency(T_col, type(f_col)(**dict(zip(names, xs))),
                              p_col)
    _, dF = torch.func.jvp(tend_of_forcing,
                           tuple(getattr(f_col, k) for k in names),
                           tuple(getattr(df_col, k) for k in names))
    J = torch.func.jacfwd(lambda T: _grey_tendency(T, f_col, p_col))(T_col)
    return J, dF


def grey_equilibrium_sensitivity(world, dforcing=None, active_tau_thresh=None):
    """Linear response dT* [nz-1, ny] of a marched grey equilibrium to a
    forcing perturbation.

    :param world: a ``GreyGas`` already marched to RADIATIVE equilibrium.
    :param dforcing: a ``GreyForcing`` of perturbation directions, shaped
        like ``world.forcing`` (one member); None is 1 W/m^2 of stellar
        constant.
    :param active_tau_thresh: optional; cells with |dtau_lw| below it are
        pinned to dT = 0.  Default None solves the full system.
    :return: np.ndarray [nz-1, ny], kelvin per unit perturbation.

    Latitudes are independent in this model, so each column is solved on
    its own.
    """
    forcing = world.forcing
    if dforcing is None:
        dforcing = _unit_insolation(forcing)
    T_eq = world.state.T[0]
    p_int = world._tensor(world.p_interface)
    active = (None if active_tau_thresh is None
              else forcing.dtau[0].abs() > active_tau_thresh)
    outs = []
    for j in range(T_eq.shape[1]):
        J, dF = _grey_J_dF(T_eq[:, j], p_int[:, j], _column(forcing, j),
                           _column(dforcing, j))
        outs.append(_masked_solve(J, -dF,
                                  None if active is None else active[:, j]))
    return torch.stack(outs, 1).cpu().numpy()


def _pooled_rce_solve(T_col, pi, w, J, dF, pool_tol):
    """Solve the pooled marginal-neutrality system (see
    :func:`grey_rce_equilibrium_sensitivity`) in host NumPy float64: pools
    from the theta flatness of the endpoint, dT = R x with R the per-pool
    adiabat shapes, equations the pool-wise w-weighted enthalpy balance of
    the perturbed tendency.  T_col, pi, w and J, dF only have to share an
    index order.  The pool count depends on the data, so this stays on the
    host, as in the JAX package."""
    T_col, pi, w, J, dF = (np.asarray(x, np.float64)
                           for x in (T_col, pi, w, J, dF))
    theta = T_col / pi
    rel = np.abs(np.diff(theta)) / np.maximum(np.abs(theta[:-1]),
                                              np.abs(theta[1:]))
    same = rel < pool_tol
    pool_id = np.concatenate([[0], np.cumsum(~same)])
    m = int(pool_id[-1]) + 1
    n = T_col.shape[0]
    R = np.zeros((n, m))
    R[np.arange(n), pool_id] = pi
    W = np.zeros((m, n))
    W[pool_id, np.arange(n)] = w
    x = np.linalg.solve(W @ J @ R, -(W @ dF))
    return R @ x


def _exner(p_c):
    return (p_c / p_surface_earth) ** (R_specific / c_p_dry)


def grey_rce_equilibrium_sensitivity(world, dforcing=None, pool_tol=1e-4):
    """Linear response of a RADIATIVE-CONVECTIVE grey equilibrium.

    Each convectively mixed pool (theta flat to ``pool_tol`` at the
    endpoint) stays on its adiabat, dT_i = dtheta_pool * pi_i, and keeps
    zero net enthalpy drift, sum_i w_i f_i = 0 with the adjustment's trapz
    weights w; free cells are singleton pools.  That gives one unknown per
    pool: (W J R) x = -(W dF), dT = R x.  The exact grey oracle
    dT*/dF = T*/(4F) survives convection.

    :param world: a ``GreyGas`` marched with ``convective_adjust=True``.
    :return: np.ndarray [nz-1, ny], kelvin per unit perturbation.
    """
    from ..ops.convection import _trapz_weights
    forcing = world.forcing
    if dforcing is None:
        dforcing = _unit_insolation(forcing)
    T_eq = world.state.T[0]
    p_int = world._tensor(world.p_interface)
    p_c = world._tensor(world.p[:, 0])               # descending, sfc first
    pi_np = _exner(p_c).cpu().numpy()
    w_np = _trapz_weights(p_c).cpu().numpy()
    outs = []
    for j in range(T_eq.shape[1]):
        J, dF = _grey_J_dF(T_eq[:, j], p_int[:, j], _column(forcing, j),
                           _column(dforcing, j))
        outs.append(_pooled_rce_solve(T_eq[:, j].cpu().numpy(), pi_np, w_np,
                                      J.cpu().numpy(), dF.cpu().numpy(),
                                      pool_tol))
    return np.stack(outs, axis=1)


# --------------------------------------------------------------------------
# Real-gas front-end
# --------------------------------------------------------------------------

def _real_gas_J_dF(gas, d_tau_interface, d_F_scale, d_T_g):
    """(T_eq, J, dF) of the real-gas heating tendency at the marched
    endpoint, with the perturbation direction folded into dF."""
    from ..models.real_gas import (precompute_transmission,
                                   real_gas_net_and_diff_cached)
    ba = gas.band_arrays
    delta = gas._tensor(gas.nu_bands['delta'])
    p_int = gas._tensor(gas.p_interface[:, 0])
    dp = p_int[1:] - p_int[:-1]
    T_eq = gas.state.T[0, :, 0]
    tau0 = gas.tau_device
    F_star = gas._F_star_factor

    def tend(T, T_g, scale, cache):
        _net, net_diff = real_gas_net_and_diff_cached(
            T[None], T_g[None], cache, ba, F_star * scale, delta)
        return g / c_p_dry * net_diff[0] / dp

    T_g0 = gas._tensor(gas.T_g)
    s0 = gas._tensor(1.0)
    primal = {'tau_i': tau0, 'T_g': T_g0, 'scale': s0}
    # only the directions that are not zero enter the jvp: a zero tangent
    # adds nothing, but pushed through the Planck function's expm1, which
    # overflows f32 at the short-wave band centres, it gives inf * 0 = NaN;
    # and without a tau direction the [L, nz, nz, K] exponent is not
    # differentiated at all
    tangent = {'tau_i': (None if d_tau_interface is None
                         else gas._tensor(d_tau_interface)),
               'T_g': None if d_T_g == 0 else gas._tensor(d_T_g),
               'scale': None if d_F_scale == 0 else gas._tensor(d_F_scale)}
    names = [k for k in primal if tangent[k] is not None]

    def tend_of_params(*xs):
        p = dict(primal, **dict(zip(names, xs)))
        # the cache is rebuilt inside, so tau enters differentiably
        return tend(T_eq, p['T_g'], p['scale'],
                    precompute_transmission(p['tau_i'], ba))

    if names:
        _, dF = torch.func.jvp(tend_of_params,
                               tuple(primal[k] for k in names),
                               tuple(tangent[k] for k in names))
    else:
        dF = torch.zeros_like(T_eq)
    cache = precompute_transmission(tau0, ba)
    J = torch.func.jacfwd(lambda T: tend(T, T_g0, s0, cache))(T_eq)
    return T_eq, J, dF


def real_gas_equilibrium_sensitivity(gas, d_tau_interface=None, d_F_scale=0.0,
                                     d_T_g=0.0, active_tau_thresh=None):
    """Linear response dT* [nz-1] of a marched real-gas equilibrium to a
    composition (optical depth), insolation or ground-temperature change.

    :param gas: a ``RealGas`` marched to RADIATIVE equilibrium; for a
        convectively adjusted march use
        :func:`real_gas_rce_equilibrium_sensitivity`.
    :param d_tau_interface: [nz, n_nu] interface optical-depth change
        (``tau(perturbed composition) - tau(composition)``), or None.
    :param d_F_scale: relative insolation change (0.01 = +1% stellar flux).
    :param d_T_g: ground-temperature change (K).
    :return: np.ndarray [nz-1], kelvin per unit perturbation.
    """
    _T_eq, J, dF = _real_gas_J_dF(gas, d_tau_interface, d_F_scale, d_T_g)
    active = None
    if active_tau_thresh is not None:
        tau0 = gas.tau_device
        # active where ANY band has meaningful optical-depth increments
        dtau_cell = (tau0[1:, :] - tau0[:-1, :]).abs().amax(dim=1)
        active = dtau_cell > active_tau_thresh
    return _masked_solve(J, -dF, active).cpu().numpy()


def real_gas_rce_equilibrium_sensitivity(gas, d_tau_interface=None,
                                         d_F_scale=0.0, d_T_g=0.0,
                                         pool_tol=1e-4):
    """Linear response of a real-gas RADIATIVE-CONVECTIVE equilibrium: the
    pooled solve of :func:`grey_rce_equilibrium_sensitivity` with the
    real-gas band operator and the perturbations of
    :func:`real_gas_equilibrium_sensitivity`.  With no convective pools it
    is the radiative full solve."""
    from ..ops.convection import _trapz_weights
    T_eq, J, dF = _real_gas_J_dF(gas, d_tau_interface, d_F_scale, d_T_g)
    p_c = gas._tensor(gas.p[:, 0])                   # TOA-first, ascending
    # the enthalpy weights are defined on descending p: flip in and out
    w = torch.flip(_trapz_weights(torch.flip(p_c, (0,))), (0,))
    return _pooled_rce_solve(T_eq.cpu().numpy(), _exner(p_c).cpu().numpy(),
                             w.cpu().numpy(), J.cpu().numpy(),
                             dF.cpu().numpy(), pool_tol)
