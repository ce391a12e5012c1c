"""2-D shallow-water dynamics on a beta plane (port of
``climatemodel_tpu/models/shallow_water.py``; reference ``ShallowWater``,
shallow_water.py:10-828 of the NumPy original).

Conservative form U = (h, uh, vh), four FV/FD schemes (ops/stencils.py),
ghost-cell boundary conditions, CFL time-step control with the dt < 10 s
abort, orography, the scenario library (uniform/sinusoidal/jet zonal flows,
height gaussian/step, El Nino with the Bjerknes wind feedback closure), and
Rayleigh damping with sponge walls.

State and forcing are dataclasses of tensors on the model's device.  The JAX
package's ``lax.scan`` runs are Python loops here; every per-step scalar
(dt, ok, the CFL statistic) stays on the device, so a run syncs the host
once, at its end, to read ``ok``.  ``numerical_solver='richtmyer_pallas'``
steps through the fused Richtmyer kernel: :func:`sw_step` in its interior
mode (K5), :func:`sw_simulate` / :func:`sw_simulate_snapshots` in its
boundary-condition mode (K6, the counterpart of the JAX package's padded
frame path, on unpadded fields).  The kernel takes every grid size, so the
solver is never swapped.  ``plot_animate`` and ``el_nino_plot`` are host
matplotlib on NumPy copies of a run's snapshots.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..constants import g as g_earth
from ..ops import stencils
# apply_boundary_conditions is also this module's public name, as in the JAX
# package's models/shallow_water.py:163 (tests/test_torch_shallow_water.py)
from ..ops.stencils import apply_boundary_conditions, apply_boundary_conditions_
from .column import TensorStruct

# --------------------------------------------------------------------------
# State / parameter dataclasses
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SWState(TensorStruct):
    """Shallow-water prognostic state (ghost cells included)."""
    h: torch.Tensor          # [nx, ny] fluid depth
    u: torch.Tensor          # [nx, ny] zonal velocity
    v: torch.Tensor          # [nx, ny] meridional velocity
    t: torch.Tensor          # 0-d time (s)
    dt: torch.Tensor         # 0-d current time step (s)
    ok: torch.Tensor         # 0-d bool: False once dt < 10 s (abort flag)


@dataclasses.dataclass
class SWParams(TensorStruct):
    """Forcing and geometry of the step (0-d tensors for the scalars)."""
    f_coriolis: torch.Tensor   # [nx, ny]
    h_base: torch.Tensor       # [nx, ny] orography
    r: torch.Tensor            # [nx, ny] Rayleigh damping coefficient
    g: torch.Tensor            # gravity
    h_mean: torch.Tensor       # mean depth (linear mode)
    dt_0: torch.Tensor         # initial/maximum time step
    dx: torch.Tensor
    dy: torch.Tensor
    # El Nino wind closure (ignored unless wind_type is not None):
    wind_gamma: torch.Tensor           # Bjerknes feedback strength
    wind_initial_tau: torch.Tensor     # initial tau/h
    wind_seasonal_fluct: torch.Tensor  # seasonal oscillation magnitude
    east_mask: torch.Tensor            # [nx, ny] averaging mask (east boundary)
    west_mask: torch.Tensor            # [nx, ny] averaging mask (west boundary)


# --------------------------------------------------------------------------
# Physics closures (shallow_water.py:446-578)
# --------------------------------------------------------------------------

def get_conservative_form(h, u, v, linear):
    """Stack (h, u, v) into U = [h, hu, hv] (or [h, u, v] linearised),
    shallow_water.py:457-468."""
    if linear:
        return torch.stack([h, u, v])
    return torch.stack([h, h * u, h * v])


def get_physical_values(U, linear):
    """Invert :func:`get_conservative_form`: U -> (h, u, v)."""
    h = U[0]
    if linear:
        return h, U[1], U[2]
    return h, U[1] / h, U[2] / h


def make_flux_x(g, h_mean, linear):
    """x-direction flux F(U) closure (shallow_water.py:471-489)."""
    def flux_x(U):
        if linear:
            return torch.stack([h_mean * U[1], g * U[0],
                                torch.zeros_like(U[0])])
        return torch.stack([U[1],
                            U[1] * U[1] / U[0] + 0.5 * g * (U[0] * U[0]),
                            U[1] * U[2] / U[0]])
    return flux_x


def make_flux_y(g, h_mean, linear):
    """y-direction flux G(U) closure (shallow_water.py:492-510)."""
    def flux_y(U):
        if linear:
            return torch.stack([h_mean * U[2], torch.zeros_like(U[0]),
                                g * U[0]])
        return torch.stack([U[2],
                            U[1] * U[2] / U[0],
                            U[2] * U[2] / U[0] + 0.5 * g * (U[0] * U[0])])
    return flux_y


def make_source(g, f_coriolis, h_base, dx, dy, linear):
    """Coriolis + orography-gradient source Q(U) on the interior
    (shallow_water.py:555-578)."""
    dhbase_dx = stencils.centered_diff_x(h_base, dx)
    dhbase_dy = stencils.centered_diff_y(h_base, dy)
    f_int = f_coriolis[1:-1, 1:-1]

    def source(U):
        h, u, v = get_physical_values(U[:, 1:-1, 1:-1], linear)
        Q1 = f_int * v - g * dhbase_dx
        Q2 = -f_int * u - g * dhbase_dy
        if not linear:
            Q1 = h * Q1
            Q2 = h * Q2
        return torch.stack([torch.zeros_like(Q1), Q1, Q2])
    return source


def make_jacobian_x(g):
    """Flux-Jacobian A = dF/dU closure for lax_wendroff."""
    def jacobian_x(U):
        """A = dF/dU [nx, ny, 3, 3], nonlinear only (shallow_water.py:519-535)."""
        nx, ny = U.shape[1], U.shape[2]
        A = torch.zeros((nx, ny, 3, 3), dtype=U.dtype, device=U.device)
        h2 = U[0] * U[0]
        A[:, :, 1, 0] = -(U[2] * U[2]) / h2 + g * U[0]
        A[:, :, 2, 0] = -U[1] * U[2] / h2
        A[:, :, 0, 1] = 1.0
        A[:, :, 1, 1] = 2 * U[1] / U[0]
        A[:, :, 2, 1] = U[2] / U[0]
        A[:, :, 2, 2] = U[1] / U[0]
        return A
    return jacobian_x


def make_jacobian_y(g):
    """Flux-Jacobian B = dG/dU closure for lax_wendroff."""
    def jacobian_y(U):
        """B = dG/dU (shallow_water.py:537-553)."""
        nx, ny = U.shape[1], U.shape[2]
        B = torch.zeros((nx, ny, 3, 3), dtype=U.dtype, device=U.device)
        h2 = U[0] * U[0]
        B[:, :, 1, 0] = -U[1] * U[2] / h2
        B[:, :, 2, 0] = -(U[2] * U[2]) / h2 + g * U[0]
        B[:, :, 1, 1] = U[2] / U[0]
        B[:, :, 0, 2] = 1.0
        B[:, :, 1, 2] = U[1] / U[0]
        B[:, :, 2, 2] = 2 * U[2] / U[0]
        return B
    return jacobian_y


# --------------------------------------------------------------------------
# El Nino wind closure (shallow_water.py:272-308, 727-766)
# --------------------------------------------------------------------------

def masked_mean(field, mask):
    """Mean of field over mask > 0 cells.  A select, not a product, so an
    undefined value outside the mask can never poison the sum."""
    return torch.sum(torch.where(mask > 0, field, 0)) / torch.sum(mask)


def east_west_thickness(h, params: SWParams, east_mask=None, west_mask=None):
    """Mean thermocline depth near the east/west boundaries
    (shallow_water.py:738-766); the masks may be overridden."""
    east_mask = params.east_mask if east_mask is None else east_mask
    west_mask = params.west_mask if west_mask is None else west_mask
    return masked_mean(h, east_mask), masked_mean(h, west_mask)


def seasonal_wind(params: SWParams, t):
    """Annual sinusoid about the initial wind (shallow_water.py:727-736)."""
    t_year = 365 * 24 * 60 ** 2
    return params.wind_initial_tau + params.wind_seasonal_fluct * \
        torch.sin(t * 2 * math.pi / t_year)


def atmosphere_wind(params: SWParams, h_bc, t, wind_type, east_mask=None,
                    west_mask=None):
    """tau/h_mean wind stress for the u equation (shallow_water.py:272-308).
    ``h_bc`` must already satisfy the boundary conditions."""
    if wind_type is None or wind_type == 'unforced':
        return torch.zeros((), dtype=h_bc.dtype, device=h_bc.device)
    if wind_type == 'seasonal':
        return seasonal_wind(params, t)
    h_east, h_west = east_west_thickness(h_bc, params, east_mask, west_mask)
    forced = params.wind_gamma * (h_east - h_west)
    if wind_type == 'seasonal_forced':
        return forced + seasonal_wind(params, t) - params.wind_initial_tau
    if wind_type == 'forced':
        return forced
    raise ValueError(f"wind type {wind_type!r} not valid")


# --------------------------------------------------------------------------
# The step
# --------------------------------------------------------------------------

def cfl_dt(max2, t, dt_prev, ok, dt_0, dx, dy, target_courant):
    """(dt, ok) of the next step from max(u^2+v^2): CFL control after the
    first step, and the dt < 10 s abort (shallow_water.py:321-337); ``ok``
    is the carried flag.  The sharded steps (``parallel/halo.py``) share it."""
    max_u = torch.sqrt(max2)
    dt_cfl = torch.minimum(dt_0, target_courant * torch.minimum(dx, dy)
                           / max_u)
    dt = torch.where(t > 0, dt_cfl, dt_prev)
    return dt, ok & (dt >= 10.0)


def _cfl(state: SWState, params: SWParams, max2, target_courant):
    return cfl_dt(max2, state.t, state.dt, state.ok, params.dt_0, params.dx,
                  params.dy, target_courant)


def _orography_gradients(params: SWParams, flat_orography):
    if flat_orography:
        return None, None
    return (stencils.centered_diff_x(params.h_base, params.dx),
            stencils.centered_diff_y(params.h_base, params.dy))


def _check_linear(solver, linear):
    if solver == 'richtmyer_pallas' and linear:
        raise ValueError('richtmyer_pallas supports the nonlinear equations '
                         'only (use richtmyer for linear=True)')


def sw_step(state: SWState, params: SWParams, solver='richtmyer', linear=False,
            bx='periodic', by='walls', wind_type=None, target_courant=0.1,
            flat_orography=False, row_geometry=False):
    """One shallow-water time step (shallow_water.py:339-373).
    ``row_geometry`` is accepted for ``_step_kwargs`` and not read here."""
    h, u, v = state.h, state.u, state.v
    dt, ok = _cfl(state, params, torch.max(u * u + v * v), target_courant)

    if solver == 'richtmyer_pallas':
        _check_linear(solver, linear)
        # the fused kernel in its interior mode (K5): damping and the abort
        # freeze included; wind and boundary conditions below
        dhb_dx, dhb_dy = _orography_gradients(params, flat_orography)
        hi, ui, vi, _max2 = stencils.richtmyer_step_interior(
            h, u, v, params.f_coriolis[1:-1, 1:-1], params.r[1:-1, 1:-1],
            dhb_dx, dhb_dy, dt, ok, params.g, params.dx, params.dy)
        new = []
        for full, inner in ((h, hi), (u, ui), (v, vi)):
            full = full.clone()
            full[1:-1, 1:-1] = inner
            new.append(full)
        h_new, u_new, v_new = new
        # the BCs recompute the ghosts from the frozen interior, so the
        # freeze holds
        if wind_type is not None:
            h_for_wind = apply_boundary_conditions(h_new, u_new, v_new,
                                                   bx, by)[0]
            wind = atmosphere_wind(params, h_for_wind, state.t, wind_type)
            u_new = u_new + torch.where(ok, wind * dt, torch.zeros_like(dt))
        apply_boundary_conditions_(h_new, u_new, v_new, bx, by)
        return state.replace(h=h_new, u=u_new, v=v_new, t=state.t + dt,
                             dt=dt, ok=ok)
    flux_x = make_flux_x(params.g, params.h_mean, linear)
    flux_y = make_flux_y(params.g, params.h_mean, linear)
    source = make_source(params.g, params.f_coriolis, params.h_base,
                         params.dx, params.dy, linear)
    U = get_conservative_form(h, u, v, linear)
    if solver == 'lax_wendroff':
        U = stencils.lax_wendroff(U, flux_x, flux_y, source, dt, params.dx,
                                  params.dy, [0], h.shape[0], h.shape[1],
                                  make_jacobian_x(params.g),
                                  make_jacobian_y(params.g))
    else:
        U = stencils.SCHEMES[solver](U, flux_x, flux_y, source, dt, params.dx,
                                     params.dy, [0])
    h_new, u_new, v_new = get_physical_values(U, linear)
    return _finish_step(state, params, h, u, v, h_new, u_new, v_new, dt, ok,
                        bx, by, wind_type)


def _finish_step(state, params, h, u, v, h_new, u_new, v_new, dt, ok, bx, by,
                 wind_type):
    """Damping, wind feedback, boundary conditions, abort freeze
    (shallow_water.py:362-373)."""
    # Rayleigh damping against the *pre-step* velocities
    u_new = u_new - params.r * dt * u
    v_new = v_new - params.r * dt * v
    if wind_type is not None:
        h_for_wind = apply_boundary_conditions(h_new, u_new, v_new, bx, by)[0]
        wind = atmosphere_wind(params, h_for_wind, state.t, wind_type)
        u_new = u_new + wind * dt
    h_new, u_new, v_new = apply_boundary_conditions(h_new, u_new, v_new, bx, by)
    # freeze the state if the step failed (dt too small): the host raises
    h_new = torch.where(ok, h_new, h)
    u_new = torch.where(ok, u_new, u)
    v_new = torch.where(ok, v_new, v)
    return state.replace(h=h_new, u=u_new, v=v_new, t=state.t + dt, dt=dt,
                         ok=ok)


def _frame_constants(params: SWParams, flat_orography, row_geometry):
    """Loop-invariant inputs of the boundary-condition step, hoisted out of
    the run.  ``row_geometry=True`` passes the Coriolis and damping fields as
    single rows (both are y-only functions in every reference scenario), so
    the kernel reads two field passes less per step."""
    dhb_dx, dhb_dy = _orography_gradients(params, flat_orography)
    rows = slice(1, 2) if row_geometry else slice(1, -1)
    return (params.r[rows, 1:-1], params.east_mask, params.west_mask,
            params.f_coriolis[rows, 1:-1], dhb_dx, dhb_dy)


def sw_step_frame(state: SWState, max2, params: SWParams, extras, bx, by,
                  wind_type, target_courant, out=None):
    """sw_step through the kernel's boundary-condition mode (K6; the JAX
    package's padded-frame step, on unpadded fields).  Damping, the abort
    freeze, every ghost cell and the CFL statistic come out of the kernel;
    ``max2`` carries max(u^2+v^2) of the current state, so the CFL
    controller reads no field.  Then the wind, the x-wall u ghost re-zero,
    the y-periodic corner fix-ups and the max2 recompute, in that order
    (shallow_water.py:407-434 of the JAX package).

    :param out: optional (h, u, v) buffers for the new state.
    :return: (new state, max2 of the new state).
    """
    r_int, east, west, fcor_int, dhb_dx, dhb_dy = extras
    dt, ok = _cfl(state, params, max2, target_courant)
    h_new, u_new, v_new, max2_k = stencils.richtmyer_step_bc(
        state.h, state.u, state.v, fcor_int, r_int, dhb_dx, dhb_dy, dt, ok,
        params.g, params.dx, params.dy, bx, by, out=out)
    if wind_type is None:
        max2_new = max2_k
    else:
        # the kernel's outputs satisfy the BCs: the masked means read h_new
        wind = atmosphere_wind(params, h_new, state.t, wind_type,
                               east_mask=east, west_mask=west)
        u_new.add_(torch.where(ok, wind * dt, torch.zeros_like(dt)))
        if bx == 'walls':
            # the uniform wind add broke the zero x-wall u ghosts; restore
            # them (reference order: wind, then BCs)
            u_new[0, :] = 0.0
            u_new[-1, :] = 0.0
            if by == 'periodic':
                # per_y corner writes read interior values (wind included)
                u_new[0, 0] = u_new[1, -2]
                u_new[0, -1] = u_new[1, 1]
                u_new[-1, 0] = u_new[-2, -2]
                u_new[-1, -1] = u_new[-2, 1]
        # wind changed u: the CFL statistic over the new interior (the
        # ghosts replicate interior cells or are zero)
        ui = u_new[1:-1, 1:-1]
        vi = v_new[1:-1, 1:-1]
        max2_new = torch.max(ui * ui + vi * vi)
    return state.replace(h=h_new, u=u_new, v=v_new, t=state.t + dt, dt=dt,
                         ok=ok), max2_new


class _FrameRun:
    """The boundary-condition step, double-buffered: step k writes the
    buffers k mod 2, so a run allocates no field per step."""

    def __init__(self, state, params, bx, by, wind_type, target_courant,
                 flat_orography, row_geometry):
        self.params, self.bx, self.by = params, bx, by
        self.wind_type, self.target_courant = wind_type, target_courant
        self.extras = _frame_constants(params, flat_orography, row_geometry)
        self.buffers = [tuple(torch.empty_like(state.h) for _ in range(3))
                        for _ in range(2)]
        self.k = 0
        self.max2 = torch.max(state.u * state.u + state.v * state.v)

    def step(self, state):
        state, self.max2 = sw_step_frame(
            state, self.max2, self.params, self.extras, self.bx, self.by,
            self.wind_type, self.target_courant, out=self.buffers[self.k % 2])
        self.k += 1
        return state


def sw_simulate(state: SWState, params: SWParams, n_steps, solver='richtmyer',
                linear=False, bx='periodic', by='walls', wind_type=None,
                target_courant=0.1, flat_orography=False, row_geometry=False):
    """n_steps steps; with ``richtmyer_pallas`` through the kernel's
    boundary-condition mode (K6).  Reads nothing back to the host."""
    _check_linear(solver, linear)
    if solver == 'richtmyer_pallas':
        run = _FrameRun(state, params, bx, by, wind_type, target_courant,
                        flat_orography, row_geometry)
        for _ in range(n_steps):
            state = run.step(state)
        return state
    for _ in range(n_steps):
        state = sw_step(state, params, solver=solver, linear=linear, bx=bx,
                        by=by, wind_type=wind_type,
                        target_courant=target_courant,
                        flat_orography=flat_orography)
    return state


def sw_simulate_snapshots(state: SWState, params: SWParams, n_snaps,
                          steps_per_snap, solver='richtmyer', linear=False,
                          bx='periodic', by='walls', wind_type=None,
                          target_courant=0.1, flat_orography=False,
                          row_geometry=False):
    """Run n_snaps * steps_per_snap steps, keeping (t, h, u, v) every
    steps_per_snap steps.

    :return: (final state, (t [n_snaps], h, u, v [n_snaps, nx, ny])).
    """
    _check_linear(solver, linear)
    snaps = (torch.empty((n_snaps,), dtype=state.t.dtype,
                         device=state.t.device),
             *(torch.empty((n_snaps, *state.h.shape), dtype=state.h.dtype,
                           device=state.h.device) for _ in range(3)))
    if solver == 'richtmyer_pallas':
        step = _FrameRun(state, params, bx, by, wind_type, target_courant,
                         flat_orography, row_geometry).step
    else:
        def step(st):
            return sw_step(st, params, solver=solver, linear=linear, bx=bx,
                           by=by, wind_type=wind_type,
                           target_courant=target_courant,
                           flat_orography=flat_orography)
    for s in range(n_snaps):
        for _ in range(steps_per_snap):
            state = step(state)
        for buf, x in zip(snaps, (state.t, state.h, state.u, state.v)):
            buf[s] = x
    return state, snaps


# --------------------------------------------------------------------------
# User-facing model
# --------------------------------------------------------------------------

def _host_bcs(h, u, v, bx, by):
    """apply_boundary_conditions on float64 host arrays (copies only)."""
    out = apply_boundary_conditions(*(torch.from_numpy(np.array(a, np.float64))
                                      for a in (h, u, v)), bx, by)
    return tuple(a.numpy() for a in out)


class ShallowWater:
    """Reference-parity shallow-water model (shallow_water.py:10-89 ctor API),
    its state on ``device``: the card unless the caller names another
    (``device='cpu'``)."""

    def __init__(self, nx, ny, dx, dy, dt, f_0, beta, orography_info=None,
                 initial_info=None, boundary_type=None,
                 numerical_solver='richtmyer', r=0, g=g_earth, linear=False,
                 noise_seed=None, dtype=torch.float32, device='cuda'):
        self.nx, self.ny = int(nx), int(ny)
        self.dx, self.dy = float(dx), float(dy)
        self.dt_0 = float(dt)
        self.g = float(g)
        self.linear = bool(linear)
        if numerical_solver not in tuple(stencils.SCHEMES) + ('richtmyer_pallas',):
            raise ValueError(f'unknown solver {numerical_solver!r}')
        if numerical_solver == 'richtmyer_pallas' and linear:
            raise ValueError('richtmyer_pallas supports the nonlinear '
                             'equations only')
        self.numerical_solver = numerical_solver
        self.orography_info = orography_info
        self.initial_info = initial_info
        if boundary_type is None:
            boundary_type = {'x': 'periodic', 'y': 'walls'}
        self.boundary_type = boundary_type
        self.dtype = dtype
        self.device = torch.device(device)
        self._noise_seed = noise_seed

        x = np.arange(nx) * dx
        x = x - x.mean()
        y = np.arange(ny) * dy
        y = y - y.mean()
        self.Y, self.X = np.meshgrid(y, x)     # [nx, ny]
        # sponge-wall damping (shallow_water.py:78-81)
        self.r = np.ones((nx, ny)) * r
        if boundary_type.get('y') == 'walls' and 'y_walls_damp' in boundary_type:
            border = np.abs(self.Y[0]) >= boundary_type['y_walls_damp']['dist_thresh']
            self.r[:, border] = boundary_type['y_walls_damp']['r']
        self.f_0 = float(f_0)
        self.beta = float(beta)
        self.f_coriolis = f_0 + beta * self.Y
        self.h_base = self.orography()
        u, v, h_surface = self.initial_conditions()
        self.h_surface = h_surface
        h, u, v = _host_bcs(h_surface - self.h_base, u, v,
                            boundary_type['x'], boundary_type['y'])
        self.h_mean = float(h.mean())
        self._params_cache = None
        self._state = SWState(
            h=self._tensor(h), u=self._tensor(u), v=self._tensor(v),
            t=self._tensor(0.0), dt=self._tensor(self.dt_0),
            ok=torch.ones((), dtype=torch.bool, device=self.device))

    def _tensor(self, a):
        return torch.tensor(np.asarray(a, np.float64), device=self.device
                            ).to(self.dtype)

    # ------------- host-side scenario construction -------------

    def orography(self):
        """Rigid-base profile: flat / slope / mountain (shallow_water.py:101-127)."""
        info = self.orography_info
        if info is None:
            info = self.orography_info = {'type': 'flat'}
        if info['type'] == 'flat':
            return np.zeros((self.nx, self.ny))
        if info['type'] == 'slope':
            return info['max_h_base'] * (self.X - self.X.min()) / self.X.max()
        if info['type'] == 'mountain':
            return info['max_h_base'] * np.exp(
                -0.5 * ((self.X - info['x0']) / info['x_std']) ** 2
                - 0.5 * ((self.Y - info['y0']) / info['y_std']) ** 2)
        raise ValueError("orography_info['type'] not valid")

    def get_geostrophic_velocities(self, h_surface):
        """u = -(g/f) dh/dy, v = (g/f) dh/dx on the interior
        (shallow_water.py:129-141)."""
        u = np.zeros((self.nx, self.ny))
        v = np.zeros((self.nx, self.ny))
        f_int = self.f_coriolis[1:-1, 1:-1]
        u[1:-1, 1:-1] = -self.g * (h_surface[1:-1, 2:] - h_surface[1:-1, :-2]) \
            / (2 * self.dy) / f_int
        v[1:-1, 1:-1] = self.g * (h_surface[2:, 1:-1] - h_surface[:-2, 1:-1]) \
            / (2 * self.dx) / f_int
        return u, v

    def initial_conditions(self):
        """Scenario library (shallow_water.py:143-319)."""
        info = self.initial_info
        if info is None:
            info = self.initial_info = {
                'type': 'uniform_zonal',
                'mean_h_surface': 2 * np.max(self.h_base) + 1000,
                'u_mean': 20, 'add_noise': False}
        u = np.zeros((self.nx, self.ny))
        v = np.zeros((self.nx, self.ny))
        h_surface = np.ones((self.nx, self.ny))
        kind = info['type']
        if kind == 'uniform_zonal':
            h_surface = info['mean_h_surface'] - \
                (info['u_mean'] * self.f_0 / self.g) * self.Y
            u, v = self.get_geostrophic_velocities(h_surface)
        elif kind == 'sinusoidal_zonal':
            cos_mult = 2 * info['n_periods'] * np.pi / self.Y.max()
            if self.f_0 == 0:
                h_jet_max = np.abs(self.f_coriolis).mean() * info['u_max'] / \
                    (cos_mult * self.g)
            else:
                h_jet_max = self.f_0 * info['u_max'] / (cos_mult * self.g)
            h_surface = info['mean_h_surface'] - h_jet_max * \
                np.cos((self.Y - info['y0']) * cos_mult)
            u, v = self.get_geostrophic_velocities(h_surface)
        elif kind == 'jet_zonal':
            # Bickley jet: sech^2 wind <-> tanh height (shallow_water.py:182-189)
            h_jet_max = self.f_0 * info['u_max'] * info['jet_width'] / self.g
            h_surface = info['mean_h_surface'] - h_jet_max * \
                np.tanh((self.Y - info['y0']) / info['jet_width'])
            u, v = self.get_geostrophic_velocities(h_surface)
        elif kind == 'height_gaussian':
            h_surface = info['min_h_surface'] + \
                (info['max_h_surface'] - info['min_h_surface']) * np.exp(
                    -0.5 * ((self.X - info['x0']) / info['x_std']) ** 2
                    - 0.5 * ((self.Y - info['y0']) / info['y_std']) ** 2)
        elif kind == 'height_step':
            coord = self.Y if info['direction'] == 'y' else self.X
            h_surface = np.where(coord <= info['discontinuity_pos'],
                                 info['min_h_surface'], info['max_h_surface'])
        elif kind == 'el_nino':
            h_surface = self._el_nino_initial(info)
        else:
            raise ValueError("initial_info['type'] not valid")
        if info.get('add_noise'):
            amp = max(np.mean(np.abs(np.diff(h_surface))) / 10, 1e-20)
            rng = np.random.default_rng(self._noise_seed)
            h_surface = h_surface + rng.standard_normal(self.X.shape) * amp
        if np.min(h_surface) < np.max(self.h_base):
            raise ValueError('surface height is less than floor height')
        return u, v, h_surface

    def _el_nino_initial(self, info):
        """Tilted thermocline + Bjerknes feedback wind defaults
        (shallow_water.py:211-308)."""
        x_gradient = -((info['max_h_surface'] - info['min_h_surface'])
                       / (self.X.max() - self.X.min()))
        h_surface_mean = 0.5 * (info['max_h_surface'] + info['min_h_surface'])
        h_surface = h_surface_mean + self.X * x_gradient * \
            np.exp(-0.5 * ((self.Y - 0) / info['y_std']) ** 2)
        initial_tau_over_h_guess = x_gradient * self.g

        wind = info['wind']
        for key in ('gamma', 'seasonal_fluct', 'x_average_width',
                    'y_average_width'):
            wind.setdefault(key, None)
        if wind['gamma'] is None:
            # chosen so the feedback can turn the wind eastward
            # (shallow_water.py:239-242)
            wind['gamma'] = 1.2 * abs(initial_tau_over_h_guess) / (
                info['max_h_surface'] - info['min_h_surface'])
        c = np.sqrt(self.g * h_surface_mean)
        L_def = np.sqrt(c / self.beta) if self.beta else c * 3600
        if wind['x_average_width'] is None:
            wind['x_average_width'] = 8 * L_def
        if wind['y_average_width'] is None:
            wind['y_average_width'] = 5 * L_def

        # exact initial wind from the BC-consistent initial thickness
        # (shallow_water.py:252-260)
        h = h_surface - self.h_base
        h = _host_bcs(h, np.zeros_like(h), np.zeros_like(h),
                      self.boundary_type['x'], self.boundary_type['y'])[0]
        east, west = self._boundary_masks(wind['x_average_width'],
                                          wind['y_average_width'])
        h_east = h[east].mean() if east.any() else 0.0
        h_west = h[west].mean() if west.any() else 0.0
        wind['initial_tau_over_h'] = wind['gamma'] * (h_east - h_west)
        if wind['seasonal_fluct'] is None:
            if wind['type'] == 'seasonal':
                wind['seasonal_fluct'] = abs(wind['initial_tau_over_h'])
            else:
                wind['seasonal_fluct'] = abs(wind['initial_tau_over_h']) / 10
        return h_surface

    def _boundary_masks(self, x_average_width, y_average_width):
        """Boolean [nx, ny] masks for east/west boundary-strip averages
        (shallow_water.py:738-753)."""
        x_east = self.X[:, 0] >= self.X.max() - x_average_width
        x_west = self.X[:, 0] <= self.X.min() + x_average_width
        y_in = np.abs(self.Y[0]) <= y_average_width / 2
        east = x_east[:, None] & y_in[None, :]
        west = x_west[:, None] & y_in[None, :]
        return east, west

    # ------------- step plumbing -------------

    @property
    def wind_type(self):
        if self.initial_info.get('type') == 'el_nino':
            return self.initial_info['wind']['type']
        return None

    @property
    def params(self) -> SWParams:
        """Forcing and geometry on the device; cached, since the grid
        geometry is immutable after construction.  Call invalidate_params()
        after changing geometry attributes by hand."""
        if self._params_cache is None:
            self._params_cache = self._build_params()
        return self._params_cache

    def invalidate_params(self):
        self._params_cache = None

    def _build_params(self) -> SWParams:
        if self.wind_type is not None:
            w = self.initial_info['wind']
            east, west = self._boundary_masks(w['x_average_width'],
                                              w['y_average_width'])
            gamma = w['gamma']
            tau0 = w['initial_tau_over_h']
            fluct = w['seasonal_fluct']
        else:
            east = west = np.zeros((self.nx, self.ny), bool)
            gamma = tau0 = fluct = 0.0
        t = self._tensor
        return SWParams(
            f_coriolis=t(self.f_coriolis), h_base=t(self.h_base), r=t(self.r),
            g=t(self.g), h_mean=t(self.h_mean), dt_0=t(self.dt_0),
            dx=t(self.dx), dy=t(self.dy), wind_gamma=t(gamma),
            wind_initial_tau=t(tau0), wind_seasonal_fluct=t(fluct),
            east_mask=t(east), west_mask=t(west))

    @property
    def state(self) -> SWState:
        return self._state

    @property
    def h(self):
        return self._state.h.cpu().numpy()

    @property
    def u(self):
        return self._state.u.cpu().numpy()

    @property
    def v(self):
        return self._state.v.cpu().numpy()

    @property
    def dt(self):
        return float(self._state.dt)

    def _step_kwargs(self, target_courant=0.1):
        # the Coriolis and damping fields are y-only functions in every
        # reference scenario; when exactly row-constant the kernel reads
        # them as single rows (two field passes saved per step)
        row_geometry = bool(
            np.array_equal(self.r, np.broadcast_to(self.r[:1], self.r.shape))
            and np.array_equal(self.f_coriolis,
                               np.broadcast_to(self.f_coriolis[:1],
                                               self.f_coriolis.shape)))
        return dict(solver=self.numerical_solver, linear=self.linear,
                    bx=self.boundary_type['x'], by=self.boundary_type['y'],
                    wind_type=self.wind_type, target_courant=target_courant,
                    flat_orography=self.orography_info['type'] == 'flat',
                    row_geometry=row_geometry)

    def boundary_conditions(self, h, u, v):
        """Reference-parity helper (shallow_water.py:393-444) on host arrays."""
        return _host_bcs(h, u, v, self.boundary_type['x'],
                         self.boundary_type['y'])

    # ------------- stepping -------------

    def _pull(self, *xs):
        """Host copies of device tensors."""
        return tuple(x.cpu().numpy() for x in xs)

    def _raise_if_aborted(self):
        if not bool(self._state.ok):
            raise ValueError('time step very small')

    def time_step(self, t, data_dict=None, save_every=0.1, target_courant=0.1):
        """One step with reference data_dict semantics (shallow_water.py:339-373)."""
        if data_dict is None:
            data_dict = {'t': [t], 'h': [self.h], 'u': [self.u], 'v': [self.v]}
        self._state = self._state.replace(
            t=torch.tensor(float(t), dtype=self.dtype, device=self.device))
        self._state = sw_step(self._state, self.params,
                              **self._step_kwargs(target_courant))
        # one sync for the three scalars; the fields only on saving steps
        ok, t, dt = torch.stack([self._state.ok.to(torch.float64),
                                 self._state.t.double(),
                                 self._state.dt.double()]).tolist()
        if not ok:
            raise ValueError('time step very small')
        if np.divmod(t, save_every)[1] < dt:
            h, u, v = self._pull(self._state.h, self._state.u, self._state.v)
            data_dict['t'].append(t)
            data_dict['h'].append(h)
            data_dict['u'].append(u)
            data_dict['v'].append(v)
        return t, data_dict

    def save_data(self, data_dict, t):
        data_dict['t'].append(t)
        data_dict['h'].append(self.h)
        data_dict['u'].append(self.u)
        data_dict['v'].append(self.v)
        return data_dict

    def run(self, n_days=None, nt=None, save_every=None, target_courant=0.1,
            snapshots=True):
        """Run exactly ``nt`` steps on the device, reading back at the end.

        :param n_days: simulated days (nt = fix(n_days*86400/dt_0)+1, the
            reference driver convention, shallow_script.py:124-125).
        :param save_every: approximate save interval (s); snapshots are taken
            every round(save_every/dt_0) steps.
        :return: data_dict with stacked arrays 't', 'h', 'u', 'v'.
        """
        if nt is None:
            nt = int(np.fix(n_days * 24 * 60 ** 2 / self.dt_0) + 1)
        kw = self._step_kwargs(target_courant)
        if not snapshots:
            self._state = sw_simulate(self._state, self.params, nt, **kw)
            self._raise_if_aborted()
            t1, h1, u1, v1 = self._pull(self._state.t, self._state.h,
                                        self._state.u, self._state.v)
            return {'t': t1.reshape(1).astype(np.float64), 'h': h1[None],
                    'u': u1[None], 'v': v1[None]}
        steps_per_snap = 1 if save_every is None else \
            max(1, int(round(save_every / self.dt_0)))
        # exactly nt steps like the reference loop: full snapshot chunks plus
        # a remainder (< steps_per_snap steps, no snapshot of its own)
        n_snaps = nt // steps_per_snap
        remainder = nt - n_snaps * steps_per_snap
        t0, h0, u0, v0 = self._pull(self._state.t, self._state.h,
                                    self._state.u, self._state.v)
        snaps = None
        if n_snaps:
            self._state, snaps = sw_simulate_snapshots(
                self._state, self.params, n_snaps, steps_per_snap, **kw)
        if remainder:
            self._state = sw_simulate(self._state, self.params, remainder,
                                      **kw)
        self._raise_if_aborted()
        if snaps is None:
            t1, h1, u1, v1 = self._pull(self._state.t, self._state.h,
                                        self._state.u, self._state.v)
            return {'t': np.asarray([float(t0), float(t1)]),
                    'h': np.stack([h0, h1]), 'u': np.stack([u0, u1]),
                    'v': np.stack([v0, v1])}
        t_arr, h_arr, u_arr, v_arr = self._pull(*snaps)
        return {'t': np.concatenate([[float(t0)], t_arr]),
                'h': np.concatenate([h0[None], h_arr]),
                'u': np.concatenate([u0[None], u_arr]),
                'v': np.concatenate([v0[None], v_arr])}

    # ------------- El Nino diagnostics -------------

    def plot_animate(self, t_array, h_array, u_array, v_array, nPlotFrames=50,
                     fract_frames_at_start=0.0):
        """Height + vorticity animation with velocity quiver
        (shallow_water.py:580-725): surface height on a diverging colormap
        about the median initial height, vorticity about zero, axes normalised
        by the deformation radius."""
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation
        from mpl_toolkits.axes_grid1 import make_axes_locatable

        fig, axs = plt.subplots(2, 1, sharex=True,
                                figsize=(12 + int(max(self.nx / 250 - 1, 0)),
                                         6 + int(max(self.ny / 50 - 1, 0))))
        cax1 = make_axes_locatable(axs[0]).append_axes('right', '5%', '5%')
        cax2 = make_axes_locatable(axs[1]).append_axes('right', '5%', '5%')
        interval = int(min(6, self.ny / 5, self.nx / 5))

        t_plot = np.asarray(t_array)
        h_plot = np.asarray(h_array)
        u_plot = np.asarray(u_array)
        v_plot = np.asarray(v_array)
        if t_plot.size > nPlotFrames:
            start_end = int(fract_frames_at_start * nPlotFrames)
            use_start = np.arange(0, start_end)
            use_end = np.unique(np.linspace(start_end, t_plot.size - 1,
                                            int((1 - fract_frames_at_start)
                                                * nPlotFrames),
                                            dtype=int))[1:]
            use = np.concatenate((use_start, use_end))
            t_plot, h_plot = t_plot[use], h_plot[use]
            u_plot, v_plot = u_plot[use], v_plot[use]

        # axes normalised by the deformation radius (shallow_water.py:627-634)
        c = np.sqrt(self.g * np.median(h_plot[0]))
        if self.f_0 == 0 and self.beta == 0:
            L_def = c * 3600
        elif self.f_0 != 0:
            L_def = c / self.f_0
        else:
            L_def = np.sqrt(c / self.beta)
        x = self.X[1:-1, 0] / L_def
        y = self.Y[0, 1:-1] / L_def
        h_base = self.h_base[1:-1, 1:-1]
        h_surf = h_plot[:, 1:-1, 1:-1] + h_base
        med = np.median(self.h_surface)
        dmax = np.abs(h_surf - med).max()
        h_lims = (med - dmax, med + dmax)
        vort = np.stack([stencils.centered_diff_x(v_plot[i], self.dx)
                         - stencils.centered_diff_y(u_plot[i], self.dy)
                         for i in range(t_plot.size)])
        v_lims = (-np.abs(vort).max(), np.abs(vort).max())
        min_space = min(self.dx / L_def, self.dy / L_def)
        vel_max = np.sqrt((u_plot ** 2 + v_plot ** 2).max())
        scale = min_space * interval / max(vel_max, 1e-30)

        def animate(i):
            cax1.cla()
            cax2.cla()
            axs[0].clear()
            axs[1].clear()
            im = axs[0].imshow(h_surf[i].T, extent=[x.min(), x.max(),
                                                    y.min(), y.max()],
                               cmap='bwr', origin='lower')
            fig.colorbar(im, cax=cax1).set_label('height (m)')
            if self.orography_info['type'] != 'flat':
                axs[0].contour(x, y, h_base.T, colors='g', alpha=0.25)
            u_i = u_plot[i][1:-1, 1:-1]
            v_i = v_plot[i][1:-1, 1:-1]
            axs[0].quiver(x[2::interval], y[2::interval],
                          (u_i[2::interval, 2::interval] * scale).T,
                          (v_i[2::interval, 2::interval] * scale).T,
                          scale_units='xy', scale=1, minshaft=2, pivot='mid')
            im2 = axs[1].imshow(vort[i].T, extent=[x.min(), x.max(),
                                                   y.min(), y.max()],
                                cmap='bwr', origin='lower')
            fig.colorbar(im2, cax=cax2).set_label('vorticity (s$^{-1}$)')
            im.set_clim(h_lims)
            im2.set_clim(v_lims)
            for ax in axs:
                ax.axis((x.min(), x.max(), y.min(), y.max()))
            t_days, t_hours = divmod(t_plot[i] / 3600.0, 24)
            axs[0].text(0.5, 1.01,
                        f'{t_days:.0f} Days and {t_hours:.1f} Hours',
                        horizontalalignment='center',
                        verticalalignment='bottom',
                        transform=axs[0].transAxes)

        self._animate_frame = animate    # exposed for tests
        return FuncAnimation(fig, animate, frames=t_plot.size, interval=100,
                             blit=False, repeat_delay=200)

    def el_nino_seasonal_wind(self, t):
        w = self.initial_info['wind']
        t_year = 365 * 24 * 60 ** 2
        return w['initial_tau_over_h'] + w['seasonal_fluct'] * \
            np.sin(np.asarray(t) * 2 * np.pi / t_year)

    def get_average_east_west_boundary_thickness(self, h, x_average_width,
                                                 y_average_width):
        """Mean thickness near east/west boundaries, for single fields or
        stacked time series (shallow_water.py:738-766)."""
        east, west = self._boundary_masks(x_average_width, y_average_width)
        h = np.asarray(h)
        if h.ndim == 2:
            return h[east].mean(), h[west].mean()
        flat = h.reshape(h.shape[0], -1)
        return (flat[:, east.ravel()].mean(axis=1),
                flat[:, west.ravel()].mean(axis=1))

    def el_nino_plot(self, t, h, x_average_width=None, y_average_width=None):
        """East/west thermocline + wind time-series plot
        (shallow_water.py:768-828)."""
        import matplotlib.pyplot as plt
        w = self.initial_info['wind']
        # 'is None' (not falsy-or): an explicit 0 width selects the boundary
        # column, like the reference (shallow_water.py:785-788)
        if x_average_width is None:
            x_average_width = w['x_average_width']
        if y_average_width is None:
            y_average_width = w['y_average_width']
        h_east, h_west = self.get_average_east_west_boundary_thickness(
            h, x_average_width, y_average_width)
        h_avg = np.asarray(h)[0].mean()
        t_days = np.asarray(t) / 86400.0
        fig, ax = plt.subplots(1, 1, figsize=(12, 5))
        ln1 = ax.plot(t_days, h_east, label=r'$\overline{h}_{east}$', color='b')
        ln2 = ax.plot(t_days, h_west, label=r'$\overline{h}_{west}$', color='r')
        rng = max(np.abs(h_east - h_avg).max(), np.abs(h_west - h_avg).max())
        ax.set_ylim((h_avg - rng * 1.1, h_avg + rng * 1.1))
        ax.set_ylabel('Thermocline Depth / m')
        ax.set_xlabel('Time / days')
        ax2 = ax.twinx()
        feedback = w['gamma'] * (h_east - h_west)
        if 'seasonal' in w['type']:
            seasonal = self.el_nino_seasonal_wind(np.asarray(t))
            total = feedback + seasonal - w['initial_tau_over_h']
            ln3 = ax2.plot(t_days, seasonal, 'g--', label='seasonal wind')
        else:
            total = feedback
            ln3 = ax2.plot(t_days, np.full_like(t_days,
                                                w['initial_tau_over_h']),
                           'g--', label='Initial wind')
        ln4 = ax2.plot(t_days, total, 'k--', label='total wind')
        ax2.set_ylabel(r'Wind: $\tau^x / h_{mean}$')
        lns = ln1 + ln2 + ln3 + ln4
        ax.legend(lns, [l.get_label() for l in lns], loc=0)
        return fig
