"""Conservative finite-volume/finite-difference schemes for the shallow-water
engine (port of ``climatemodel_tpu/ops/stencils.py``), the ghost-cell
boundary conditions, and the fused nonlinear Richtmyer step.

Solves dU/dt + df(U)/dx + dg(U)/dy = Q(U) on a ghost-cell grid.  U has shape
[n_conserved, nx, ny] with one ghost cell on every side; the schemes update
the interior and leave the ghosts to :func:`apply_boundary_conditions`.  Each
stage evaluates f/g once on the full (or half-step) array and takes shifted
slices of the result, as the JAX package does.  The four schemes are plain
PyTorch on every device: the JAX package has no kernel for them either.

The fused step is the one kernel of this module.  :func:`richtmyer_step_interior`
(Pallas K5, ``pallas_stencils.richtmyer_step_interior``) returns the new
interior and max(u^2+v^2); :func:`richtmyer_step_bc` (Pallas K6,
``pallas_stencils.richtmyer_step_frame``) also writes every ghost cell of
:func:`apply_boundary_conditions`.  A CPU tensor takes the plain versions
below, written in the kernel's op order; any other device goes to the CUDA
kernel (``csrc/stencils.cu`` through ``cuda_stencils``), which raises if it
cannot run.  The Pallas kernels' padded frame and band picker are Mosaic
artefacts with no counterpart here: the CUDA kernel takes every grid size.
"""
from __future__ import annotations

import torch

#: boundary modes of the fused step: x ghost rows, y ghost lanes
BX_MODES = ('walls', 'periodic', 'given')
BY_MODES = ('walls', 'periodic')


def include_source(u, un, u_new_no_source, Q, no_source_ind, dt):
    """Two-stage source handling (numerical_methods.py:108-132): source-free
    components are committed first, then Q is evaluated at (u + un)/2 with the
    committed components visible, and added to every component."""
    u = u.clone()
    for i in no_source_ind:
        u[i, 1:-1, 1:-1] = u_new_no_source[i]
    u_for_source = 0.5 * (u + un)
    u[:, 1:-1, 1:-1] = u_new_no_source + Q(u_for_source) * dt
    return u


def lax_friedrichs(u, f, g, Q, dt, dx, dy, no_source_ind=()):
    """First-order Lax-Friedrichs (numerical_methods.py:11-21)."""
    un = u
    sx = dt / dx
    sy = dt / dy
    F = f(un)
    G = g(un)
    u_new = (0.25 * (un[:, 2:, 1:-1] + un[:, :-2, 1:-1]
                     + un[:, 1:-1, 2:] + un[:, 1:-1, :-2])
             - 0.5 * sx * (F[:, 2:, 1:-1] - F[:, :-2, 1:-1])
             - 0.5 * sy * (G[:, 1:-1, 2:] - G[:, 1:-1, :-2]))
    return include_source(u, un, u_new, Q, no_source_ind, dt)


def richtmyer(u, f, g, Q, dt, dx, dy, no_source_ind=()):
    """Two-step Richtmyer Lax-Wendroff, the reference default
    (numerical_methods.py:62-80)."""
    un = u
    sx = dt / dx
    sy = dt / dy
    F = f(un)
    G = g(un)
    u_half_x = (0.5 * (un[:, 1:, 1:-1] + un[:, :-1, 1:-1])
                - 0.5 * sx * (F[:, 1:, 1:-1] - F[:, :-1, 1:-1]))
    u_half_y = (0.5 * (un[:, 1:-1, 1:] + un[:, 1:-1, :-1])
                - 0.5 * sy * (G[:, 1:-1, 1:] - G[:, 1:-1, :-1]))
    F_h = f(u_half_x)
    G_h = g(u_half_y)
    u_new = (un[:, 1:-1, 1:-1]
             - sx * (F_h[:, 1:, :] - F_h[:, :-1, :])
             - sy * (G_h[:, :, 1:] - G_h[:, :, :-1]))
    return include_source(u, un, u_new, Q, no_source_ind, dt)


def maccormack(u, f, g, Q, dt, dx, dy, no_source_ind=()):
    """MacCormack predictor-corrector (numerical_methods.py:83-105)."""
    un = u
    sx = dt / dx
    sy = dt / dy
    F = f(un)
    G = g(un)
    u_pred = (un[:, :-1, :-1]
              - sx * (F[:, 1:, :-1] - F[:, :-1, :-1])
              - sy * (G[:, :-1, 1:] - G[:, :-1, :-1]))
    F_p = f(u_pred)
    G_p = g(u_pred)
    # the reference scales the corrector's G-flux (y) difference by sigma_x,
    # not sigma_y (numerical_methods.py:93); kept for parity with it and
    # with the JAX package.  Harmless on square grids (dx == dy).
    u_new = (0.5 * (un[:, 1:-1, 1:-1] + u_pred[:, 1:, 1:])
             - 0.5 * sx * (F_p[:, 1:, 1:] - F_p[:, :-1, 1:])
             - 0.5 * sx * (G_p[:, 1:, 1:] - G_p[:, 1:, :-1]))
    return include_source(u, un, u_new, Q, no_source_ind, dt)


def jacobian_mult(J, f):
    """Contract Jacobian [nx, ny, n, n] with vector field [n, nx, ny]
    (numerical_methods.py:24-35)."""
    return torch.einsum('xyij,jxy->ixy', J, f)


def lax_wendroff(u, f, g, Q, dt, dx, dy, no_source_ind, nx, ny, A, B):
    """Single-step Lax-Wendroff with flux Jacobians A = df/dU, B = dg/dU
    (numerical_methods.py:38-59)."""
    un = u
    sx = dt / dx
    sy = dt / dy
    F = f(un)
    G = g(un)
    A_ph = A(0.5 * (un[:, 2:, 1:-1] + un[:, 1:-1, 1:-1]))
    A_ph_term = jacobian_mult(A_ph, F[:, 2:, 1:-1] - F[:, 1:-1, 1:-1])
    A_mh = A(0.5 * (un[:, 1:-1, 1:-1] + un[:, :-2, 1:-1]))
    A_mh_term = jacobian_mult(A_mh, F[:, 1:-1, 1:-1] - F[:, :-2, 1:-1])
    B_ph = B(0.5 * (un[:, 1:-1, 2:] + un[:, 1:-1, 1:-1]))
    B_ph_term = jacobian_mult(B_ph, G[:, 1:-1, 2:] - G[:, 1:-1, 1:-1])
    B_mh = B(0.5 * (un[:, 1:-1, 1:-1] + un[:, 1:-1, :-2]))
    B_mh_term = jacobian_mult(B_mh, G[:, 1:-1, 1:-1] - G[:, 1:-1, :-2])
    u_new = (un[:, 1:-1, 1:-1]
             - 0.5 * sx * (F[:, 2:, 1:-1] - F[:, :-2, 1:-1])
             + 0.5 * (sx * sx) * (A_ph_term - A_mh_term)
             - 0.5 * sy * (G[:, 1:-1, 2:] - G[:, 1:-1, :-2])
             + 0.5 * (sy * sy) * (B_ph_term - B_mh_term))
    return include_source(u, un, u_new, Q, no_source_ind, dt)


def centered_diff_x(u, dx):
    """du/dx on the interior (numerical_methods.py:135-139)."""
    return (u[2:, 1:-1] - u[:-2, 1:-1]) / (2 * dx)


def centered_diff_y(u, dy):
    """du/dy on the interior (numerical_methods.py:142-146)."""
    return (u[1:-1, 2:] - u[1:-1, :-2]) / (2 * dy)


SCHEMES = {
    'lax_friedrichs': lax_friedrichs,
    'lax_wendroff': lax_wendroff,
    'richtmyer': richtmyer,
    'maccormack': maccormack,
}


# --------------------------------------------------------------------------
# Ghost-cell boundary conditions (shallow_water.py:393-444 of the reference)
# --------------------------------------------------------------------------

def apply_boundary_conditions_(h, u, v, bx='periodic', by='walls'):
    """In-place :func:`apply_boundary_conditions`: the x block, then the y
    block, each write in the reference's order (corner rules included).
    ``bx='given'`` leaves the x ghost rows as they are."""
    if bx == 'periodic':
        for f in (h, u, v):
            f[0, 1:-1] = f[-2, 1:-1]
            f[0, 0] = f[-2, 1]
            f[0, -1] = f[-2, -2]
            f[-1, 1:-1] = f[1, 1:-1]
            f[-1, 0] = f[1, 1]
            f[-1, -1] = f[1, -2]
    elif bx == 'walls':
        u[0, :] = 0.0
        u[-1, :] = 0.0
        for f in (h, v):
            f[0, :] = f[1, :]
            f[-1, :] = f[-2, :]
    if by == 'periodic':
        for f in (h, u, v):
            f[1:-1, 0] = f[1:-1, -2]
            f[0, 0] = f[1, -2]
            f[-1, 0] = f[-2, -2]
            f[1:-1, -1] = f[1:-1, 1]
            f[0, -1] = f[1, 1]
            f[-1, -1] = f[-2, -1]
    elif by == 'walls':
        v[:, 0] = 0.0
        v[:, -1] = 0.0
        for f in (h, u):
            f[:, 0] = f[:, 1]
            f[:, -1] = f[:, -2]
    return h, u, v


def apply_boundary_conditions(h, u, v, bx='periodic', by='walls'):
    """Ghost-cell boundary conditions on copies of [nx, ny] fields, x block
    then y block exactly like the reference (corner handling included)."""
    return apply_boundary_conditions_(h.clone(), u.clone(), v.clone(), bx, by)


# --------------------------------------------------------------------------
# The fused nonlinear Richtmyer step (Pallas K5 / K6)
# --------------------------------------------------------------------------

def _scalars(h, *xs):
    return tuple(torch.as_tensor(x, dtype=h.dtype, device=h.device)
                 for x in xs)


def richtmyer_step_interior_plain(h, u, v, f_cor_int, r_int, dhb_dx, dhb_dy,
                                  dt, ok, g, dx, dy):
    """Plain PyTorch version of the fused step, in the op order of the CUDA
    kernel and of ``pallas_stencils._fused_update``: the conservative form,
    both Richtmyer stages (reciprocals ``1 / h`` then products), the source
    at half-time h with the exact Coriolis cancellation f * vh, Rayleigh
    damping against the pre-step u and v, and the ``ok`` freeze.  ``dt``,
    ``g``, ``dx``, ``dy`` are scalars in h's dtype; ``sx = dt / dx`` is one
    division in that dtype, as the kernel computes it.

    :return: (h, u, v, max2): the interior [nx-2, ny-2] fields (wind and
        boundary conditions not applied) and max(u^2+v^2) over them, NaN if
        any of them is NaN.
    """
    dt, g, dx, dy = _scalars(h, dt, g, dx, dy)
    ok = torch.as_tensor(ok, device=h.device)
    sx = dt / dx
    sy = dt / dy
    half_g = 0.5 * g
    uh = h * u
    vh = h * v
    gh2 = half_g * h * h
    F1 = uh * u + gh2
    F2 = uh * v                      # also G1
    G2 = vh * v + gh2

    def half_x(q, Fq):
        return (0.5 * (q[1:, 1:-1] + q[:-1, 1:-1])
                - 0.5 * sx * (Fq[1:, 1:-1] - Fq[:-1, 1:-1]))

    def half_y(q, Gq):
        return (0.5 * (q[1:-1, 1:] + q[1:-1, :-1])
                - 0.5 * sy * (Gq[1:-1, 1:] - Gq[1:-1, :-1]))

    hx0, hx1, hx2 = half_x(h, uh), half_x(uh, F1), half_x(vh, F2)
    hy0, hy1, hy2 = half_y(h, vh), half_y(uh, F2), half_y(vh, G2)
    inv_hx = 1.0 / hx0
    Fh0 = hx1
    Fh1 = hx1 * hx1 * inv_hx + half_g * hx0 * hx0
    Fh2 = hx1 * hx2 * inv_hx
    inv_hy = 1.0 / hy0
    Gh0 = hy2
    Gh1 = hy1 * hy2 * inv_hy
    Gh2 = hy2 * hy2 * inv_hy + half_g * hy0 * hy0

    def update(q, Fh, Gh):
        return (q[1:-1, 1:-1] - sx * (Fh[1:, :] - Fh[:-1, :])
                - sy * (Gh[:, 1:] - Gh[:, :-1]))

    h_w, u_w, v_w = h[1:-1, 1:-1], u[1:-1, 1:-1], v[1:-1, 1:-1]
    uh_w, vh_w = uh[1:-1, 1:-1], vh[1:-1, 1:-1]
    h_new = update(h, Fh0, Gh0)
    uh_new = update(uh, Fh1, Gh1)
    vh_new = update(vh, Fh2, Gh2)
    if dhb_dx is None:
        Q1 = f_cor_int * vh_w
        Q2 = -f_cor_int * uh_w
    else:
        gh_mid = g * (0.5 * (h_new + h_w))
        Q1 = f_cor_int * vh_w - gh_mid * dhb_dx
        Q2 = -f_cor_int * uh_w - gh_mid * dhb_dy
    uh_new = uh_new + Q1 * dt
    vh_new = vh_new + Q2 * dt
    inv_new = 1.0 / h_new
    r_dt = r_int * dt
    u_new = uh_new * inv_new - r_dt * u_w
    v_new = vh_new * inv_new - r_dt * v_w
    h_out = torch.where(ok, h_new, h_w)
    u_out = torch.where(ok, u_new, u_w)
    v_out = torch.where(ok, v_new, v_w)
    return h_out, u_out, v_out, torch.max(u_out * u_out + v_out * v_out)


def richtmyer_step_bc_plain(h, u, v, f_cor_int, r_int, dhb_dx, dhb_dy, dt,
                            ok, g, dx, dy, bx='periodic', by='walls'):
    """Plain version of the fused step with boundary conditions: the
    interior of :func:`richtmyer_step_interior_plain` set into copies of the
    [nx, ny] inputs, then :func:`apply_boundary_conditions_`.  With
    ``bx='given'`` the x ghost rows keep the input's values (the kernel
    leaves them unwritten)."""
    hi, ui, vi, max2 = richtmyer_step_interior_plain(
        h, u, v, f_cor_int, r_int, dhb_dx, dhb_dy, dt, ok, g, dx, dy)
    out = []
    for full, inner in ((h, hi), (u, ui), (v, vi)):
        full = full.clone()
        full[1:-1, 1:-1] = inner
        out.append(full)
    return (*apply_boundary_conditions_(*out, bx, by), max2)


def richtmyer_step_interior(h, u, v, f_cor_int, r_int, dhb_dx, dhb_dy, dt, ok,
                            g, dx, dy):
    """One fused nonlinear Richtmyer interior update (K5).

    :param h, u, v: [nx, ny] full fields including ghost cells (old values,
        boundary conditions already applied).
    :param f_cor_int, r_int: interior Coriolis and damping fields,
        [nx-2, ny-2] or one broadcast row [1, ny-2].
    :param dhb_dx, dhb_dy: [nx-2, ny-2] orography gradients, or ``None``
        for both on flat orography (bit-identical to zero gradients).
    :param dt, ok, g, dx, dy: scalars (0-d tensors on h's device on the
        card: the kernel reads them there, with no host sync).
    :return: (h, u, v, max2) interior [nx-2, ny-2] updated fields (damped,
        frozen; before wind stress and boundary conditions) and the scalar
        max(u^2+v^2) over them.
    """
    if h.device.type == 'cpu':
        return richtmyer_step_interior_plain(h, u, v, f_cor_int, r_int,
                                             dhb_dx, dhb_dy, dt, ok, g, dx, dy)
    from .cuda_stencils import richtmyer_step
    return richtmyer_step(h, u, v, f_cor_int, r_int, dhb_dx, dhb_dy, dt, ok,
                          g, dx, dy)


def richtmyer_step_bc(h, u, v, f_cor_int, r_int, dhb_dx, dhb_dy, dt, ok, g,
                      dx, dy, bx='periodic', by='walls', out=None):
    """The fused step with every ghost cell of
    :func:`apply_boundary_conditions` (K6): [nx, ny] fields in, [nx, ny]
    fields out.  Equal to ``unpad_frame(richtmyer_step_frame(pad_frame(...)))``
    of the JAX package for bx in walls/periodic; for ``bx='given'`` the x
    ghost rows of the output are left to the caller.

    :param out: optional (h, u, v) [nx, ny] tensors to write the result into
        (double-buffered runs allocate nothing per step); they must not
        share memory with h, u, v.
    :return: (h, u, v, max2).
    """
    if bx not in BX_MODES or by not in BY_MODES:
        raise ValueError(f'richtmyer_step_bc: boundary modes ({bx!r}, {by!r}) '
                         f'not in {BX_MODES} x {BY_MODES}')
    if h.device.type == 'cpu':
        res = richtmyer_step_bc_plain(h, u, v, f_cor_int, r_int, dhb_dx,
                                      dhb_dy, dt, ok, g, dx, dy, bx, by)
        if out is None:
            return res
        for o, x in zip(out, res[:3]):
            o.copy_(x)
        return (*out, res[3])
    from .cuda_stencils import richtmyer_step
    return richtmyer_step(h, u, v, f_cor_int, r_int, dhb_dx, dhb_dy, dt, ok,
                          g, dx, dy, bx=bx, by=by, out=out)
