"""Grey two-stream fluxes in plain PyTorch, members as rows.

The long-wave recurrence walks from the top of the atmosphere down
(grey.py:251-275 of the NumPy original), with up = the net absorbed stellar
flux and down = 0 at the top; the short-wave fluxes follow Beer's law
(grey.py:277-294).  Every function takes the dtype of its inputs, so the
same code gives the float64 reference and the lower-precision control.
"""
from __future__ import annotations

import torch

from .world import SIGMA


def absorbed(F, albedo_mod):
    """[B] net absorbed stellar flux: the long-wave boundary at the top."""
    return (1.0 - albedo_mod) * F / 4.0


def sw_fluxes(F, world, dtype, device):
    """(up, down) [B, n + 1] short-wave fluxes of members forced by F [B]."""
    base_up = world.albedo_mod * F[:, None] / 4.0
    base_down = F[:, None] / 4.0
    if world.tau_sw_interface is None:
        shape = (F.shape[0], world.n + 1)
        return base_up.expand(shape), base_down.expand(shape)
    tau = torch.as_tensor(world.tau_sw_interface, dtype=dtype, device=device)
    return base_up * torch.exp(tau), base_down * torch.exp(-tau)


def net_flux(T, F, world, sw=None):
    """[B, n + 1] net upward flux at every interface of cell temperatures
    T [B, n] (surface first) under stellar constants F [B].  ``sw``: the
    (up, down) short-wave fluxes, if already formed."""
    dtype, device = T.dtype, T.device
    dtau = torch.as_tensor(world.dtau, dtype=dtype, device=device)
    e_up, e_down = torch.exp(dtau), torch.exp(-dtau)
    src = SIGMA * T ** 4
    up = absorbed(F, world.albedo_mod)
    down = torch.zeros_like(up)
    ups, downs = [up], [down]
    for i in range(world.n - 1, -1, -1):
        up = up * e_up[i] + src[:, i] * (1.0 - e_up[i])
        down = down * e_down[i] + src[:, i] * (1.0 - e_down[i])
        ups.append(up)
        downs.append(down)
    up_lw = torch.stack(ups[::-1], 1)
    down_lw = torch.stack(downs[::-1], 1)
    up_sw, down_sw = sw if sw is not None else sw_fluxes(F, world, dtype,
                                                         device)
    return up_lw - down_lw + up_sw - down_sw


def radiative_equilibrium(F, world):
    """[B, n] the exact radiative equilibrium of a world transparent to
    short waves: the temperatures at which the net flux vanishes at every
    interface.  With up - down = the absorbed flux A at every interface,
    each cell's source follows from the one above it:
    S = (up' e^{d} - down' e^{-d} - A) / (e^{d} - e^{-d})."""
    if world.tau_sw_interface is not None:
        raise ValueError('the closed form needs a world transparent to '
                         'short waves')
    dtau = torch.as_tensor(world.dtau, dtype=F.dtype, device=F.device)
    A = absorbed(F, world.albedo_mod)
    up, down = A, torch.zeros_like(A)
    T = [None] * world.n
    for i in range(world.n - 1, -1, -1):
        ep, em = torch.exp(dtau[i]), torch.exp(-dtau[i])
        S = (up * ep - down * em - A) / (ep - em)
        T[i] = (S / SIGMA) ** 0.25
        up = up * ep + S * (1.0 - ep)
        down = down * em + S * (1.0 - em)
    return torch.stack(T, 1)
