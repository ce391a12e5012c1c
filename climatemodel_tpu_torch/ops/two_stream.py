"""Two-stream grey radiative flux operators (port of
``climatemodel_tpu/ops/two_stream.py``).

The long-wave fluxes follow the reference's sequential per-level loop
(grey.py:251-275 of the NumPy original), surface-first:

    up[i]   = up[i+1]   * exp(+dtau[i]) + sigma*T[i]^4 * (1 - exp(+dtau[i]))
    down[i] = down[i+1] * exp(-dtau[i]) + sigma*T[i]^4 * (1 - exp(-dtau[i]))

with up = net absorbed stellar flux and down = 0 at the top of the
atmosphere.  Each function that holds a kernel dispatches on the device of
its tensors: a CPU tensor takes the plain PyTorch version beside the kernel
(:func:`lw_flux_sequential`, :func:`net_stats_rows_plain`); any other
device goes to the CUDA kernel in ``ops/cuda_two_stream.py``, which raises
where it cannot launch.  There is no fallback from the kernel to the plain
version.

The TOA-first orientation and the differentiable path of the
sensitivities (:func:`lw_flux_plain`) evaluate the same recurrence as an
affine scan in log depth (:func:`affine_scan`), in the JAX package's
``lax.associative_scan`` order and with out-of-place tensor ops only, so
``torch.func.jacfwd`` can batch it.  The scan is plain PyTorch on every
device; it is not a path of the ``lw_walk`` kernel.

Short-wave fluxes are the closed-form Beer law (grey.py:277-294).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import sigma


def _source(T):
    """sigma T^4, written as sigma (T^2 T^2) — the CUDA kernels round in
    exactly this order, and JAX's ``T ** 4`` (``lax.integer_pow``) squares
    twice too."""
    sq = T * T
    return sigma * (sq * sq)


def lw_flux_sequential(T, dtau, up_flux_toa, surface_first=True):
    """Plain PyTorch twin of the ``lw_walk`` kernel (K1/K2): the
    reference's sequential loop, surface-first.

    The T-only factors (both exponentials and the source terms) are formed
    for all levels at once; the loop then applies ``x * e + s (1 - e)`` in
    the kernel's rounding order (one rounding per product and sum, no fused
    multiply-add).

    :param T, dtau: [nz-1, ...] cell temperatures and |optical depth
        differences| (index 0 = surface; with ``surface_first=False``
        index 0 = TOA, the real-gas orientation).
    :param up_flux_toa: [...] TOA upward boundary condition.
    :param surface_first: False walks the TOA-first column: the inputs are
        flipped on axis 0, walked surface-first and the fluxes flipped
        back, as the JAX package's scan does.
    :return: (up, down) [nz, ...] interface fluxes, in the inputs'
        orientation.
    """
    if not surface_first:
        up, down = lw_flux_sequential(torch.flip(T, (0,)),
                                      torch.flip(torch.broadcast_to(
                                          dtau, T.shape), (0,)), up_flux_toa)
        return torch.flip(up, (0,)), torch.flip(down, (0,))
    dtau = torch.broadcast_to(dtau, T.shape)
    src = _source(T)
    # both streams walk together as one [2, ...] row: stream 0 up, 1 down
    e = torch.exp(torch.stack([dtau, -dtau], 1))           # [n, 2, ...]
    s = src[:, None] * (1.0 - e)
    x = torch.stack([torch.broadcast_to(up_flux_toa, T.shape[1:]).to(T.dtype),
                     torch.zeros(T.shape[1:], dtype=T.dtype, device=T.device)])
    rows = [x]
    for e_i, s_i in zip(reversed(e.unbind(0)), reversed(s.unbind(0))):
        x = x * e_i + s_i
        rows.append(x)
    flux = torch.stack(rows[::-1])                          # [n+1, 2, ...]
    return flux[:, 0], flux[:, 1]


def _combine(a1, b1, a2, b2):
    """The affine maps x -> a1 x + b1, then x -> a2 x + b2, as one."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """Rows even[0], odd[0], even[1], odd[1], ... (len(even) is len(odd)
    or one more)."""
    n = odd.shape[0]
    both = torch.stack([even[:n], odd], 1).reshape((2 * n,) + odd.shape[1:])
    return torch.cat([both, even[n:]], 0)


def _associative_scan(a, b):
    """Inclusive prefix composition of the affine maps (a_k, b_k) along
    axis 0, in the recursion and rounding order of JAX's
    ``lax.associative_scan``: pairs combined, the half-length scan
    recursed, the even elements finished from it."""
    n = a.shape[0]
    if n < 2:
        return a, b
    ra, rb = _combine(a[0:-1:2], b[0:-1:2], a[1::2], b[1::2])
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:-1], ob[:-1], a[2::2], b[2::2])
    else:
        ea, eb = _combine(oa, ob, a[2::2], b[2::2])
    ea = torch.cat([a[:1], ea], 0)
    eb = torch.cat([b[:1], eb], 0)
    return _interleave(ea, oa), _interleave(eb, ob)


def affine_scan(a, b, x0, reverse=False):
    """Solve x_{k+1} = a_k * x_k + b_k for k = 0..n-1 along axis 0, in log
    depth.

    :param a, b: tensors [n, ...] of recurrence coefficients.
    :param x0: tensor [...] initial value.
    :param reverse: if True, solves x_k = a_k * x_{k+1} + b_k with x_n = x0
        (the recurrence runs from the last element towards the first).
    :return: tensor [n+1, ...]; element 0 (or n if reverse) equals x0.
    """
    if reverse:
        a = torch.flip(a, (0,))
        b = torch.flip(b, (0,))
    A, B = _associative_scan(a, b)
    out = torch.cat([x0[None], A * x0 + B], 0)
    if reverse:
        out = torch.flip(out, (0,))
    return out


def _lw_scan_eval(T, dtau, up_toa, reverse=True):
    """Scan evaluation of both streams over [nz-1, ...] cells; the boundary
    ``up_toa`` broadcasts against T's trailing axes."""
    e_plus = torch.exp(dtau)
    e_minus = torch.exp(-dtau)
    source = _source(T)
    # channel axis 1: 0 = up-stream, 1 = down-stream
    a = torch.stack([e_plus, e_minus], 1)
    b = torch.stack([source * (1.0 - e_plus), source * (1.0 - e_minus)], 1)
    up0 = torch.broadcast_to(torch.as_tensor(up_toa, dtype=T.dtype,
                                             device=T.device), T.shape[1:])
    x_toa = torch.stack([up0, torch.zeros_like(up0)])
    flux = affine_scan(a, b, x_toa, reverse=reverse)
    return flux[:, 0], flux[:, 1]


def _column_dtau(dtau, T):
    """|d tau| broadcast to T's shape (a [nz-1] dtau is column-shared)."""
    while dtau.ndim < T.ndim:
        dtau = dtau[..., None]
    return torch.broadcast_to(dtau, T.shape)


def lw_flux_plain(T, dtau, up_flux_toa, surface_first=True):
    """Differentiable evaluation of :func:`lw_flux` by :func:`affine_scan`:
    out-of-place tensor ops on any device, so ``torch.func.jacfwd`` and
    ``torch.func.jvp`` pass through it (a kernel behind ctypes has no
    forward-mode rule).  Same semantics and shapes as :func:`lw_flux`;
    ``diagnostics/sensitivity.py`` uses it."""
    batch_shape = T.shape[1:]
    nlev = T.shape[0]
    Tf = T.reshape(nlev, -1)
    dtauf = _column_dtau(dtau, T).reshape(nlev, -1)
    toaf = torch.broadcast_to(torch.as_tensor(up_flux_toa, dtype=T.dtype,
                                              device=T.device), batch_shape)
    up, down = _lw_scan_eval(Tf, dtauf, toaf.reshape(-1),
                             reverse=surface_first)
    return (up.reshape((nlev + 1,) + batch_shape),
            down.reshape((nlev + 1,) + batch_shape))


def lw_flux(T, dtau, up_flux_toa, surface_first=True):
    """Grey long-wave up/down fluxes at interfaces from cell temperatures.

    :param T: [nz-1, ...] cell temperatures.
    :param dtau: [nz-1] (column-shared) or [nz-1, ...] |optical depth
        difference| across each cell.
    :param up_flux_toa: [...] top-of-atmosphere upward flux boundary
        condition ((1-albedo_mod) * solar_latitude_factor * F_stellar / 4).
    :param surface_first: orientation of axis 0: True (index 0 = surface,
        the grey model's) walks the ``lw_walk`` kernel on the card and its
        plain twin on the CPU; False (index 0 = TOA) takes the scan form,
        as the JAX package does.
    :return: (up_lw_flux, down_lw_flux) at interfaces, shape [nz, ...].
    """
    if not surface_first:
        return _lw_scan_eval(T, _column_dtau(dtau, T), up_flux_toa,
                             reverse=False)
    batch_shape = T.shape[1:]
    nlev = T.shape[0]
    Tf = T.reshape(nlev, -1).contiguous()
    dtauf = _column_dtau(dtau, T).reshape(nlev, -1).contiguous()
    toaf = torch.broadcast_to(torch.as_tensor(up_flux_toa, dtype=T.dtype,
                                              device=T.device),
                              batch_shape).reshape(-1).contiguous()
    if T.device.type == 'cpu':
        up, down = lw_flux_sequential(Tf, dtauf, toaf)
    else:
        from .cuda_two_stream import lw_walk
        up, down = lw_walk(Tf, dtauf, toaf)
    return (up.reshape((nlev + 1,) + batch_shape),
            down.reshape((nlev + 1,) + batch_shape))


def percentile_topk_params(n: int, pct) -> tuple[int, float]:
    """(m, frac) of the exact-percentile order statistics: the default linear
    interpolation of a percentile reads the m-th and (m-1)-th largest of n
    values and lerps them by frac (see column._percentile_topk)."""
    q = (n - 1) * float(pct) / 100.0
    k0 = int(np.floor(q))
    return n - k0, q - k0


def topk_depth(n_stat: int, pct) -> int:
    """L = max(m, 2): how many order statistics the fused net-stats
    operator keeps for ``n_stat`` values at percentile ``pct``."""
    m, _frac = percentile_topk_params(n_stat, pct)
    return max(m, 2)


def _stats(net, prev_net, L):
    """Per-member exit statistics of a [B, ...] net flux: (top1, top_{L-1},
    top_L) of |net - prev| and max|net|.  top1 is the NaN-propagating
    maximum, so a NaN anywhere in a member's |net - prev| shows there
    whatever order ``torch.topk`` gives NaN on the device."""
    B = net.shape[0]
    x = torch.abs(net - prev_net).reshape(B, -1)
    top = torch.topk(x, L, dim=1).values
    absmax = torch.amax(torch.abs(net).reshape(B, -1), dim=1)
    return torch.amax(x, dim=1), top[:, L - 2], top[:, L - 1], absmax


def net_stats_sequential(T, dtau, up_sw, down_sw, up_toa, prev_net, L):
    """Plain PyTorch twin of the ``net_stats_walk`` kernel (K3), with the
    batch on the last axis like the Pallas kernel (the CUDA kernel takes
    rows: :func:`net_stats_rows_plain`).

    :param T, dtau: [n, b] cells (index 0 = surface).
    :param up_sw, down_sw, prev_net: [n+1, b] interfaces.
    :param up_toa: [b] TOA upward lw boundary condition.
    :param L: top-k depth (>= 2).
    :return: (net [n+1, b], top1, top_hi, top_lo, absmax) — net =
        ((up - down) + up_sw) - down_sw; top_* the 1st, (L-1)-th and L-th
        largest of |net - prev| per member (all three NaN where it holds a
        NaN); absmax = max|net|.
    """
    up, down = lw_flux_sequential(T, dtau, up_toa)
    net = up - down + up_sw - down_sw
    top1, hi, lo, absmax = _stats(net.T, prev_net.T, L)
    # the kernel's selection (the Pallas kernel's sorted insertion): a NaN
    # in a member's |net - prev| makes every order statistic NaN
    nan = torch.isnan(top1)
    return (net, top1, torch.where(nan, top1, hi), torch.where(nan, top1, lo),
            absmax)


def net_stats_rows_plain(T, dtau, up_sw, down_sw, up_toa, prev_net, L):
    """Plain PyTorch version of the ``net_stats_walk`` kernel (K3) in the
    kernel's layout, one member per ROW: :func:`net_stats_sequential` on
    transposed views.

    :param T, dtau: [b, n]; up_sw, down_sw, prev_net: [b, n+1]; up_toa: [b].
    :return: (net [b, n+1], top1, top_hi, top_lo, absmax)."""
    net, top1, hi, lo, absmax = net_stats_sequential(
        T.T, dtau.T, up_sw.T, down_sw.T, up_toa, prev_net.T, L)
    return net.T, top1, hi, lo, absmax


def grey_net_with_stats(T, dtau, up_toa, up_sw, down_sw, prev_net, pct=95):
    """Fused grey net flux + the march's exit statistics, for a batch of
    members.

    Routed as the JAX package routes it (two_stream.py:247-273): single
    columns (ny == 1) go to the fused walk (K3 on CUDA, its plain twin on the
    CPU); latitude grids take :func:`lw_flux` plus plain top-k.

    :param T, dtau: [B, nz-1, ny]; up_sw, down_sw, prev_net: [B, nz, ny];
        up_toa: [B, ny].  The sw fluxes and up_toa do not depend on T —
        callers hoist them out of the march loop.
    :param pct: exit percentile (reference net_flux_percentile).
    :return: (net [B, nz, ny], top1, top_hi, top_lo, absmax), each stat [B].
    """
    B, nlev, ny = T.shape
    L = topk_depth((nlev + 1) * ny, pct)
    if ny == 1:
        def rows(x):        # [B, r, 1] -> [B, r]: a view of the march's carry
            return x[:, :, 0].contiguous()
        args = (rows(T), rows(dtau), rows(up_sw), rows(down_sw),
                up_toa[:, 0].contiguous(), rows(prev_net), L)
        if T.device.type == 'cpu':
            net, top1, hi, lo, absmax = net_stats_rows_plain(*args)
        else:
            from .cuda_two_stream import net_stats_walk
            net, top1, hi, lo, absmax = net_stats_walk(*args)
        return net[:, :, None], top1, hi, lo, absmax
    up, down = lw_flux(T.movedim(0, 1), dtau.movedim(0, 1), up_toa)
    net = up.movedim(1, 0) - down.movedim(1, 0) + up_sw - down_sw
    return (net,) + _stats(net, prev_net, L)


def sw_flux(tau_sw_interface, albedo_mod, solar_latitude_factor, F_stellar,
            isothermal=False):
    """Beer-law short-wave fluxes at interfaces (grey.py:277-294).

    ``albedo_mod``, ``solar_latitude_factor`` and ``F_stellar`` broadcast
    against each other ([ny] per column, [B, ny] per batch); the level axis
    of ``tau_sw_interface`` ([..., nz, ny]) is inserted before their last.
    ``tau_sw_interface`` may be None for a transparent short-wave
    atmosphere; ``isothermal=True`` returns the no-atmosphere fluxes used for
    the initial condition (grey.py:104).
    """
    base_up = albedo_mod * solar_latitude_factor * F_stellar / 4.0
    base_down = solar_latitude_factor * F_stellar / 4.0
    if tau_sw_interface is None:
        return base_up, base_down
    base_up = base_up.unsqueeze(-2)
    base_down = base_down.unsqueeze(-2)
    if isothermal:
        shape = torch.broadcast_shapes(base_up.shape, tau_sw_interface.shape)
        return base_up.expand(shape), base_down.expand(shape)
    up = base_up * torch.exp(tau_sw_interface)
    down = base_down * torch.exp(-tau_sw_interface)
    return up, down
