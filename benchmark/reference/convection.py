"""Dry convective adjustment in plain PyTorch, members as rows.

The stable profile (potential temperature non-decreasing with height) that
conserves the column's enthalpy -integral(T dp) and mixes as much as it
must: the weighted isotonic fit of theta = T / pi with weights w pi, by the
min-max formula over prefix sums.  A connected run of changed levels whose
largest change reaches median(T) / 4 is left as it was
(convective_adjustment.py:36-118 of the NumPy original).
"""
from __future__ import annotations

import torch

from .world import C_P_DRY, P_SURFACE_EARTH, R_SPECIFIC

#: members a block of the O(n^2) fit, to bound its memory
BLOCK = 2048


def exner(p):
    """(p / p_ref)^(R / c_p) of cell pressures p [n]."""
    return (p / P_SURFACE_EARTH) ** (R_SPECIFIC / C_P_DRY)


def trapz_weights(p):
    """w with sum(w T) = -trapz(T, p) for descending p [n]."""
    dp = p[:-1] - p[1:]
    w = torch.zeros_like(p)
    w[:-1] += 0.5 * dp
    w[1:] += 0.5 * dp
    return w


def isotonic(theta, v):
    """Non-decreasing weighted least-squares fit of rows theta [B, n] with
    weights v [n]: fit_t = max_{s<=t} min_{u>=t} mean(theta[s..u])."""
    B, n = theta.shape
    zero = torch.zeros((B, 1), dtype=theta.dtype, device=theta.device)
    SV = torch.cat([zero, torch.cumsum(v * theta, 1)], 1)
    SW = torch.cat([zero[0], torch.cumsum(v, 0)])
    upper = torch.ones((n, n), dtype=torch.bool, device=theta.device).triu()
    mean = (SV[:, None, 1:] - SV[:, :n, None]) / (SW[None, 1:] - SW[:n, None])
    mean = torch.where(upper, mean, float('inf'))           # [B, s, u]
    M = torch.flip(torch.cummin(torch.flip(mean, [2]), 2).values, [2])
    M = torch.where(upper, M, float('-inf'))
    return torch.diagonal(torch.cummax(M, 1).values, dim1=1, dim2=2)


def _run_max(dT, changed):
    """max|dT| over each connected run of ``changed``, on the run."""
    starts = changed & ~torch.cat([torch.zeros_like(changed[:, :1]),
                                   changed[:, :-1]], 1)
    seg = torch.where(changed, torch.cumsum(starts.long(), 1), 0)
    peak = torch.zeros((dT.shape[0], dT.shape[1] + 1), dtype=dT.dtype,
                       device=dT.device)
    peak = peak.scatter_reduce(1, seg, torch.where(changed, dT.abs(), 0.0),
                               reduce='amax')
    return torch.gather(peak, 1, seg)


def factors(p_centre, dtype, device):
    """(pi, w) of cell pressures [n] (NumPy), formed in float64 and then
    held in ``dtype``."""
    p = torch.as_tensor(p_centre, dtype=torch.float64)
    return tuple(x.to(dtype=dtype, device=device)
                 for x in (exner(p), trapz_weights(p)))


def adjust(T, pi, w):
    """Adjust rows T [B, n] (surface first) with the grid factors pi, w
    [n] (:func:`factors`)."""
    out = []
    for Tb in torch.split(T, BLOCK):
        fit = isotonic(Tb / pi, w * pi) * pi
        dT = fit - Tb
        changed = dT.abs() > 1e-12
        s = torch.sort(Tb, 1).values
        n = Tb.shape[1]
        thresh = (s[:, (n - 1) // 2] + s[:, n // 2]) * 0.5 / 4.0
        keep = changed & (_run_max(dT, changed) < thresh[:, None])
        out.append(torch.where(keep, fit, Tb))
    return torch.cat(out)


def instability(T, p_centre):
    """[B] the largest fall of potential temperature with height (K of
    theta; 0 for a stable column)."""
    theta = T / exner(p_centre)
    return (theta[:, :-1] - theta[:, 1:]).clamp(min=0).amax(1)
