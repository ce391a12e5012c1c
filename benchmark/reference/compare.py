"""The comparison that decides ``correct``: the program's answers against
the plain reference, in float64 on the host.

Each member of a march is an answer: its cell temperatures T, the net flux
its last step started from, and its exit flags.  The numbers compared:

- ``unsettled``: members not at equilibrium after the march and its f64
  finish, or failed (T < 0), or non-finite.  Limit 0: every member of a
  user's sweep has to reach equilibrium.
- ``flux_p95_gap_wm2``: per member, the 95th percentile over interfaces of
  |reference net flux of the answer's T - the net flux the program holds|;
  the largest over the members.  The program stops a member once the
  95th percentile of a step's flux change falls below its threshold, so a
  sound answer reads about one such step plus rounding; a wrong flux, a
  member that never moved, or fluxes in a lower precision read more.
- ``eq_gap_wm2`` (worlds transparent to short waves): the largest
  |reference net flux of T - that of the exact radiative equilibrium| over
  interfaces and members: how far the answer lies from equilibrium, in
  W/m^2 of energy imbalance.
- ``instability_k`` (convective marches): the largest fall of potential
  temperature with height in any member: the adjustment's guarantee.
- ``t_p95_gap_k`` (convective marches): per member, the 95th percentile
  over cells of |T - T of the reference's own float64 march of that
  member|; the largest over a seeded sample of ``MARCH_SAMPLE`` members and
  the longest-marching one.  The reference marches each sampled member
  from the start (members are independent), so a member stopped early, or
  an adjustment that does not conserve enthalpy, lands away from where the
  reference's equilibrium lies.
"""
from __future__ import annotations

import numpy as np
import torch

from .convection import instability
from .march import march, percentile
from .radiation import net_flux, radiative_equilibrium

BLOCK = 8192
#: members the reference marches again for ``t_p95_gap_k``
MARCH_SAMPLE = 2048


def numbers(out, world, cfg, *, seed=0, device='cpu'):
    """The compared numbers of host outputs ``out`` (numpy: T [M, n], net
    [M, n + 1], F [M], equilibrium, failed, nan, steps [M]) of a march of
    configuration ``cfg`` in ``world``; ``seed`` draws the members the
    reference marches again, on ``device``."""
    convective = bool(cfg['march'].get('convective_adjust'))
    f64 = torch.float64
    flags = ~np.asarray(out['equilibrium'], bool) | np.asarray(
        out['failed'], bool) | np.asarray(out['nan'], bool)
    res = {'unsettled': int(flags.sum()), 'flux_p95_gap_wm2': 0.0}
    closed = world.tau_sw_interface is None
    if closed:
        res['eq_gap_wm2'] = 0.0
    if convective:
        res['instability_k'] = 0.0
    p_c = torch.as_tensor(world.p_centre, dtype=f64)
    for lo in range(0, len(out['F']), BLOCK):
        sl = slice(lo, lo + BLOCK)
        T = torch.as_tensor(out['T'][sl], dtype=f64)
        F = torch.as_tensor(out['F'][sl], dtype=f64)
        net = net_flux(T, F, world)
        held = torch.as_tensor(out['net'][sl], dtype=f64)
        gap = percentile((net - held).abs(), 95)
        res['flux_p95_gap_wm2'] = max(res['flux_p95_gap_wm2'],
                                      _worst(gap))
        if closed:
            eq = net_flux(radiative_equilibrium(F, world), F, world)
            res['eq_gap_wm2'] = max(res['eq_gap_wm2'],
                                    _worst((net - eq).abs().amax(1)))
        if convective:
            res['instability_k'] = max(res['instability_k'],
                                       _worst(instability(T, p_c)))
    if convective:
        res['t_p95_gap_k'] = march_gap(out, world, cfg, seed, device)
    return res


def march_gap(out, world, cfg, seed, device):
    """``t_p95_gap_k`` of host outputs ``out`` (see the module's doc)."""
    m = cfg['march']
    M = len(out['F'])
    rows = np.unique(np.append(
        np.random.default_rng([seed, 2]).choice(
            M, min(MARCH_SAMPLE, M), replace=False),
        int(np.asarray(out['steps']).argmax())))
    ref = march(out['F'][rows], world, dtype=torch.float64, device=device,
                flux_thresh=float(m['flux_thresh']),
                max_steps=int(m['max_steps']), t_end=float(m['t_end']),
                albedo=float(cfg['world'].get('albedo', 0.3)),
                convective_adjust=True)
    T = torch.as_tensor(out['T'][rows], dtype=torch.float64, device=device)
    return _worst(percentile((T - ref['T']).abs(), 95))


def _worst(x):
    """The largest entry; NaN if any entry is NaN."""
    return float('nan') if bool(torch.isnan(x).any()) else float(x.max())


def judge(nums, limits):
    """(correct, lines): each number beside its limit; a NaN fails."""
    ok, lines = True, []
    for name, value in nums.items():
        limit = limits[name]
        good = value <= limit
        ok &= bool(good)
        lines.append(f'{name} {value!r} limit {limit!r} '
                     f'{"ok" if good else "FAIL"}')
    return ok, lines
