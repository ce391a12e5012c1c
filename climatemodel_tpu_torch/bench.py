"""The port's bench: ``python -m climatemodel_tpu_torch.bench``.

Counterpart of the repository's root ``bench.py`` (the JAX package's bench):
the same rows, each built by the function of ``bench.py``'s name (the two
weak-scaling ones without its ``_cpu``) at ``bench.py``'s configuration,
with the port's classes on an explicit ``torch.device``, all in float32.

    python -m climatemodel_tpu_torch.bench                      # the card
    python -m climatemodel_tpu_torch.bench --only=grey_rce --only=shallow
    python -m climatemodel_tpu_torch.bench --device cpu --smoke

Timing: one warm run at the same shapes, then the best of 3 (of 5 for the
single column), each from a fresh world or carry and ending in a device
synchronise; host set-up (grids, tables, the transmission fold) stays
outside the timed window.  Every row reports its outcome flags beside its
numbers (``converged_fraction``, ``equilibrium``, ``timed_out``, ``failed``,
``nan``; ``ok`` for shallow water) and the kernel launches it made.

The last line of standard output is one JSON object ``{"metric", "value",
"unit", "vs_baseline", "extra"}`` of under 2000 characters: the headline
grey ensemble's model-days/s, ``vs_baseline`` null (the only target on
record was set for another chip), and a compact ``extra`` with one headline
number per row.  The full record goes to ``--out``.  Exit code 0 when every
row ran and met its required flags (:data:`REQUIRED`), 1 otherwise, 2
without a CUDA device unless ``--device cpu`` is given: the bench never
falls back to the CPU by itself.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

#: where the full record goes unless ``--out`` says otherwise (git-ignored)
OUT_PATH = (Path(__file__).resolve().parents[1] / 'build' / 'bench'
            / 'bench_torch_full.json')

#: the H100's published HBM rate (SXM part, 700 W), for the rooflines
HBM_BYTES_PER_S = 3.35e12

#: the stdout line must stay under this many characters
LINE_LIMIT = 2000

METRIC = dict(metric='grey_rce_model_days_per_sec', unit='model-days/s')


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _best_of(device, fresh, march, trials=3):
    """One warm run, then the best of ``trials`` timed runs.  Each run
    marches what ``fresh()`` makes, outside the timed window.  Returns
    (best wall in s, what that run returned, what it marched)."""
    march(fresh())
    best = (float('inf'), None, None)
    for _ in range(trials):
        x = fresh()
        _sync(device)
        t0 = time.perf_counter()
        out = march(x)
        _sync(device)
        wall = time.perf_counter() - t0
        if wall < best[0]:
            best = (wall, out, x)
    return best


def _flags(info):
    """The outcome flags of a march's ``column.EquilibriumInfo`` (of
    tensors, or of a world's NumPy scalars): the converged share of its
    members, and whether all converged, any timed out, failed (T < 0) or
    went non-finite."""
    eq, out, failed, nan = (
        np.asarray(x.cpu() if torch.is_tensor(x) else x, bool)
        for x in (info.equilibrium, info.timed_out, info.failed, info.nan))
    return dict(converged_fraction=float(eq.mean()),
                equilibrium=bool(eq.all()), timed_out=bool(out.any()),
                failed=bool(failed.any()), nan=bool(nan.any()))


def _days(t):
    """Simulated days summed over the members of a state's ``t``."""
    return float(t.double().sum()) / 86400.0


# --------------------------------------------------------------------------
# the rows (bench.py's functions of the same names)
# --------------------------------------------------------------------------

def bench_grey(n_ensemble=4096, nz=60, max_steps=3000, *, device):
    """The headline grey-RCE ensemble (``bench.py:85``): ``n_ensemble``
    scale-height columns over F = 800-1600 W/m^2 marched to radiative
    equilibrium (K3 on the card).  The timed march is the f32 one; the
    members its noise floor blocks are then finished in f64, timed apart
    (``f64_finish_wall_s``)."""
    from .constants import p_surface_earth
    from .models import ensemble
    from .models.grey import GreyGas

    world = GreyGas(nz=nz, ny=1, tau_lw_func='scale_height',
                    tau_lw_func_args=[0.22 * p_surface_earth, 4.0],
                    device=device)
    F_values = np.linspace(800.0, 1600.0, n_ensemble)
    states, forcings, p_int, p_c = ensemble.grey_ensemble(world, F_values)
    ft = 1e-3
    wall, (fs, info), _ = _best_of(
        device, lambda: None,
        lambda _: ensemble.grey_evolve_ensemble(states, forcings, p_int, p_c,
                                                ft, max_steps=max_steps))
    res = {'model_days_per_sec': _days(fs.t) / wall, 'wall_s': wall,
           'ensemble': n_ensemble, 'nz': nz,
           'total_steps': int(info.steps.sum()),
           'lockstep_iterations': int(info.steps.max()),
           'converged_fraction_f32': _flags(info)['converged_fraction']}
    t0 = time.perf_counter()
    fs_r, info_r, finished = ensemble.grey_finish_unconverged_f64(
        fs, info, forcings, p_int, p_c, ft, max_steps=max_steps)
    _sync(device)
    res.update(f64_finish_wall_s=time.perf_counter() - t0,
               f64_finished_members=int(len(finished)), **_flags(info_r))
    return res


def _sw_world(nx, ny, solver, el_nino, device):
    """``bench.py:148-172``: the El Nino forced-wind world (walls, y
    sponge) or the wind-free height_gaussian world."""
    from .constants import Omega, R_earth
    from .models.shallow_water import ShallowWater
    if el_nino:
        h_mean, g_use = 100.0, 0.05
        c = np.sqrt(g_use * h_mean)
        beta = 2 * Omega / R_earth
        L_def = np.sqrt(c / beta)
        dx = L_def / 5
        dt = 0.01 * dx / c
        r = 1 / (10 * 30 * 24 * 3600)
        return ShallowWater(
            nx=nx, ny=ny, dx=dx, dy=dx, dt=dt, f_0=0.0, beta=beta, r=r,
            g=g_use, numerical_solver=solver,
            boundary_type={'x': 'walls', 'y': 'walls',
                           'y_walls_damp': {'dist_thresh': (ny / 2) * dx
                                            - 6 * dx, 'r': r * 100}},
            initial_info={'type': 'el_nino', 'max_h_surface': 110.0,
                          'min_h_surface': 90.0, 'y_std': L_def,
                          'add_noise': False, 'wind': {'type': 'forced'}},
            device=device)
    return ShallowWater(
        nx=nx, ny=ny, dx=100e3, dy=100e3, dt=60.0, f_0=1e-4, beta=1.6e-11,
        numerical_solver=solver,
        initial_info={'type': 'height_gaussian', 'min_h_surface': 9750.0,
                      'max_h_surface': 10750.0, 'x0': 0.0, 'y0': 0.0,
                      'x_std': 4000e3, 'y_std': 4000e3, 'add_noise': False},
        device=device)


def bench_sw(nx=2050, ny=1026, nt=400, solver='richtmyer_pallas',
             el_nino=True, *, device):
    """The El Nino wind-forced run at a large grid (``bench.py:141``),
    stepped by the fused Richtmyer kernel (K6 on the card), and the
    wind-free world beside it.  Every timed run starts from the initial
    state: the El Nino world turns unstable near its x-wall/sponge corners
    after ~500 steps, so chained runs would time frozen steps.  A run whose
    ``ok`` went False raises: it is no rate."""
    from .models.shallow_water import sw_simulate
    world = _sw_world(nx, ny, solver, el_nino, device)
    kw = world._step_kwargs()
    params = world.params
    runs = []

    def march(state):
        out = sw_simulate(state, params, nt, **kw)
        runs.append(out.ok)
        return out
    wall, _, _ = _best_of(device, lambda: world.state, march)
    ok = all(bool(x) for x in runs)
    if not ok:
        raise RuntimeError(f'shallow water (el_nino={el_nino}): a {nt}-step '
                           f'run aborted (ok False)')
    cells = (nx - 2) * (ny - 2)
    out = {'cell_updates_per_sec': cells * nt / wall, 'wall_s': wall,
           'grid': [nx, ny], 'steps': nt, 'solver': solver,
           'el_nino_forced': el_nino, 'ms_per_step': 1e3 * wall / nt,
           'ok': ok}
    if el_nino:
        sub = bench_sw(nx=nx, ny=ny, nt=nt, solver=solver, el_nino=False,
                       device=device)
        out.update(no_wind_cell_updates_per_sec=sub['cell_updates_per_sec'],
                   no_wind_ms_per_step=sub['ms_per_step'],
                   no_wind_ok=sub['ok'])
    return out


def _real_gas_march(gas, cache, flux_thresh, device, **kw):
    """Best-of-3 march of ``gas`` from its initial state over a folded
    ``cache``: its wall, steps, simulated days and flags."""
    from .models.real_gas import _real_gas_evolve
    args = gas._march_args()
    wall, (st, info), _ = _best_of(
        device, lambda: gas.state,
        lambda s: _real_gas_evolve(s, *args, flux_thresh, cache=cache, **kw))
    steps = int(info.steps[0])
    return dict(steps_per_sec=steps / wall,
                model_days_per_sec=_days(st.t) / wall, steps=steps,
                wall_s=wall, ms_per_step=1e3 * wall / steps, **_flags(info))


def _fold(gas, cache_dtype=None):
    """The transmission cache of ``gas`` (set-up, timed apart)."""
    from .models.real_gas import precompute_transmission
    t0 = time.perf_counter()
    cache = precompute_transmission(gas.tau_device, gas.band_arrays,
                                    cache_dtype)
    _sync(gas.device)
    return cache, time.perf_counter() - t0


def bench_real_gas(*, device):
    """The single-line real-gas column (``bench.py:200``), flux_thresh
    1e-4: it reaches its t_end (4 years) before its exit, and says so in
    ``timed_out``."""
    from .models.real_gas import RealGas
    from .spectral import humidity
    gas = RealGas(nz='auto', ny=1, molecule_names=['single_line'], T_g=265.0,
                  q_funcs={'single_line': humidity.co2},
                  q_funcs_args={'single_line': ()}, delta_temp_change=0.1,
                  device=device)
    cache, fold_s = _fold(gas)
    return dict(nz=gas.nz, fold_s=fold_s,
                **_real_gas_march(gas, cache, 1e-4, device))


def _earth_gas(nz, n_nu_bands, temp_change, device):
    from .models.real_gas import RealGas
    from .spectral import earth_tables
    earth_tables.ensure_earth_tables(device=device)
    return RealGas(nz=nz, ny=1, molecule_names=['CO2', 'CH4', 'H2O', 'O3'],
                   T_g=265.19, p_toa=0.1, n_nu_bands=n_nu_bands,
                   temp_change=temp_change, delta_temp_change=0.1,
                   device=device)


def _n_lw(gas):
    return int(gas.band_arrays.idx.shape[0])


def bench_real_gas_earth(n_nu_bands=200, *, device):
    """The 4-gas earth column (``bench.py:229``), nz='auto', 200 bands,
    t_end 20: per step and with the exit statistics every 4th step."""
    gas = _earth_gas('auto', n_nu_bands, 1, device)
    cache, fold_s = _fold(gas)
    res = dict(nz=gas.nz, n_nu_bands=n_nu_bands, n_lw_bands=_n_lw(gas),
               fold_s=fold_s,
               **_real_gas_march(gas, cache, 1e-3, device, t_end=20.0))
    res['check_every_4'] = _real_gas_march(gas, cache, 1e-3, device,
                                           t_end=20.0, check_every=4)
    return res


def bench_real_gas_earth_ensemble(n_ensemble=64, n_nu_bands=200, *, device):
    """The earth column's insolation ensemble (``bench.py:285``): 64
    members over scales 0.85-1.15 sharing one composition, so a step is one
    batched band product with the members as its N."""
    from .models import ensemble
    gas = _earth_gas('auto', n_nu_bands, 0.5, device)
    scales = np.linspace(0.85, 1.15, n_ensemble)
    states, sc, T_gs, args = ensemble.real_gas_ensemble(gas, F_scales=scales)
    cache, fold_s = _fold(gas)
    wall, (fs, info), _ = _best_of(
        device, lambda: None,
        lambda _: ensemble.real_gas_evolve_ensemble(
            states, sc, T_gs, *args, 1e-3, t_end=20.0, max_steps=5000,
            cache=cache))
    steps = int(info.steps.sum())
    return dict(model_days_per_sec=_days(fs.t) / wall, ensemble=n_ensemble,
                nz=gas.nz, n_nu_bands=n_nu_bands, wall_s=wall,
                fold_s=fold_s, total_steps=steps,
                lockstep_iterations=int(info.steps.max()),
                member_steps_per_sec=steps / wall, **_flags(info))


def bench_real_gas_hires(nz=400, n_nu_bands=200, max_steps=500, *, device):
    """The nz=400 earth column (``bench.py:330``): 500 steps (t_end 2)
    with the f32 march operator and with the bf16 cache, ms_per_step
    being the comparable number (a characterisation, not a speed-up)."""
    gas = _earth_gas(nz, n_nu_bands, 1, device)
    res = {'nz': nz, 'n_nu_bands': n_nu_bands, 'n_lw_bands': _n_lw(gas)}
    for key, cd in (('f32', None), ('bf16_cache', torch.bfloat16)):
        cache, fold_s = _fold(gas, cd)
        res[key] = dict(fold_s=fold_s, **_real_gas_march(
            gas, cache, 1e-3, device, t_end=2.0, max_steps=max_steps))
    res['bf16_speedup'] = (res['bf16_cache']['steps_per_sec']
                           / res['f32']['steps_per_sec'])
    return res


def _thermosphere_world(nz=150, *, device):
    """The thermosphere world of radiation_script.py:32-36 at a fixed nz
    (``bench.py:377``), through the CLI's registry."""
    from .cli import grey_world_kwargs
    from .models.grey import GreyGas
    return GreyGas(nz=nz, ny=1, device=device,
                   **grey_world_kwargs('thermosphere'))


def _world_march(world, **kw):
    world.evolve_to_equilibrium(**kw)
    return world


def _world_row(world, wall):
    info = world._equilibrium_info
    steps = int(info.steps)
    days = _days(world.state.t)
    return dict(model_days_per_sec=days / wall, model_days=days, steps=steps,
                wall_s=wall, steps_per_sec=steps / wall,
                ms_per_step=1e3 * wall / steps, **_flags(info))


def bench_grey_single_column(nz=150, *, device):
    """The single thermosphere column marched to radiative equilibrium
    (``bench.py:388``; K1 on the card), per step, with the exit statistics
    every 8th step, and every 8th step with dip memory (bit-equal to per
    step); best of 5."""
    out = {}
    for key, K, dip in (('per_step', 1, False), ('check_every_8', 8, False),
                        ('check_every_8_dip', 8, True)):
        kw = dict(flux_thresh=1e-3, save=False, check_every=K,
                  dip_memory=dip)
        wall, world, _ = _best_of(
            device, functools.partial(_thermosphere_world, nz, device=device),
            functools.partial(_world_march, **kw), trials=5)
        out[key] = _world_row(world, wall)
    out['nz'] = nz
    return out


def bench_rce_conv(*, device):
    """The thermosphere world (nz 150) marched to radiative-convective
    equilibrium (``bench.py:426``), t_end 30, with each variant: the
    reference group blend, the isotonic fit (K4 on the card), the baked
    forcing and the dip-memory chunks (check_every 8)."""
    out = {}
    for key, method, chunk_kw in (
            ('reference', 'reference', {}),
            ('isotonic_variant', 'isotonic', {}),
            ('baked_variant', 'reference', dict(bake_forcing=True)),
            ('dip_memory_variant', 'reference',
             dict(check_every=8, dip_memory=True))):
        kw = dict(flux_thresh=1e-3, save=False, convective_adjust=True,
                  conv_method=method, t_end=30.0, **chunk_kw)
        wall, world, _ = _best_of(
            device, functools.partial(_thermosphere_world, device=device),
            functools.partial(_world_march, **kw))
        res = _world_row(world, wall)
        T = world.state.T
        if key == 'reference':
            out.update(res, nz=world.nz, conv_method='reference')
            T_ref = T
            continue
        if key == 'dip_memory_variant':
            res['endpoint_bit_equal'] = bool(torch.equal(T, T_ref))
        elif key == 'baked_variant':
            # the port's march always takes the forcing as tensors
            # (models/grey.py): bake_forcing is accepted and changes nothing
            res['endpoint_max_dT_vs_reference_K'] = float(
                (T.double() - T_ref.double()).abs().max())
            res['note'] = ('bake_forcing is a no-op in the port: the same '
                           'march as reference')
        out[key] = res
    return out


def bench_rce_conv_ensemble(n_ensemble=512, *, device):
    """512 thermosphere columns over F = 1200-1500 W/m^2 marched to
    radiative-convective equilibrium (``bench.py:510``), flux_thresh 0.1:
    the reference method, the isotonic fit (K4) and the dip-memory chunks
    (check_every 4); K3 on the card throughout."""
    from .models import ensemble
    world = _thermosphere_world(device=device)
    F = np.linspace(1200.0, 1500.0, n_ensemble)
    states, forcings, p_int, p_c = ensemble.grey_ensemble(world, F)
    out = {}
    for key, method, chunk_kw in (
            ('reference', 'reference', {}),
            ('isotonic_variant', 'isotonic', {}),
            ('dip_memory_variant', 'reference',
             dict(check_every=4, dip_memory=True))):
        wall, (fs, info), _ = _best_of(
            device, lambda: None,
            lambda _: ensemble.grey_evolve_ensemble(
                states, forcings, p_int, p_c, 1e-1, convective_adjust=True,
                max_steps=3000, conv_method=method, **chunk_kw))
        r = dict(model_days_per_sec=_days(fs.t) / wall, wall_s=wall,
                 total_steps=int(info.steps.sum()),
                 lockstep_iterations=int(info.steps.max()), **_flags(info))
        if key == 'reference':
            out.update(r, ensemble=n_ensemble, nz=world.nz,
                       conv_method='reference')
            steps_ref = info.steps
            continue
        if key == 'dip_memory_variant':
            r['steps_bit_equal'] = bool(torch.equal(info.steps, steps_ref))
        out[key] = r
    return out


def _icy_ebm(ny, nz, device):
    """``bench.py:565``: the scale-height world at the EBM's size with icy
    poles (albedo 0.6 poleward of 60 degrees, 0.3 elsewhere)."""
    from .constants import p_surface_earth
    from .models.grey import GreyGas
    return GreyGas(nz=nz, ny=ny, tau_lw_func='scale_height',
                   tau_lw_func_args=[0.22 * p_surface_earth, 4.0],
                   albedo=lambda lat: np.where(np.abs(lat) > 60, 0.6, 0.3),
                   device=device)


def bench_ebm(ny=64, nz=40, *, device):
    """The icy latitude world (``bench.py:573``): one dt shared by its
    latitudes (K1 at [nz-1, ny] on the card), then its latitudes as
    independent single-column members (K3), each with its own dt, and the
    f64 finish of any the f32 noise floor blocks."""
    from .models import ensemble
    wall, world, _ = _best_of(
        device, lambda: _icy_ebm(ny, nz, device),
        functools.partial(_world_march, flux_thresh=1e-3, save=False))
    shared = dict(_world_row(world, wall), ny=ny, nz=nz)

    states, forcings, p_int, p_c = ensemble.grey_latitude_ensemble(
        _icy_ebm(ny, nz, device))
    ft = 1e-3
    wall_e, (fs, info), _ = _best_of(
        device, lambda: None,
        lambda _: ensemble.grey_evolve_ensemble(states, forcings, p_int, p_c,
                                                ft))
    t0 = time.perf_counter()
    fs_r, info_r, finished = ensemble.grey_finish_unconverged_f64(
        fs, info, forcings, p_int, p_c, ft)
    _sync(device)
    shared['independent_dt_ensemble'] = dict(
        model_days_per_sec=_days(fs.t) / wall_e, wall_s=wall_e,
        total_steps=int(info.steps.sum()),
        lockstep_iterations=int(info.steps.max()),
        converged_fraction_f32=_flags(info)['converged_fraction'],
        f64_finish_wall_s=time.perf_counter() - t0,
        f64_finished_members=int(len(finished)), **_flags(info_r))
    return shared


#: what the weak-scaling rows say of themselves
SHARDS_NOTE = ('shards of one device, driven by one process: on one device '
               'the shards add host-bound overhead, not speed')


def _gaussian_world(nx, ny, device):
    from .models.shallow_water import ShallowWater
    return ShallowWater(nx=nx, ny=ny, dx=100e3, dy=100e3, dt=60.0, f_0=1e-4,
                        beta=1.6e-11,
                        initial_info={'type': 'height_gaussian',
                                      'min_h_surface': 9750.0,
                                      'max_h_surface': 10750.0,
                                      'x0': 0.0, 'y0': 0.0,
                                      'x_std': 1000e3, 'y_std': 1000e3,
                                      'add_noise': False},
                        device=device)


def _sharded_run(sharded, nt, device):
    """Best-of-3 wall of ``sharded.run(nt)``, every run from the world's
    initial state; raises where a run ends with ``ok`` False."""
    world = sharded.world
    state0 = world.state

    def fresh():
        world._state = state0

    def march(_):
        sharded.run(nt)
        if not bool(world.state.ok):
            raise RuntimeError(f'sharded shallow water {world.nx}x{world.ny}: '
                               f'a {nt}-step run aborted (ok False)')
    return _best_of(device, fresh, march)[0]


def bench_weak_scaling(base=8, *, device):
    """x-sharded shallow water at a fixed tile per shard (``bench.py:633``,
    there on a virtual CPU mesh): 32 x 128 cells a shard on 1, 2, 4 and 8
    (up to ``base``) shards of ``device``, the plain richtmyer stencils."""
    from .parallel.halo import ShardedShallowWater
    from .parallel.mesh import make_mesh
    out = {'devices': str(device), 'note': SHARDS_NOTE}
    for n in (1, 2, 4, 8):
        if n > base:
            break
        nx = 32 * n + 2
        world = _gaussian_world(nx, 130, device)
        mesh = make_mesh(('x',), devices=[device] * n)
        wall = _sharded_run(ShardedShallowWater(world, mesh, axis_name='x'),
                            50, device)
        cells = (nx - 2) * 128
        out[str(n)] = {'cell_updates_per_sec': cells * 50 / wall,
                       'wall_s': wall, 'grid': [nx, 130],
                       'ok': bool(world.state.ok)}
    return out


def bench_weak_scaling_2d(base=8, *, device):
    """2-D decomposition at a fixed tile per shard (``bench.py:686``):
    32 x 32 and 256 x 256 tiles over 1x1, 2x1, 2x2 and 4x2 meshes (up to
    ``base`` shards) of ``device``; halo_overhead_pct is each run's per-shard
    rate short of the one-shard run's."""
    from .parallel.halo import ShardedShallowWater2D
    from .parallel.mesh import make_mesh
    out = {'devices': str(device), 'note': SHARDS_NOTE}
    for tile in (32, 256):
        res = {}
        rate_1 = None
        nt = 50 if tile == 32 else 20
        for mx, my in ((1, 1), (2, 1), (2, 2), (4, 2)):
            n = mx * my
            if n > base:
                break
            nx, ny = tile * mx + 2, tile * my + 2
            world = _gaussian_world(nx, ny, device)
            mesh = make_mesh(('x', 'y'), shape=(mx, my),
                             devices=[device] * n)
            wall = _sharded_run(ShardedShallowWater2D(world, mesh), nt,
                                device)
            rate = (nx - 2) * (ny - 2) * nt / wall
            rate_1 = rate_1 or rate / n
            res[str(n)] = {'mesh': [mx, my], 'grid': [nx, ny], 'wall_s': wall,
                           'cell_updates_per_sec': rate,
                           'halo_overhead_pct': round(
                               max(0.0, 100.0 * (1 - rate / n / rate_1)), 1),
                           'ok': bool(world.state.ok)}
        out[f'tile_{tile}'] = res
    return out


FULL_ROWS = (
    ('grey_rce', bench_grey),
    ('shallow_water', bench_sw),
    ('real_gas', bench_real_gas),
    ('grey_rce_single_column', bench_grey_single_column),
    ('real_gas_earth', bench_real_gas_earth),
    ('real_gas_earth_ensemble', bench_real_gas_earth_ensemble),
    ('real_gas_hires', bench_real_gas_hires),
    ('rce_convective', bench_rce_conv),
    ('rce_convective_ensemble', bench_rce_conv_ensemble),
    ('ebm_ice_albedo', bench_ebm),
    ('sw_weak_scaling', bench_weak_scaling),
    ('sw_weak_scaling_2d', bench_weak_scaling_2d),
)

#: ``bench.py:769-785``: the pipeline end to end in a minute, not a record
SMOKE_ROWS = (
    ('grey_rce', functools.partial(bench_grey, n_ensemble=64, nz=40,
                                   max_steps=600)),
    ('shallow_water', functools.partial(bench_sw, nx=258, ny=130, nt=50,
                                        solver='richtmyer')),
    ('grey_rce_single_column', functools.partial(bench_grey_single_column,
                                                 nz=60)),
)

#: (row, key path, value) that a full run must show (PERF.md section 2);
#: besides, no march of any row may fail or go non-finite and no shallow
#: water run may end with ok False
REQUIRED = (
    ('grey_rce', 'converged_fraction', 1.0),
    ('rce_convective', 'equilibrium', True),
    ('rce_convective_ensemble', 'converged_fraction', 1.0),
    ('ebm_ice_albedo', 'independent_dt_ensemble.converged_fraction', 1.0),
    ('real_gas_earth', 'equilibrium', True),
    ('real_gas_earth', 'check_every_4.equilibrium', True),
    ('real_gas_earth_ensemble', 'converged_fraction', 1.0),
)

#: one headline number per row for the stdout line: (row, key path)
HEADLINES = (
    ('shallow_water', 'cell_updates_per_sec'),
    ('real_gas', 'steps_per_sec'),
    ('grey_rce_single_column', 'per_step.model_days_per_sec'),
    ('real_gas_earth', 'steps_per_sec'),
    ('real_gas_earth_ensemble', 'model_days_per_sec'),
    ('real_gas_hires', 'f32.steps_per_sec'),
    ('rce_convective', 'model_days_per_sec'),
    ('rce_convective_ensemble', 'model_days_per_sec'),
    ('ebm_ice_albedo', 'model_days_per_sec'),
    ('sw_weak_scaling', '8.cell_updates_per_sec'),
    ('sw_weak_scaling_2d', 'tile_256.8.cell_updates_per_sec'),
)


def _get(row, path):
    for key in path.split('.'):
        if not isinstance(row, dict) or key not in row:
            return None
        row = row[key]
    return row


def _broken_flags(key, row, smoke):
    """The required flags ``row`` misses, as 'row.path=value' strings."""
    out = []

    def walk(x, path):
        if not isinstance(x, dict):
            return
        for k, v in x.items():
            p = f'{path}.{k}'
            if (k in ('nan', 'failed') and v is True) or (k == 'ok'
                                                          and v is False):
                out.append(f'{p}={v}')
            walk(v, p)
    walk(row, key)
    if not smoke:
        out += [f'{key}.{path}={_get(row, path)}'
                for name, path, want in REQUIRED
                if name == key and _get(row, path) != want]
    return out


def _rooflines(extra):
    """On the card: the bytes a step must at least move, over its wall,
    and that rate's share of the H100's HBM rate (``bench.py:867-900``)."""
    if extra['platform'] != 'cuda':
        return

    def put(row, gbs):
        row['min_traffic_gbs'] = gbs
        row['roofline_fraction_min_traffic'] = gbs * 1e9 / HBM_BYTES_PER_S
    sw = extra.get('shallow_water')
    if isinstance(sw, dict) and 'error' not in sw:
        # 3 reads and 3 writes of the interior fields a step
        nxi, nyi = sw['grid'][0] - 2, sw['grid'][1] - 2
        put(sw, 6 * nxi * nyi * 4 / (sw['wall_s'] / sw['steps']) / 1e9)
    for key, sub in (('real_gas_earth', None), ('real_gas_hires', 'f32')):
        rg = extra.get(key)
        if isinstance(rg, dict) and 'error' not in rg:
            # the summed [n_lw, nz, nz-1] f32 march operator a step
            b = rg['n_lw_bands'] * rg['nz'] * (rg['nz'] - 1) * 4
            row = rg[sub] if sub else rg
            put(row, b * row['steps_per_sec'] / 1e9)
    g = extra.get('grey_rce')
    if isinstance(g, dict) and 'error' not in g:
        # ~8 member-column arrays touched a step: a rough lower bound
        put(g, 8 * g['nz'] * 4 * g['total_steps'] / g['wall_s'] / 1e9)


def _nvidia_smi():
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f'nvidia-smi failed: {e}'
    if out.returncode != 0:
        return f'nvidia-smi failed: {out.stderr.strip()[:200]}'
    return out.stdout.strip().splitlines()[0]


def _loadavg():
    try:
        return round(os.getloadavg()[0], 2)
    except OSError:
        return None


def _launch_modules():
    from .ops import cuda_convection, cuda_stencils, cuda_two_stream
    return cuda_two_stream, cuda_convection, cuda_stencils


def run_rows(rows, device):
    """Run each (name, fn) of ``rows`` on ``device``; a row that raises
    records its error and the rest go on.  Returns (results, walls), each
    result with the kernel launches its row made."""
    mods = _launch_modules()
    results, walls = {}, {}
    for key, fn in rows:
        for m in mods:
            m.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            res = fn(device=device)
        except Exception as e:      # record, keep benching
            res = {'error': f'{type(e).__name__}: {e}'[:300],
                   'traceback': traceback.format_exc()[-1500:]}
        walls[key] = round(time.perf_counter() - t0, 1)
        res['launches'] = {k: v for m in mods
                           for k, v in m.launch_counts.items() if v}
        results[key] = res
    return results, walls


def compact_line(result):
    """The stdout line of ``result`` (the full record): its metric and a
    compact ``extra`` with one headline number a row, under LINE_LIMIT
    characters (error texts are cut shorter until it fits)."""
    extra = result['extra']
    for cut in (120, 60, 0):
        compact = {k: extra[k] for k in
                   ('platform', 'device_name', 'n_devices', 'smoke', 'only',
                    'host_load_warning', 'loadavg_start', 'loadavg_end',
                    'broken', 'config_wall_s', 'full_record',
                    'full_record_error') if k in extra}
        for key, path in HEADLINES:
            row = extra.get(key)
            if not isinstance(row, dict):
                continue
            if 'error' in row:
                compact[key] = {'error': row['error'][:cut]}
            elif _get(row, path) is not None:
                compact[key] = _get(row, path)
        if 'broken' in compact:
            compact['broken'] = [b[:cut or 40] for b in compact['broken']]
        line = json.dumps(dict(result, extra=compact))
        if len(line) < LINE_LIMIT:
            return line
    return json.dumps(dict(result, extra={
        'platform': extra['platform'], 'broken': len(extra['broken']),
        'full_record': extra.get('full_record')}))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m climatemodel_tpu_torch.bench',
        description='The port\'s bench: bench.py\'s rows on one device.')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                    help='where the rows run (default cuda; never falls back '
                         'to the CPU)')
    ap.add_argument('--only', action='append', default=[],
                    metavar='SUBSTRING',
                    help='run only the rows whose name holds SUBSTRING '
                         '(repeatable)')
    ap.add_argument('--smoke', action='store_true',
                    help="bench.py's smoke list: three rows cut to run in a "
                         'minute')
    ap.add_argument('--out', default=str(OUT_PATH),
                    help=f'where the full record goes (default {OUT_PATH})')
    return ap.parse_args(argv)


def main(argv=None):
    """Run the bench; returns the exit code.  A failure outside the rows
    still prints the line, with its error."""
    args = parse_args(argv)
    try:
        return _bench(args)
    except Exception as e:
        print(json.dumps(dict(METRIC, value=None, vs_baseline=None,
                              error=f'{type(e).__name__}: {e}'[:500],
                              traceback=traceback.format_exc()[-1000:])))
        return 1


def _bench(args):
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        print(json.dumps(dict(METRIC, value=None, vs_baseline=None,
                              error='no CUDA device (pass --device cpu to '
                                    'run on the CPU)')))
        return 2
    if device.type == 'cuda':
        # with its index, as the tensors on the card name their device
        device = torch.device('cuda', torch.cuda.current_device())
    extra = {'platform': device.type, 'device': str(device),
             'torch_version': torch.__version__,
             'cuda_version': torch.version.cuda, 'dtype': 'float32',
             'matmul_allow_tf32': torch.backends.cuda.matmul.allow_tf32}
    if device.type == 'cuda':
        extra.update(device_name=torch.cuda.get_device_name(device),
                     n_devices=torch.cuda.device_count(),
                     nvidia_smi=_nvidia_smi(),
                     roofline_peak_bytes_per_s=HBM_BYTES_PER_S)
    if args.smoke:
        extra['smoke'] = True
    ncpu = os.cpu_count() or 1
    load_start = _loadavg()
    if load_start is not None:
        extra.update(loadavg_start=load_start, n_cpus=ncpu)
        if load_start > 0.25 * ncpu:
            extra['host_load_warning'] = (
                f'1-min loadavg {load_start:.1f} on {ncpu} CPUs at bench '
                'start: another heavy process is likely running; timings '
                'may be polluted')

    rows = SMOKE_ROWS if args.smoke else FULL_ROWS
    if args.only:
        rows = [(k, f) for k, f in rows if any(s in k for s in args.only)]
        extra['only'] = args.only
    results, walls = run_rows(rows, device)
    extra.update(results)
    extra['config_wall_s'] = walls
    extra['loadavg_end'] = _loadavg()
    _rooflines(extra)
    extra['broken'] = [b for key, row in results.items()
                       for b in _broken_flags(key, row, args.smoke)]
    errors = [key for key, row in results.items() if 'error' in row]

    grey = results.get('grey_rce', {})
    result = dict(METRIC, value=grey.get('model_days_per_sec'),
                  vs_baseline=None, extra=extra)
    out = Path(args.out)
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1))
        extra['full_record'] = str(out)
    except OSError as e:
        extra['full_record_error'] = str(e)[:120]
    print(compact_line(result), flush=True)
    return 1 if errors or extra['broken'] else 0


if __name__ == '__main__':
    sys.exit(main())
