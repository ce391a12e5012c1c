#!/usr/bin/env python3
"""Kernel timings of versions of the PyTorch port on one NVIDIA GPU, in turns.

    python3 chip_compare.py [--kernels-only] DIR [DIR ...]

Each ``DIR`` holds a ``climatemodel_tpu_torch``: ``.`` for this checkout,
another commit's from ``git archive <commit> climatemodel_tpu_torch | tar -x
-C .chip_scratch/parent``, or a variant of a kernel as a copy of the package
with one constant of its ``.cu`` edited (``.chip_scratch/`` is git-ignored).
Each version runs in a process of its own, in the order given and then in
reverse (parent, this, this, parent for two), and builds its kernels from
its own sources.  Each process prints one JSON line of f32 timings:
``lw_walk`` (K1) at the single world's [99, 1] and the headline's [59,
4096]; ``div_probe`` (K7) on the probe's inputs [256, 128]; the fused step
at 2050 x 1026 with walls/walls (K6, the El Nino run's configuration) and
in its interior mode (K5), K6 on 16 times the
cells (8194 x 4098, CUDA events, a 16th of a call), and chip_smoke's
``level_scan`` call (``lw_flux_level_sharded`` on the single-controller
mesh of ``SHARDS`` shards of the card).  Without
``--kernels-only`` also 100 El Nino steps under the profiler, 400-step El
Nino runs (best of 3) and the grey single world's march.  Device times are
``torch.profiler`` (CUPTI) sums, call times CUDA events (``chip_smoke``'s
``device_ms`` and ``time_ms``).  The last line is the card's name and power
limit.  Needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_smoke():
    """chip_smoke.py beside this script, as a module of helpers."""
    spec = importlib.util.spec_from_file_location('chip_smoke_helpers',
                                                  HERE / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_profile(psw, world, nt=100):
    """``nt`` El Nino steps under the profiler: device operations a step, the
    fused step's device time a step (its kernel, and the max2 launch of
    versions that had one), the rest, and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    kw = world._step_kwargs()
    psw.sw_simulate(world.state, world.params, 5, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        psw.sw_simulate(world.state, world.params, nt, **kw)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(getattr(e, 'device_time_total', None)
             or getattr(e, 'cuda_time_total', 0), e.count, e.key)
            for e in prof.key_averages()]
    rows = [r for r in rows if r[0] > 0]
    busy = sum(r[0] for r in rows) / 1e3
    fused = sum(r[0] for r in rows
                if 'richtmyer' in r[2] or 'max_reduce' in r[2]) / 1e3
    return {'ms_per_step': wall_ms / nt,
            'device_ops_per_step': sum(r[1] for r in rows) / nt,
            'fused_step_device_ms': fused / nt,
            'rest_device_ms': (busy - fused) / nt,
            'device_idle_share': 1 - busy / wall_ms}


def worker(root: Path, kernels_only: bool):
    """Time the package under ``root``; print one JSON line."""
    import torch
    sys.path.insert(0, str(root))
    import climatemodel_tpu_torch as pkg
    if Path(pkg.__file__).resolve().parents[1] != root:
        raise RuntimeError(f'imported {pkg.__file__}, not the package under '
                           f'{root}')
    cs = load_smoke()
    from climatemodel_tpu_torch.constants import Omega, R_earth, \
        p_surface_earth
    from climatemodel_tpu_torch.models import shallow_water as psw
    from climatemodel_tpu_torch.models.grey import GreyGas
    from climatemodel_tpu_torch.ops import cuda_convection as ccv
    from climatemodel_tpu_torch.ops import cuda_stencils as csl
    from climatemodel_tpu_torch.ops import cuda_two_stream as cts
    dev = torch.device('cuda', 0)
    cs.build_all()
    res = {'root': str(root)}

    def times(fn):
        return {'device_ms': cs.device_ms(fn), 'call_ms': cs.time_ms(fn)}

    gen = torch.Generator().manual_seed(5)
    for n, b in ((99, 1), (59, 4096)):
        T, dtau, toa = cs.walk_inputs(gen, n, b, torch.float32, dev)
        res[f'lw_walk_{n}x{b}'] = times(lambda: cts.lw_walk(T, dtau, toa))
    a, b = (torch.from_numpy(x).to(dev) for x in cs.probe_inputs())
    res['div_probe'] = times(lambda: ccv.div_probe(a, b))
    x = cs.sw_inputs(torch.Generator().manual_seed(41), cs.SW['nx'],
                     cs.SW['ny'], torch.float32, dev, True, True)
    args = cs.sw_args(x)
    bufs = tuple(torch.empty_like(x['h']) for _ in range(3))
    res['richtmyer_step_bc'] = times(lambda: csl.richtmyer_step(
        *args, bx='walls', by='walls', out=bufs))
    res['richtmyer_step_interior'] = times(lambda: csl.richtmyer_step(*args))
    # the same step on 16 times the cells: a call outlasts its launch on the
    # host, so CUDA events time the device; beside the full size's time, a
    # 16th shows the share of a launch that is fill and tail
    big = cs.sw_inputs(torch.Generator().manual_seed(7), 4 * cs.SW['nx'] - 6,
                       4 * cs.SW['ny'] - 6, torch.float32, dev, True, True)
    big_args = cs.sw_args(big)
    big_bufs = tuple(torch.empty_like(big['h']) for _ in range(3))
    res['richtmyer_step_bc_16x_ms_per_16th'] = cs.time_ms(
        lambda: csl.richtmyer_step(*big_args, bx='walls', by='walls',
                                   out=big_bufs)) / 16
    del big, big_args, big_bufs
    from climatemodel_tpu_torch.parallel import level_scan as pls
    from climatemodel_tpu_torch.parallel import mesh as pmesh
    T, dtau, toa = cs.level_scan_inputs(GreyGas, p_surface_earth,
                                        cs.LEVEL_SCAN['members'],
                                        torch.float32, dev)
    mesh = pmesh.make_mesh(('lev',), devices=[dev] * cs.SHARDS)
    res['level_scan_sharded'] = times(lambda: pls.lw_flux_level_sharded(
        T, dtau, toa, mesh, 'lev'))
    if not kernels_only:
        world = cs.sw_world(psw, Omega, R_earth, cs.SW['nx'], cs.SW['ny'],
                            device=dev)
        res['sw_profile'] = step_profile(psw, world)
        kw = world._step_kwargs()
        nt = cs.SW['nt']
        walls = []
        for _ in range(4):                   # a warm run, then 3 timed
            t0 = time.perf_counter()
            psw.sw_simulate(world.state, world.params, nt, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        res['el_nino_ms_per_step'] = 1e3 * min(walls[1:]) / nt
        single = cs.build_world(GreyGas, p_surface_earth, 100, dev)
        for _ in range(2):                   # a warm march, then a timed one
            t0 = time.perf_counter()
            single.evolve_to_equilibrium(flux_thresh=1e-4, save=False,
                                         t_end=30.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps = int(single._equilibrium_info.steps)
        res['single_world'] = {'wall_s': wall, 'steps': steps,
                               'ms_per_step': 1e3 * wall / steps}
    print(json.dumps(res), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('dirs', type=Path, nargs='+',
                    help='directories each holding a climatemodel_tpu_torch')
    ap.add_argument('--kernels-only', action='store_true',
                    help='time the kernels only: no profile, shallow-water '
                         'runs or single world')
    ap.add_argument('--worker', action='store_true', help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        worker(a.dirs[0].resolve(), a.kernels_only)
        return 0
    import torch
    if not torch.cuda.is_available():
        print('chip_compare: no CUDA device', file=sys.stderr)
        return 2
    roots = [d.resolve() for d in a.dirs]
    for root in roots:
        if not (root / 'climatemodel_tpu_torch').is_dir():
            print(f'chip_compare: no climatemodel_tpu_torch under {root}',
                  file=sys.stderr)
            return 2
    for root in roots + roots[::-1]:
        cmd = [sys.executable, str(HERE / 'chip_compare.py'), '--worker',
               str(root)] + (['--kernels-only'] if a.kernels_only else [])
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=str(root))
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            print(f'chip_compare: the run of {root} failed '
                  f'(exit {proc.returncode})', file=sys.stderr)
            return 1
        print([x for x in proc.stdout.splitlines()
               if x.startswith('{"root"')][-1], flush=True)
    print(load_smoke().nvidia_smi_line(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
