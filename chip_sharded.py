#!/usr/bin/env python3
"""The sharded phases of ``chip_smoke.py`` with one shard on each card:
``sharded_sw`` (bench_sw's El Nino and wind-free worlds at 2050 x 1026 on
the fused kernel's 'given' mode, the halo rows and the collectives crossing
cards), ``sharded_2d`` and ``level_scan``, and the member- and band-sharded
compositions of ``parallel/ensemble.py`` (``dp_grey`` and ``dp_conv``: K3,
and K4 on isotonic, launched on every card, counted per card; ``rg_tp``,
``rg_dp``, ``rg_dp_tp``) and the dp x sp shallow-water ensemble
(``sw_dp_sp``), on a mesh of every CUDA device, against the unsharded runs
on the first card.  Then every one of these compositions SPMD
(``ranks_*``): one process a card (``parallel/launch.run_ranks``, NCCL),
each rank driving its own shard, beside the same composition on the
single-controller mesh of the cards and unsharded on the first card, in
that order; each rank's result bit-equal to the single-controller run's,
its walls, the throughput ratios to the unsharded run and each rank's
kernel launches.  Needs exactly ``chip_smoke.SHARDS`` (4) CUDA devices and
``nvcc``; imports no JAX.

    python3 chip_sharded.py

Every phase prints one JSON line; a failed check exits 1 with
``chip_sharded: FAILED: ...`` on stderr.  The last lines are the cards'
names and power limits as nvidia-smi reports them, and ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


# --------------------------------------------------------------------------
# the compositions SPMD: one rank a card, beside the single-controller mesh
# and the unsharded run
# --------------------------------------------------------------------------

RANKS_TIMEOUT_S = 900
#: the level scan's and the band-sharded flux's calls in a timed run
CALLS = 20


def days(fs):
    return float(fs.t.double().sum()) / 86400.0


def prepare_grey(mesh, dev):
    """The headline march and its f64 finish (``dp_grey``)."""
    import numpy as np
    from climatemodel_tpu_torch.constants import p_surface_earth
    from climatemodel_tpu_torch.models import ensemble as ens
    from climatemodel_tpu_torch.models.grey import GreyGas
    from climatemodel_tpu_torch.parallel import ensemble as pens
    world = cs.build_world(GreyGas, p_surface_earth, cs.HEADLINE['nz'], dev)
    args = ens.grey_ensemble(world, np.linspace(*cs.HEADLINE['F'],
                                                cs.HEADLINE['members']))
    ft, kw = cs.HEADLINE['flux_thresh'], dict(
        max_steps=cs.HEADLINE['max_steps'])

    def run():
        if mesh is None:
            fs, info = ens.grey_evolve_ensemble(*args, ft, **kw)
            fin, fin_info, done = ens.grey_finish_unconverged_f64(
                fs, info, *args[1:], ft, **kw)
        else:
            fs, info = pens.grey_evolve_ensemble_sharded(mesh, *args, ft,
                                                         **kw)
            fin, fin_info, done = pens.grey_finish_unconverged_f64_sharded(
                mesh, fs, info, *args[1:], ft, **kw)
        return (dict(T=fs.T, t=fs.t, steps=info.steps, T_f64=fin.T,
                     equilibrium=fin_info.equilibrium),
                dict(model_days=days(fs), f64_finished=len(done)))
    return run


def prepare_conv(method):
    def prepare(mesh, dev):
        """The convective ensemble (``dp_conv``)."""
        import numpy as np
        from climatemodel_tpu_torch.constants import p_surface_earth
        from climatemodel_tpu_torch.models import ensemble as ens
        from climatemodel_tpu_torch.models.grey import GreyGas
        from climatemodel_tpu_torch.parallel import ensemble as pens
        world = GreyGas(nz=cs.CONV['nz'], ny=1, device=dev,
                        **cs.thermosphere_kwargs(p_surface_earth))
        args = ens.grey_ensemble(world, np.linspace(*cs.CONV['F'],
                                                    cs.CONV['members']))
        kw = dict(convective_adjust=True, conv_method=method,
                  max_steps=cs.CONV['max_steps'])

        def run():
            fs, info = (ens.grey_evolve_ensemble(
                *args, cs.CONV['flux_thresh'], **kw) if mesh is None else
                pens.grey_evolve_ensemble_sharded(
                    mesh, *args, cs.CONV['flux_thresh'], **kw))
            return (dict(T=fs.T, t=fs.t, steps=info.steps),
                    dict(model_days=days(fs)))
        return run
    return prepare


def prepare_sw(el_nino):
    def prepare(mesh, dev):
        """bench_sw's world at 2050 x 1026, 400 steps (``sharded_sw``)."""
        from climatemodel_tpu_torch.constants import Omega, R_earth
        from climatemodel_tpu_torch.models import shallow_water as psw
        from climatemodel_tpu_torch.parallel import halo as phalo
        world = cs.sw_world(psw, Omega, R_earth, cs.SW['nx'], cs.SW['ny'],
                            el_nino, device=dev)
        nt = cs.SW['nt']
        sh = None if mesh is None else phalo.ShardedShallowWater(world, mesh)

        def run():
            if sh is None:
                st = psw.sw_simulate(world.state, world.params, nt,
                                     **world._step_kwargs())
            else:
                sh.run(nt)
                st = world.state
            return ({k: getattr(st, k) for k in ('h', 'u', 'v', 't', 'dt',
                                                 'ok')},
                    dict(cell_updates=(cs.SW['nx'] - 2) * (cs.SW['ny'] - 2)
                         * nt))
        return run
    return prepare


def prepare_rg_tp(mesh, dev):
    """The earth column's net flux with its bands on the mesh
    (``rg_tp``), CALLS calls."""
    import torch
    from climatemodel_tpu_torch.models import real_gas as prg
    from climatemodel_tpu_torch.parallel import ensemble as pens
    gas = cs.earth_gas(prg, 'auto', device=dev)
    tau, ba, F, delta = gas.tau_device, gas.band_arrays, \
        gas._F_star_factor, gas._geom_device[0]
    cache = prg.precompute_transmission(tau, ba)
    T = gas.state.T
    T_g = torch.full((1,), float(gas.T_g), dtype=T.dtype, device=T.device)
    if mesh is None:
        def fn(T):
            net, diff = prg.real_gas_net_and_diff_cached(T[..., 0], T_g,
                                                         cache, ba, F, delta)
            return net[..., None], diff[..., None]
    else:
        bas, caches, Fs, deltas = pens.shard_bands(mesh, 'x', ba, cache, F,
                                                   delta)
        fn = pens.real_gas_net_fn_band_sharded(
            mesh, 'x', [T_g.to(d) for d in mesh.local_devices], caches, bas,
            Fs, deltas)

    def run():
        for _ in range(CALLS):
            net, diff = fn(T)
        return dict(net=net, diff=diff), dict(calls=CALLS)
    return run


def prepare_rg(band_axis):
    def prepare(mesh, dev):
        """bench_real_gas_earth_ensemble (``rg_dp``, ``rg_dp_tp``)."""
        import numpy as np
        from climatemodel_tpu_torch.models import ensemble as ens
        from climatemodel_tpu_torch.models import real_gas as prg
        from climatemodel_tpu_torch.parallel import ensemble as pens
        gas = cs.earth_gas(prg, 'auto', device=dev,
                           temp_change=cs.RG_ENSEMBLE['temp_change'])
        args = ens.real_gas_ensemble(gas, F_scales=np.linspace(
            *cs.RG_ENSEMBLE['F'], cs.RG_ENSEMBLE['members']))
        kw = dict(t_end=cs.RG_ENSEMBLE['t_end'],
                  max_steps=cs.RG_ENSEMBLE['max_steps'])
        states, sc, T_gs, march = args
        ft = cs.RG_ENSEMBLE['flux_thresh']

        def run():
            fs, info = (ens.real_gas_evolve_ensemble(
                states, sc, T_gs, *march, ft, **kw) if mesh is None else
                pens.real_gas_evolve_ensemble_sharded(
                    mesh, states, sc, T_gs, *march, ft, band_axis=band_axis,
                    **kw))
            return (dict(T=fs.T, t=fs.t, steps=info.steps,
                         equilibrium=info.equilibrium),
                    dict(model_days=days(fs)))
        return run
    return prepare


def prepare_dp_sp(mesh, dev):
    """bench_sw's El Nino world as DP_SW['members'] members on (2, 2)
    (``sw_dp_sp``); unsharded: each member's plain richtmyer run."""
    import torch
    from climatemodel_tpu_torch.constants import Omega, R_earth
    from climatemodel_tpu_torch.models import shallow_water as psw
    from climatemodel_tpu_torch.parallel import halo as phalo
    world = cs.sw_world(psw, Omega, R_earth, cs.SW['nx'], cs.SW['ny'],
                        device=dev)
    st0 = world.state
    n, nt = cs.DP_SW['members'], cs.DP_SW['steps']
    members = [psw.apply_boundary_conditions(
        st0.h * (1 + cs.DP_SW['dh'] * k), st0.u, st0.v, 'walls', 'walls')
        for k in range(n)]
    work = dict(cell_updates=(cs.SW['nx'] - 2) * (cs.SW['ny'] - 2) * n * nt)
    kw = dict(world._step_kwargs(), solver='richtmyer')
    if mesh is None:
        def run():
            out = [psw.sw_simulate(st0.replace(h=m[0], u=m[1], v=m[2]),
                                   world.params, nt, **kw) for m in members]
            return (dict(h=torch.stack([o.h for o in out])), work)
        return run
    h, u, v = (torch.stack(f) for f in zip(*members))
    ensemble = phalo.ShardedShallowWaterEnsemble(world, mesh, h, u, v)

    def run():
        got = ensemble.run(nt)
        return dict(zip(('h', 'u', 'v', 't', 'dt', 'ok'), got)), work
    return run


def prepare_2d(mesh, dev):
    """``ShardedShallowWater2D``, El Nino at the smoke size (``sharded_2d``);
    unsharded: the plain richtmyer run."""
    import warnings
    from climatemodel_tpu_torch.constants import Omega, R_earth
    from climatemodel_tpu_torch.models import shallow_water as psw
    from climatemodel_tpu_torch.parallel import halo as phalo
    world = cs.sw_world(psw, Omega, R_earth, cs.SW_2D['nx'], cs.SW_2D['ny'],
                        device=dev)
    nt = cs.SW_2D['nt']
    work = dict(cell_updates=(cs.SW_2D['nx'] - 2) * (cs.SW_2D['ny'] - 2)
                * nt)
    if mesh is None:
        def run():
            st = psw.sw_simulate(world.state, world.params, nt, **dict(
                world._step_kwargs(), solver='richtmyer'))
            return dict(h=st.h, u=st.u, v=st.v), work
        return run
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')           # the richtmyer swap (F5)
        sh = phalo.ShardedShallowWater2D(world, mesh)

    def run():
        sh.run(nt)
        st = world.state
        return dict(h=st.h, u=st.u, v=st.v, t=st.t, dt=st.dt), work
    return run


def prepare_level_scan(mesh, dev):
    """The level-sharded flux at [60, 4096] (``level_scan``), CALLS calls;
    unsharded: the plain scan."""
    import torch
    from climatemodel_tpu_torch.constants import p_surface_earth
    from climatemodel_tpu_torch.models.grey import GreyGas
    from climatemodel_tpu_torch.ops import two_stream as ts
    from climatemodel_tpu_torch.parallel import level_scan as pls
    T, dtau, toa = cs.level_scan_inputs(GreyGas, p_surface_earth,
                                        cs.LEVEL_SCAN['members'],
                                        torch.float32, dev)

    def run():
        for _ in range(CALLS):
            up, down = (ts.lw_flux_plain(T, dtau, toa) if mesh is None else
                        pls.lw_flux_level_sharded(T, dtau, toa, mesh, 'lev'))
        return dict(up=up, down=down), dict(calls=CALLS)
    return run


def rank_cases(n):
    """name -> (mesh axes, mesh shape, runs (the last timed), prepare)."""
    half = (2, n // 2)
    return {
        'dp_grey': (('data',), (n,), 2, prepare_grey),
        'dp_conv_reference': (('data',), (n,), 2, prepare_conv('reference')),
        'dp_conv_isotonic': (('data',), (n,), 1, prepare_conv('isotonic')),
        'sharded_sw_el_nino': (('x',), (n,), 2, prepare_sw(True)),
        'sharded_sw_no_wind': (('x',), (n,), 2, prepare_sw(False)),
        'rg_tp': (('x',), (n,), 2, prepare_rg_tp),
        'rg_dp': (('data',), (n,), 1, prepare_rg(None)),
        'rg_dp_tp': (('data', 'x'), half, 1, prepare_rg('x')),
        'sw_dp_sp': (('data', 'x'), half, 2, prepare_dp_sp),
        'sharded_2d': (('x', 'y'), half, 2, prepare_2d),
        'level_scan': (('lev',), (n,), 2, prepare_level_scan)}


def digest(x):
    """A tensor's dtype, shape and bytes, hashed: equal digests are equal
    tensors bit for bit."""
    a = x.detach().cpu().contiguous().numpy()
    return hashlib.sha256(f'{a.dtype}{a.shape}'.encode()
                          + a.tobytes()).hexdigest()


def run_case(prepare, runs, mesh, dev, barrier=None):
    """``runs`` runs of a case, each prepared anew; the last timed, the
    kernel counts set to 0 before it and read after.  Returns (digests of
    its outputs, its work, wall, launches)."""
    import torch
    from climatemodel_tpu_torch.parallel import launch
    for _ in range(runs):
        run = prepare(mesh, dev)
        torch.cuda.synchronize()
        if barrier is not None:
            barrier()
        launch.reset_launch_counts()
        t0 = time.perf_counter()
        out, work = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return ({k: digest(v) for k, v in out.items()}, work, wall,
            {k: v for k, v in launch.launch_counts().items() if v})


def halo_probe(mesh, dev, calls=200):
    """The x halo of El Nino's kernel path (``_set_ghosts``): both
    directions in one exchange, received into contiguous staging rows and
    copied into the strided ghost rows of the [3, lnx + 2, ny] buffers;
    beside the same exchange between contiguous [3, ny] rows (what a
    layout with contiguous ghost rows would move).  ms a call, CUDA
    events."""
    import torch
    from climatemodel_tpu_torch.constants import Omega, R_earth
    from climatemodel_tpu_torch.models import shallow_water as psw
    from climatemodel_tpu_torch.parallel import collectives as col
    from climatemodel_tpu_torch.parallel import halo as phalo
    world = cs.sw_world(psw, Omega, R_earth, cs.SW['nx'], cs.SW['ny'],
                        device=dev)
    sh = phalo.ShardedShallowWater(world, mesh)
    n, ny = mesh.size, cs.SW['ny']
    bufs = [torch.randn(3, sh.local_nx + 2, ny, device=dev)]
    rows = [torch.randn(3, ny, device=dev) for _ in range(4)]
    perms = ([(i, i + 1) for i in range(n - 1)],
             [(i + 1, i) for i in range(n - 1)])

    def contiguous():
        col.ppermutes(mesh, 'x', [([rows[0]], perms[0], [rows[2]]),
                                  ([rows[1]], perms[1], [rows[3]])])
    out = {}
    for name, fn in (('staged_ms', lambda: sh._set_ghosts(bufs)),
                     ('contiguous_ms', contiguous)):
        out[name] = cs.time_ms(fn, reps=calls)
    return out


def rank_all(mesh, names):
    """Every case of ``names`` in this rank, on process meshes over the
    ranks, in order."""
    import torch
    import torch.distributed as dist
    from climatemodel_tpu_torch.parallel import mesh as pmesh
    torch.backends.cuda.matmul.allow_tf32 = False
    out, meshes = {}, {}
    for name in names:
        axes, shape, runs, prepare = rank_cases(mesh.size)[name]
        if (axes, shape) not in meshes:      # its groups, once a shape
            meshes[axes, shape] = pmesh.ProcessMesh(axes, shape,
                                                    device=mesh.device)
        out[name] = run_case(prepare, runs, meshes[axes, shape], mesh.device,
                             dist.barrier)
    out['halo_probe'] = halo_probe(mesh, mesh.device)
    return out


def phase_ranks_all(devices):
    """The ``ranks_*`` phases: every case on len(devices) NCCL ranks, then
    on the single-controller mesh of ``devices``, then unsharded on the
    first; each rank's outputs bit-equal to the single-controller run's;
    ratios of the throughput (the case's work over its wall) to the
    unsharded run's."""
    from climatemodel_tpu_torch.models import real_gas as prg
    from climatemodel_tpu_torch.parallel import launch
    from climatemodel_tpu_torch.parallel import mesh as pmesh
    n, dev = len(devices), devices[0]
    cs.earth_gas(prg, 'auto', device=dev)    # the earth tables, first
    cases = rank_cases(n)
    t0 = time.perf_counter()
    ranks = launch.run_ranks(rank_all, n, args=(list(cases),),
                             timeout_s=RANKS_TIMEOUT_S)
    cs.emit('ranks_run', ranks=n, run_ranks_wall_s=time.perf_counter() - t0,
            halo_probe=[r['halo_probe'] for r, _ in ranks])
    failed = []
    for name, (axes, shape, runs, prepare) in cases.items():
        single = run_case(prepare, runs, pmesh.make_mesh(
            axes, shape=shape, devices=devices), dev)
        plain = run_case(prepare, runs, None, dev)
        per_rank = [r[name] for r, _ in ranks]
        equal = [{k: d == single[0][k] for k, d in r[0].items()}
                 for r in per_rank]
        walls = [r[2] for r in per_rank]
        res = dict(mesh=dict(zip(axes, shape)), runs=runs, work=single[1],
                   rank_walls_s=walls, single_controller_wall_s=single[2],
                   unsharded_wall_s=plain[2],
                   ranks_over_unsharded=plain[2] / max(walls),
                   single_controller_over_unsharded=plain[2] / single[2],
                   ranks_over_single_controller=single[2] / max(walls),
                   launches_per_rank=[r[3] for r in per_rank],
                   single_controller_launches=single[3],
                   unsharded_launches=plain[3],
                   bit_equal_to_single_controller=[all(e.values())
                                                   for e in equal],
                   not_equal=[[k for k, v in e.items() if not v]
                              for e in equal])
        cs.emit(f'ranks_{name}', **res)
        if not all(res['bit_equal_to_single_controller']) or any(
                r[1] != single[1] for r in per_rank):
            failed.append(name)
    cs.check(not failed, f'ranks differ from the single-controller mesh: '
             f'{failed}')


def main():
    try:
        import torch
    except ImportError:
        print('chip_sharded: PyTorch is not installed', file=sys.stderr)
        return 2
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n != cs.SHARDS:
        print(f'chip_sharded: needs {cs.SHARDS} CUDA devices, found {n}',
              file=sys.stderr)
        return 2
    if not (ROOT / 'climatemodel_tpu_torch' / 'ops' / 'csrc').is_dir():
        print('chip_sharded: the climatemodel_tpu_torch package is missing',
              file=sys.stderr)
        return 2
    from climatemodel_tpu_torch.constants import Omega, R_earth, \
        p_surface_earth
    from climatemodel_tpu_torch.models import ensemble as ens
    from climatemodel_tpu_torch.models import real_gas as prg
    from climatemodel_tpu_torch.models import shallow_water as psw
    from climatemodel_tpu_torch.models.grey import GreyGas
    from climatemodel_tpu_torch.ops import convection as pc
    from climatemodel_tpu_torch.ops import cuda_convection as ccv
    from climatemodel_tpu_torch.ops import cuda_stencils as csl
    from climatemodel_tpu_torch.ops import cuda_two_stream as cts
    from climatemodel_tpu_torch.ops import two_stream as ts
    from climatemodel_tpu_torch.parallel import ensemble as pens
    from climatemodel_tpu_torch.parallel import halo as phalo
    from climatemodel_tpu_torch.parallel import level_scan as pls
    from climatemodel_tpu_torch.parallel import mesh as pmesh
    from climatemodel_tpu_torch.spectral import earth_tables as pet
    from climatemodel_tpu_torch.spectral import hitran as ph

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    devices = pmesh.make_mesh(('x',)).flat_devices
    dev = devices[0]
    cs.emit('device', names=[torch.cuda.get_device_name(i) for i in range(n)],
            count=n, nvidia_smi=smi.splitlines(), torch=torch.__version__,
            cuda=torch.version.cuda)
    cs.build_all()
    csl.library()
    cts.library()
    ccv.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    k6 = cs.phase_sharded_sw(psw, phalo, pmesh, Omega, R_earth, csl, dev,
                             devices)
    cs.phase_sharded_2d(psw, phalo, pmesh, Omega, R_earth, csl, dev, devices)
    cs.phase_level_scan(GreyGas, p_surface_earth, pls, pmesh, ts, dev,
                        devices)
    mods = (cts, ccv)
    dp_grey = cs.phase_dp_grey(ens, pens, pmesh, GreyGas, p_surface_earth,
                               mods, cts, ts, dev, devices)
    dp_conv = cs.phase_dp_conv(ens, pens, pmesh, GreyGas, p_surface_earth,
                               mods, ccv, pc, dev, devices)
    cs.phase_rg_tables(pet, ph)
    cs.phase_rg_tp(prg, pens, pmesh, dev, devices)
    cs.phase_rg_dp(prg, ens, pens, pmesh, dev, devices)
    cs.phase_sw_dp_sp(psw, phalo, pmesh, Omega, R_earth, csl, dev, devices)
    cs.emit('sharded_launches', richtmyer_step_bc=k6,
            net_stats_walk=dp_grey['k3']
            + dp_conv['launches']['net_stats_walk'],
            iso_fit=dp_conv['launches']['iso_fit'])
    phase_ranks_all(devices)
    return finish(torch, smi, n)


def finish(torch, smi, n):
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': n}}), flush=True)
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except cs.Failed as e:
        print(f'chip_sharded: FAILED: {e}', file=sys.stderr)
        sys.exit(1)
