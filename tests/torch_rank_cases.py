"""The sharded compositions of ``tests/test_torch_parallel_ranks.py``, each
written once for either kind of mesh.

Every case is ``case(make, states)``: ``make(axis_names, shape)`` returns
the mesh to run on, a single-controller ``Mesh`` of CPU shards in the test
process or a ``ProcessMesh`` in a spawned gloo rank (``run_ranks``), and
``states`` holds the shallow-water worlds' starting states as numpy
mappings.  :func:`all_cases` is the rank function: every rank runs every
case, in this order, so every rank builds the same process groups.  This
module imports neither ``jax`` nor the JAX package: the ranks import it.
"""
import numpy as np
import torch

from climatemodel_tpu_torch.constants import Omega, R_earth, p_surface_earth
from climatemodel_tpu_torch.models import ensemble as pens
from climatemodel_tpu_torch.models import real_gas as prg
from climatemodel_tpu_torch.models import shallow_water as psw
from climatemodel_tpu_torch.models.grey import GreyGas
from climatemodel_tpu_torch.parallel import collectives as col
from climatemodel_tpu_torch.parallel import ensemble as pe
from climatemodel_tpu_torch.parallel import halo as phalo
from climatemodel_tpu_torch.parallel import level_scan as pls
from climatemodel_tpu_torch.parallel import mesh as pmesh
from climatemodel_tpu_torch.spectral import humidity as phum
from climatemodel_tpu_torch.utils import interop

RANKS = 4
DTYPES = {'f64': torch.float64, 'f32': torch.float32}
GREY = dict(nz=24, ny=1, tau_lw_func='scale_height',
            tau_lw_func_args=[0.22 * p_surface_earth, 4.0])
F_GREY = np.linspace(900.0, 1500.0, 16)
SW_STEPS = 30
# the El Nino worlds: nx 66 on the kernel path (16 rows a shard, a JAX
# kernel band), 34 on the plain stencils
SW_CASES = {f'sw_{path}_{bx}_{wind or "no_wind"}': (path, bx, wind)
            for path in ('kernel', 'plain') for bx in ('walls', 'periodic')
            for wind in ('forced', None)}


def el_nino(nx, ny, bx, by, wind='forced', **kw):
    """The El Nino world of tests/test_sharded.py:310-323."""
    h_mean, g_use = 100.0, 0.05
    c = np.sqrt(g_use * h_mean)
    beta = 2 * Omega / R_earth
    L_def = np.sqrt(c / beta)
    dx = L_def / 5
    return dict(nx=nx, ny=ny, dx=dx, dy=dx, dt=0.05 * dx / c, f_0=0.0,
                beta=beta, boundary_type={'x': bx, 'y': by},
                r=1 / (10 * 30 * 24 * 60 ** 2), g=g_use,
                initial_info={'type': 'el_nino', 'max_h_surface': 110.0,
                              'min_h_surface': 90.0, 'y_std': L_def,
                              'add_noise': False, 'wind': {'type': wind}},
                **kw)


def sw_kw(name):
    path, bx, wind = SW_CASES[name]
    if path == 'kernel':
        return el_nino(66, 20, bx, 'walls', wind,
                       numerical_solver='richtmyer_pallas')
    return el_nino(34, 20, bx, 'walls', wind)


def dp_sp_kw(wind='forced'):
    """The El Nino world of the JAX package's multi-chip dry run, 18 x 10
    (nx: 2 x-shards of 8 rows)."""
    h_mean, g_use = 100.0, 0.05
    c = np.sqrt(g_use * h_mean)
    beta = 2 * Omega / R_earth
    L_def = np.sqrt(c / beta)
    dx = L_def / 2
    return dict(nx=18, ny=10, dx=dx, dy=dx, dt=0.05 * dx / c, f_0=0.0,
                beta=beta, r=1 / (10 * 30 * 24 * 3600), g=g_use,
                numerical_solver='richtmyer',
                boundary_type={'x': 'walls', 'y': 'walls'},
                initial_info={'type': 'el_nino', 'max_h_surface': 110.0,
                              'min_h_surface': 90.0, 'y_std': L_def,
                              'add_noise': False, 'wind': {'type': wind}})


def gas(dtype):
    return prg.RealGas(dtype=DTYPES[dtype], device='cpu',
                       q_funcs={'single_line': phum.co2}, nz=20, ny=1,
                       molecule_names=['single_line'], T_g=260.0,
                       q_funcs_args={'single_line': ()}, n_nu_bands=40,
                       delta_temp_change=0.1)


def _info(info):
    return {k: getattr(info, k) for k in info._fields}


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------

def grey_dp(make, dtype):
    world = GreyGas(dtype=DTYPES[dtype], device='cpu', **GREY)
    sp, fp, pip, pcp = pens.grey_ensemble(world, F_GREY)
    tel = {}
    st, info = pe.grey_evolve_ensemble_sharded(
        make(('data',), (RANKS,)), sp, fp, pip, pcp, 1e-2, axis_name='data',
        telemetry=tel, max_steps=20)
    return dict(T=st.T, t=st.t, info=_info(info),
                iterations=np.asarray(tel['iterations']))


def grey_robust(make):
    """The robust march in f32: the f64 finish on each shard's members."""
    world = GreyGas(dtype=torch.float32, device='cpu', **GREY)
    sp, fp, pip, pcp = pens.grey_ensemble(world, F_GREY)
    st, info, finished = pe.grey_evolve_ensemble_robust_sharded(
        make(('data',), (RANKS,)), sp, fp, pip, pcp, 1e-3, max_steps=50)
    return dict(T=st.T, info=_info(info), finished=finished)


def conv_dp(make, method):
    world = GreyGas(dtype=torch.float64, device='cpu', **GREY)
    sp, fp, pip, pcp = pens.grey_ensemble(world, F_GREY)
    tel = {}
    st, info = pe.grey_evolve_ensemble_sharded(
        make(('data',), (RANKS,)), sp, fp, pip, pcp, 1e-2, telemetry=tel,
        convective_adjust=True, conv_method=method, max_steps=12)
    return dict(T=st.T, t=st.t, info=_info(info),
                iterations=np.asarray(tel['iterations']))


def sharded_sw(make, name, state):
    """30 steps of an x-sharded El Nino world from ``state``; ``max2``, the
    local shards' max(u^2+v^2) after the run (kernel path)."""
    world = psw.ShallowWater(**sw_kw(name), device='cpu',
                             dtype=torch.float64)
    world._state = interop.sw_state_from_numpy(state, 'cpu', torch.float64)
    sh = phalo.ShardedShallowWater(world, make(('x',), (RANKS,)))
    assert sh.use_kernel == (SW_CASES[name][0] == 'kernel')
    sh.run(nt=SW_STEPS)
    st = world.state
    out = dict(h=st.h, u=st.u, v=st.v, t=st.t, dt=st.dt, ok=st.ok)
    if sh.use_kernel:
        out['max2'] = torch.stack(sh.max2)
    return out


def rg_tp(make):
    """The band-sharded net flux of the column's initial T, 10 bands a
    shard."""
    pg = gas('f64')
    tau, ba, F, delta, _, _ = pens.real_gas_ensemble(pg, F_scales=[1.0])[3]
    cache = prg.precompute_transmission(tau, ba)
    mesh = make(('x',), (RANKS,))
    bas, caches, Fs, deltas = pe.shard_bands(mesh, 'x', ba, cache, F, delta)
    T = torch.tensor(np.asarray(pg.T[:, 0]), dtype=torch.float64)[None, :,
                                                                   None]
    T_g = torch.tensor([float(pg.T_g)], dtype=torch.float64)
    net, diff = pe.real_gas_net_fn_band_sharded(
        mesh, 'x', [T_g] * len(bas), caches, bas, Fs, deltas)(T)
    return dict(net=net, diff=diff)


def rg_members(n):
    return pens.real_gas_ensemble(gas('f64'),
                                  F_scales=np.linspace(0.95, 1.05, n))


def rg_dp(make):
    sp, scp, tgp, ap = rg_members(16)
    st, info = pe.real_gas_evolve_ensemble_sharded(
        make(('data', 'x'), (2, RANKS // 2)), sp, scp, tgp, *ap, 1e-1,
        member_axis=('data', 'x'), max_steps=30)
    return dict(T=st.T, info=_info(info))


def rg_dp_tp(make):
    sp, scp, tgp, ap = rg_members(4)
    st, info = pe.real_gas_evolve_ensemble_sharded(
        make(('data', 'x'), (2, RANKS // 2)), sp, scp, tgp, *ap, 1e-1,
        band_axis='x', max_steps=30)
    return dict(T=st.T, info=_info(info))


def sw_dp_sp(make, state):
    """dp x sp on ('data', 'x') = 2 x 2: one step of 4 copies of the world
    from ``state`` (``step``), and 6 steps of 8 members that differ (h
    scaled by 1 + k / 100, a uniform u of 2k m/s: each its own dt)."""
    mesh = make(('data', 'x'), (2, RANKS // 2))
    base = psw.ShallowWater(**dp_sp_kw(), device='cpu', dtype=torch.float64)
    base._state = interop.sw_state_from_numpy(state, 'cpu', torch.float64)
    st = base.state
    fields = [f.expand(4, -1, -1) for f in (st.h, st.u, st.v)]
    one = phalo.ShardedShallowWaterEnsemble(base, mesh, *fields).run(1)
    h, u, v = (torch.stack(f) for f in zip(*(
        psw.apply_boundary_conditions(st.h * (1 + 0.01 * k), st.u + 2.0 * k,
                                      st.v, 'walls', 'walls')
        for k in range(8))))
    got = phalo.ShardedShallowWaterEnsemble(base, mesh, h, u, v).run(6)
    names = ('h', 'u', 'v', 't', 'dt', 'ok')
    return dict(step=dict(zip(names, one)), members=dict(zip(names, got)))


def sw_2d(make, state):
    """The 2-D decomposition on (x, y) = 2 x 2, periodic x, El Nino wind."""
    world = psw.ShallowWater(**el_nino(34, 26, 'periodic', 'walls'),
                             device='cpu', dtype=torch.float64)
    world._state = interop.sw_state_from_numpy(state, 'cpu', torch.float64)
    phalo.ShardedShallowWater2D(world, make(('x', 'y'), (2, 2))).run(nt=20)
    st = world.state
    return dict(h=st.h, u=st.u, v=st.v, t=st.t, dt=st.dt)


def scan_inputs():
    rng = np.random.default_rng(3)
    T = 200.0 + 100.0 * rng.random((48, 6))
    dtau = 0.2 * rng.random((48, 6))
    toa = rng.uniform(200.0, 300.0, (6,))
    return T, dtau, toa


def level_scan(make):
    """The level-sharded flux on 'lev' = 4, and dp x pp on 2 x 2."""
    T, dtau, toa = (torch.tensor(x) for x in scan_inputs())
    up, down = pls.lw_flux_level_sharded(T, dtau, toa,
                                         make(('lev',), (RANKS,)), 'lev')
    up2, down2 = pls.lw_flux_level_sharded(
        T, dtau, toa, make(('data', 'lev'), (2, 2)), 'lev',
        batch_axis_name='data')
    return dict(up=up, down=down, up_dp=up2, down_dp=down2)


def collectives(make):
    """The collectives' unit cases, every result as the first local
    shard's (on a process mesh the rank's own): psum's order, pmax with a
    NaN, ppermute with and without ``out``, axis_index on 2 x 2."""
    mesh = make(('x',), (RANKS,))
    own = mesh.local_shards
    k = lambda xs: [xs[i] for i in own]                        # noqa: E731
    vals = k([torch.tensor(v, dtype=torch.float64)
              for v in (1e16, 1.0, 1.0, -1e16)])
    nan = k([torch.tensor([float(i), float('nan') if i == 2 else 0.0])
             for i in range(RANKS)])
    rows = k([torch.full((2, 3), float(i)) for i in range(RANKS)])
    bufs = k([torch.full((3, 4), -1.0) for _ in range(RANKS)])
    col.ppermute(mesh, 'x', rows, [(i, (i + 1) % RANKS)
                                   for i in range(RANKS)],
                 out=[b[:2, 1:] for b in bufs])
    m2 = make(('a', 'b'), (2, 2))
    own2 = m2.local_shards
    xs2 = [torch.tensor([float(i)]) for i in range(4)]
    return dict(
        psum=torch.stack(col.psum(mesh, 'x', vals)),
        pmax=torch.stack(col.pmax(mesh, 'x', nan)),
        ppermute=torch.stack(col.ppermute(mesh, 'x', rows, [(0, 1), (1, 2)])),
        ppermute_out=torch.stack(bufs),
        axis_index=np.asarray([col.axis_index(m2, 'a'),
                               col.axis_index(m2, 'b')]),
        psum_2x2=torch.stack(col.psum(m2, 'a', [xs2[i] for i in own2])),
        pmax_2x2=torch.stack(col.pmax(m2, 'b', [xs2[i] for i in own2])))


def cases(states):
    """Every case's name and its function of ``make``, in run order."""
    out = {'collectives': collectives,
           'grey_dp_f64': lambda make: grey_dp(make, 'f64'),
           'grey_dp_f32': lambda make: grey_dp(make, 'f32'),
           'grey_robust_f32': grey_robust,
           'conv_reference': lambda make: conv_dp(make, 'reference'),
           'conv_isotonic': lambda make: conv_dp(make, 'isotonic')}
    for name in SW_CASES:
        out[name] = (lambda n: lambda make: sharded_sw(make, n, states[n]))(
            name)
    out.update(rg_tp=rg_tp, rg_dp=rg_dp, rg_dp_tp=rg_dp_tp,
               sw_dp_sp=lambda make: sw_dp_sp(make, states['sw_dp_sp']),
               sw_2d=lambda make: sw_2d(make, states['sw_2d']),
               level_scan=level_scan)
    return out


def single_controller(axis_names, shape):
    return pmesh.make_mesh(axis_names, shape=shape,
                           devices=[torch.device('cpu')] * int(np.prod(shape)))


def all_cases(mesh, states, names=None):
    """The rank function: every case (or those of ``names``) on process
    meshes over ``mesh``'s group, with the rank's index of each in
    ``'local_shards'``."""
    def make(axis_names, shape):
        return pmesh.ProcessMesh(axis_names, shape, device=mesh.device)
    run = cases(states)
    return {name: run[name](make) for name in (names or run)}


def raises(mesh):
    """A rank function whose rank 1 raises."""
    if mesh.rank == 1:
        raise ValueError('rank 1 fails on purpose')
    return {}


def hangs(mesh):
    """A rank function whose rank 1 never returns."""
    import time
    if mesh.rank == 1:
        time.sleep(3600)
    return {}
