"""The sharded compositions run SPMD: one gloo rank a shard
(``parallel/launch.run_ranks`` over ``init_process_mesh(device='cpu')``),
each rank driving its own shard, the collectives through
``torch.distributed``.

One module-scoped run of 4 spawned ranks executes every case of
``tests/torch_rank_cases.py`` (grey dp in f64 and f32 and its robust f64
finish, convective dp with each adjustment method, the x-sharded El Nino
world on the kernel path's plain twin and on the plain stencils with walls
and periodic x, with and without wind, real-gas tp, dp and dp x tp, dp x
sp, the 2-D decomposition, the level scan, and the collectives' unit
cases).  Every rank's result is held bit-equal to the same case on the
single-controller mesh of four CPU shards (the ranks gather every result,
so each rank holds all of it), and to the JAX package's composition on 4
of the 8 virtual CPU devices (the same mesh shape) within the bounds that
``tests/test_torch_parallel*.py`` state for the single-controller mesh.
The launcher's faults: a rank that raises, a rank that hangs, and a card
that is not there.
"""
import copy
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from climatemodel_tpu.models import ensemble as jens
from climatemodel_tpu.models import real_gas as jrg
from climatemodel_tpu.models import shallow_water as jsw
from climatemodel_tpu.models.grey import GreyGas as JGreyGas
from climatemodel_tpu.parallel import halo as jhalo
from climatemodel_tpu.parallel import level_scan as jls
from climatemodel_tpu.parallel import mesh as jmesh
from climatemodel_tpu.spectral import humidity as jhum
from climatemodel_tpu_torch.models import ensemble as pens
from climatemodel_tpu_torch.models.grey import GreyGas as PGreyGas
from climatemodel_tpu_torch.parallel import collectives as pcol
from climatemodel_tpu_torch.parallel import launch
from climatemodel_tpu_torch.parallel import mesh as pmesh

import torch_rank_cases as rc
from test_torch_parallel_ensemble import (TOL, TOL_DP_TP, jax_bound,
                                          jax_dp_sp_step, on_axis, rel,
                                          steps_then_values)

CPU = torch.device('cpu')
#: the ranks' start-up (spawn, import, the gloo group) and every case
RANKS_TIMEOUT_S = 300
#: the fault cases' limit: long enough for the ranks to start
FAULT_TIMEOUT_S = 60
HANG_TIMEOUT_S = 10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_state(jworld):
    st = jax.device_get(jworld.state)
    return {k: np.asarray(getattr(st, k)) for k in ('h', 'u', 'v', 't', 'dt',
                                                    'ok')}


def sw_worlds():
    """The JAX worlds of the shallow-water cases, by case name."""
    kws = {name: rc.sw_kw(name) for name in rc.SW_CASES}
    kws['sw_2d'] = rc.el_nino(34, 26, 'periodic', 'walls')
    kws['sw_dp_sp'] = rc.dp_sp_kw()
    return {n: (kw, jsw.ShallowWater(**copy.deepcopy(kw)))
            for n, kw in kws.items()}


@pytest.fixture(scope='module')
def worlds():
    return sw_worlds()


@pytest.fixture(scope='module')
def states(worlds):
    return {n: jax_state(w) for n, (_, w) in worlds.items()}


@pytest.fixture(scope='module')
def ranks(states):
    """Every case on 4 gloo ranks: [(results by case, launch counts)] a
    rank, and the run's wall."""
    t0 = time.perf_counter()
    out = launch.run_ranks(rc.all_cases, rc.RANKS, device='cpu',
                           args=(states,), timeout_s=RANKS_TIMEOUT_S)
    return out, time.perf_counter() - t0


@pytest.fixture(scope='module')
def single(states):
    """Every case on the single-controller mesh of 4 CPU shards."""
    return {name: launch.to_host(fn(rc.single_controller))
            for name, fn in rc.cases(states).items()}


def leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f'{prefix}.{k}')
    else:
        yield prefix, tree


#: per-shard telemetry: a rank holds its own shard's
PER_SHARD = ('iterations', 'max2')


@pytest.mark.parametrize('case', [n for n in rc.cases({}) if n !=
                                  'collectives'])
def test_rank_mode_bit_equal_to_single_controller(case, ranks, single):
    """Each rank's result, gathered over the mesh, equals the
    single-controller run's bit for bit; a rank's per-shard telemetry
    equals that shard's."""
    want = dict(leaves(single[case]))
    for r, (got, _) in enumerate(ranks[0]):
        got = dict(leaves(got[case]))
        assert got.keys() == want.keys()
        for k, w in want.items():
            g = got[k]
            if k.split('.')[-1] in PER_SHARD:
                w = np.asarray(w)[r:r + 1]
            assert np.asarray(g).dtype == np.asarray(w).dtype, (r, k)
            assert np.array_equal(g, w, equal_nan=True), (r, k)


def test_ranks_launch_no_kernel_on_the_cpu(ranks):
    """On the CPU every wrapper takes its plain twin: no rank counts a
    launch.  The run stays inside its limit."""
    out, wall = ranks
    assert len(out) == rc.RANKS
    for _, counts in out:
        assert set(counts) >= {'net_stats_walk', 'iso_fit',
                               'richtmyer_step_bc'}
        assert not any(counts.values()), counts
    assert wall < RANKS_TIMEOUT_S


def test_rank_collectives(ranks):
    """psum adds in index order (((1e16 + 1) + 1) - 1e16 is 0, never 2);
    pmax keeps a NaN that a later rank holds (gloo's own MAX drops it);
    ppermute leaves zeros where nothing arrives, and with ``out`` writes
    through a strided view; axis_index and the reductions on 2 x 2."""
    for r, (got, _) in enumerate(ranks[0]):
        c = got['collectives']
        assert c['psum'].tolist() == [0.0]
        assert c['pmax'][0, 0] == 3.0 and np.isnan(c['pmax'][0, 1])
        want = {1: 0.0, 2: 1.0}.get(r)
        assert (c['ppermute'] == (0.0 if want is None else want)).all()
        buf = c['ppermute_out'][0]
        assert (buf[:2, 1:] == float((r - 1) % rc.RANKS)).all()
        assert (buf[:, 0] == -1.0).all() and (buf[2] == -1.0).all()
        a, b = divmod(r, 2)
        assert c['axis_index'].tolist() == [[a], [b]]
        assert c['psum_2x2'].tolist() == [[float(b + (b + 2))]]
        assert c['pmax_2x2'].tolist() == [[float(2 * a + 1)]]


# --------------------------------------------------------------------------
# against the JAX package's compositions (4 of the 8 virtual devices)
# --------------------------------------------------------------------------

def jax_mesh(names=('data',), shape=(rc.RANKS,)):
    return JMesh(np.asarray(jax.devices()[:rc.RANKS]).reshape(shape), names)


def grey_jax(dtype, **kw):
    jd = {'f64': jnp.float64, 'f32': jnp.float32}[dtype]
    sj, fj, pij, pcj = jens.grey_ensemble(JGreyGas(dtype=jd, **rc.GREY),
                                          rc.F_GREY)
    dist = on_axis(jax_mesh(), 'data')
    return jens.grey_evolve_ensemble(dist(sj), dist(fj), pij, pcj,
                                     jnp.asarray(1e-2, sj.T.dtype), **kw)


def port_unsharded(dtype, **kw):
    pw = PGreyGas(dtype=rc.DTYPES[dtype], device='cpu', **rc.GREY)
    sp, fp, pip, pcp = pens.grey_ensemble(pw, rc.F_GREY)
    return pens.grey_evolve_ensemble(sp, fp, pip, pcp, 1e-2, **kw)


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
def test_grey_dp_ranks_match_jax(dtype, ranks):
    """The dry run's bound: >= 90% of the members stop at JAX's step, and
    those within 1e-5 (f32) / 1e-10 (f64)."""
    oj, ij = grey_jax(dtype, max_steps=20)
    for got, _ in ranks[0]:
        g = got[f'grey_dp_{dtype}']
        steps_then_values(g['info']['steps'], g['T'], np.asarray(ij.steps),
                          np.asarray(oj.T), TOL[dtype])
        assert g['iterations'][0] >= 20


def test_grey_robust_ranks_finish_the_unsharded_members(ranks):
    """The f32 robust march: the members the unsharded port's f64 finish
    completes, by their indices in the whole ensemble, on every rank."""
    pw = PGreyGas(dtype=torch.float32, device='cpu', **rc.GREY)
    sp, fp, pip, pcp = pens.grey_ensemble(pw, rc.F_GREY)
    want = pens.grey_evolve_ensemble_robust(sp, fp, pip, pcp, 1e-3,
                                            max_steps=50)
    assert len(want[2]) > 4
    for got, _ in ranks[0]:
        g = got['grey_robust_f32']
        np.testing.assert_array_equal(g['finished'], want[2])
        assert np.array_equal(g['T'], want[0].T.numpy())


@pytest.mark.parametrize('method', ['reference', 'isotonic'])
def test_conv_dp_ranks_match_jax(method, ranks):
    """f64, 12 steps: within 1e-10 of JAX's composition."""
    kw = dict(convective_adjust=True, conv_method=method, max_steps=12)
    oj, _ = grey_jax('f64', **kw)
    ref, _ = port_unsharded('f64', **kw)
    for got, _ in ranks[0]:
        T = got[f'conv_{method}']['T']
        assert rel(T, oj.T) < TOL['f64']
        assert rel(T, ref.T) < TOL['f64']


@pytest.mark.parametrize('case', list(rc.SW_CASES))
def test_sharded_sw_ranks_match_jax(case, ranks, worlds):
    """30 steps against JAX's ShardedShallowWater on 4 devices (its
    kernel path, interpret mode, where the port's is): El Nino within
    1e-11 on h (the masked sums are added in another order), 1e-12 on u, v;
    wind-free 1e-12 (kernel path 5e-12)."""
    kw, _ = worlds[case]
    jworld = jsw.ShallowWater(**copy.deepcopy(kw))
    jsh = jhalo.ShardedShallowWater(jworld, jmesh.make_mesh(
        ('x',), devices=jax.devices()[:rc.RANKS]))
    path, _, wind = rc.SW_CASES[case]
    assert jsh.use_kernel == (path == 'kernel')
    jsh.run(nt=rc.SW_STEPS)
    h_tol = (dict(rtol=1e-11, atol=1e-11) if wind else
             dict(rtol=1e-12, atol=5e-12 if path == 'kernel' else 1e-12))
    uv_atol = 5e-12 if path == 'kernel' and not wind else 1e-12
    for got, _ in ranks[0]:
        g = got[case]
        np.testing.assert_allclose(g['h'], np.asarray(jworld.h), **h_tol)
        np.testing.assert_allclose(g['u'], np.asarray(jworld.u), atol=uv_atol)
        np.testing.assert_allclose(g['v'], np.asarray(jworld.v), atol=uv_atol)
        assert float(g['t']) == pytest.approx(float(jworld.state.t),
                                              rel=1e-14)
        assert float(g['dt']) == pytest.approx(float(jworld.state.dt),
                                               rel=1e-14)
        assert bool(g['ok']) == bool(jworld.state.ok)


def jax_gas():
    kw = dict(nz=20, ny=1, molecule_names=['single_line'], T_g=260.0,
              q_funcs_args={'single_line': ()}, n_nu_bands=40,
              delta_temp_change=0.1)
    return jrg.RealGas(dtype=jnp.float64, q_funcs={'single_line': jhum.co2},
                       **kw)


def test_rg_tp_ranks_match_jax(ranks):
    """The band-sharded net flux against JAX's with its band arrays on the
    4 devices' 'x': within 1e-10."""
    jg = jax_gas()
    ba = jg.band_arrays
    spec = on_axis(jax_mesh(('x',)), 'x')
    ba_s = ba.replace(idx=spec(ba.idx), w=spec(ba.w), delta=spec(ba.delta),
                      centre=spec(ba.centre))
    want = jrg._net_flux(jnp.asarray(jg.T[:, 0], jg.dtype),
                         jnp.asarray(jg.T_g, jg.dtype),
                         jnp.asarray(jg.tau_interface, jg.dtype), ba_s,
                         spec(jg._F_star_factor),
                         spec(jnp.asarray(jg.nu_bands['delta'], jg.dtype)))
    for got, _ in ranks[0]:
        assert rel(got['rg_tp']['net'][0, :, 0], want) < TOL['f64']


@pytest.mark.parametrize('case', ['rg_dp', 'rg_dp_tp'])
def test_rg_ensemble_ranks_match_jax(case, ranks):
    """dp (16 members on 2 x 2) and dp x tp (4 members on 'data', the
    bands on 'x'): the step-matched members within 1e-10 and 1e-9 of JAX's
    composition on the same mesh shape."""
    jg = jax_gas()
    n = 16 if case == 'rg_dp' else 4
    sj, scj, tgj, aj = jens.real_gas_ensemble(
        jg, F_scales=np.linspace(0.95, 1.05, n))
    jm = jax_mesh(('data', 'x'), (2, 2))
    ft = jnp.asarray(1e-1, jg.dtype)
    if case == 'rg_dp':
        dist = on_axis(jm, ('data', 'x'))
        oj, ij = jens.real_gas_evolve_ensemble(
            dist(sj), dist(scj), dist(tgj), *aj, ft, max_steps=30)
        tol = TOL['f64']
    else:
        band, dp = on_axis(jm, 'x'), on_axis(jm, 'data')
        tau_i, ba0, F0, d0, p_i, p_c = aj
        ba = ba0.replace(idx=band(ba0.idx), w=band(ba0.w),
                         delta=band(ba0.delta), centre=band(ba0.centre))
        oj, ij = jens.real_gas_evolve_ensemble(
            dp(sj), dp(scj), dp(tgj), tau_i, ba, band(F0), band(d0), p_i,
            p_c, ft, max_steps=30)
        tol = TOL_DP_TP['f64']
    for got, _ in ranks[0]:
        g = got[case]
        steps_then_values(g['info']['steps'], g['T'], np.asarray(ij.steps),
                          np.asarray(oj.T), jax_bound('f64', tol, None, None))


def test_sw_dp_sp_ranks_match_jax(ranks, worlds):
    """One step of 4 copies on ('data', 'x') = 2 x 2 against JAX's batched
    composition (the per-shard body vmapped inside shard_map): h, u, v
    within 1e-10, t, dt and ok equal."""
    _, jworld = worlds['sw_dp_sp']
    want = jax_dp_sp_step(jworld, jax_mesh(('data', 'x'), (2, 2)), 4)
    for got, _ in ranks[0]:
        g = got['sw_dp_sp']['step']
        for k, w in zip(('h', 'u', 'v'), want[:3]):
            assert rel(g[k][:, 1:-1], w) < TOL['f64']
        for k, w in zip(('t', 'dt', 'ok'), want[3:]):
            np.testing.assert_array_equal(g[k], np.asarray(w))
        assert len(set(got['sw_dp_sp']['members']['dt'].tolist())) > 1


def test_sw_2d_ranks_match_jax(ranks, worlds):
    """The 2-D decomposition on 2 x 2, El Nino wind, 20 steps: h within
    1e-11, u and v 1e-12 of JAX's."""
    kw, _ = worlds['sw_2d']
    jworld = jsw.ShallowWater(**copy.deepcopy(kw))
    jhalo.ShardedShallowWater2D(jworld, jmesh.make_mesh(
        ('x', 'y'), shape=(2, 2), devices=jax.devices()[:4])).run(nt=20)
    for got, _ in ranks[0]:
        g = got['sw_2d']
        np.testing.assert_allclose(g['h'], np.asarray(jworld.h), rtol=1e-11,
                                   atol=1e-11)
        np.testing.assert_allclose(g['u'], np.asarray(jworld.u), atol=1e-12)
        np.testing.assert_allclose(g['v'], np.asarray(jworld.v), atol=1e-12)
        assert float(g['t']) == pytest.approx(float(jworld.state.t),
                                              rel=1e-14)


def test_level_scan_ranks_match_jax(ranks):
    """The level-sharded fluxes on 'lev' = 4 and dp x pp on 2 x 2 within
    rtol 1e-12 of JAX's."""
    T, dtau, toa = (jnp.asarray(x) for x in rc.scan_inputs())
    want = jls.lw_flux_level_sharded(
        T, dtau, toa, jmesh.make_mesh(('lev',), devices=jax.devices()[:4]),
        'lev')
    want_dp = jls.lw_flux_level_sharded(
        T, dtau, toa, jmesh.make_mesh(('data', 'lev'), shape=(2, 2),
                                      devices=jax.devices()[:4]), 'lev',
        batch_axis_name='data')
    for got, _ in ranks[0]:
        g = got['level_scan']
        for k, w in zip(('up', 'down', 'up_dp', 'down_dp'),
                        (*want, *want_dp)):
            np.testing.assert_allclose(g[k], np.asarray(w), rtol=1e-12)


# --------------------------------------------------------------------------
# the meshes, and the launcher's faults
# --------------------------------------------------------------------------

def test_rank_processes_import_no_jax():
    """What a rank imports (the launcher and the cases) imports with
    ``jax`` and the JAX package blocked."""
    code = ('import sys\n'
            "sys.modules['jax'] = None\n"
            "sys.modules['climatemodel_tpu'] = None\n"
            'import torch_rank_cases\n'
            'import climatemodel_tpu_torch.parallel.launch\n')
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                              [str(root / 'tests'), str(root)])),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_single_controller_mesh_drives_every_shard():
    m = pmesh.make_mesh(('data', 'x'), shape=(2, 2), devices=[CPU] * 4)
    assert m.local_shards == [0, 1, 2, 3]
    assert m.local_devices == [CPU] * 4
    lines = pcol.local_lines(m, 'x')
    assert [line for line, _, _ in lines] == [[0, 1], [2, 3]]
    assert [sub.shape for _, sub, _ in lines] == [{'x': 2}, {'x': 2}]
    assert [own for _, _, own in lines] == [[0, 1], [2, 3]]
    assert pcol.axis_index(m, 'data') == [0, 0, 1, 1]
    assert pcol.axis_index(m, 'x', [3, 0]) == [1, 0]


def test_a_rank_refuses_a_tensor_on_another_card():
    """A process mesh's collectives take only tensors on the rank's own
    card: one on another card, or on the CPU, raises before any message."""
    m = object.__new__(pmesh.ProcessMesh)
    m._init(('x',), np.arange(2), 0, {'x': None}, None,
            torch.device('cuda', 1))

    def on(device):          # only its device is read before the check
        return type('T', (), {'device': torch.device(device)})()
    mine = on('cuda:1')
    assert pcol._own(m, [mine], 'psum') is mine
    for other in ('cuda:0', 'cpu'):
        with pytest.raises(ValueError, match='on a process mesh of cuda:1'):
            pcol.psum(m, 'x', [on(other)])
        with pytest.raises(ValueError, match='on a process mesh of cuda:1'):
            pcol.ppermute(m, 'x', [on(other)], [(0, 1)])


def test_a_rank_that_raises_fails_the_run():
    """The other rank is stopped at once, and no rank outlives the call."""
    before = set(multiprocessing.active_children())
    t0 = time.perf_counter()
    with pytest.raises(launch.RankError, match='rank 1 fails on purpose'):
        launch.run_ranks(rc.raises, 2, device='cpu',
                         timeout_s=FAULT_TIMEOUT_S)
    assert time.perf_counter() - t0 < FAULT_TIMEOUT_S
    assert not set(multiprocessing.active_children()) - before


def test_a_rank_that_hangs_times_out():
    before = set(multiprocessing.active_children())
    t0 = time.perf_counter()
    with pytest.raises(launch.RankError, match='not done after'):
        launch.run_ranks(rc.hangs, 2, device='cpu',
                         timeout_s=HANG_TIMEOUT_S)
    assert time.perf_counter() - t0 < HANG_TIMEOUT_S + 30
    assert not set(multiprocessing.active_children()) - before


def test_no_card_raises(monkeypatch):
    """The default device is the card: without one, the process mesh and
    the launcher raise, and neither falls back to gloo."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pmesh.init_process_mesh(rank=0, world_size=1)
    with pytest.raises(ValueError, match='one rank a card'):
        launch.run_ranks(rc.raises, 2)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match='single-controller mesh'):
        pmesh.init_process_mesh(rank=1, world_size=2)
    with pytest.raises(ValueError, match='single-controller mesh'):
        launch.run_ranks(rc.raises, 2)
