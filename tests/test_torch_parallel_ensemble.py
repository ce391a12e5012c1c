"""Port vs JAX: the member- and band-sharded compositions
(``climatemodel_tpu_torch/parallel/ensemble.py`` and the dp x sp step of
``parallel/halo.py``).

JAX runs each composition on the 8 virtual CPU devices of
``tests/conftest.py``: the member axis of ``models/ensemble.py``'s inputs
on a ``NamedSharding`` (dp), the real-gas band arrays on one (tp), or the
per-shard shallow-water body vmapped over the local members inside
``shard_map`` (dp x sp).  The port runs the same inputs on a CPU mesh of
eight shards, ``('data', 'x')`` = 2 x 4.  The worlds are small (grey nz 24,
2 x 8 members, max_steps 20; real gas single_line, nz 20, 40 bands,
max_steps 30; shallow water 18 x 10), in f32 and f64.

Bounds, relative to the largest |value|: the port's composition against
JAX's within 1e-5 (f32) / 1e-10 (f64), and for the real-gas dp x tp march
1e-4 / 1e-9; a dp march first needs 90% of its members to stop at JAX's
step, and is compared on those.  The f32 marches with a convective or a
real-gas step already part from JAX's by more than that unsharded (a
level's rounding crosses conv_thresh; the real-gas tendency is a
difference of ~1e2 W/m^2 band fluxes): there the sharded pair may differ by
the unsharded pair's gap plus the bound, so the sharding adds at most the
bound.  Against the unsharded port: the grey
radiative march, the isotonic convective march and the dp x sp step
bit-equal; the reference convective march and the real-gas marches within
the bounds above (PyTorch's row sum ``(w * T).sum(dim=1)`` in the
reference adjustment, and the batched matmul of the real-gas flux, round by
the number of rows: a shard of 2 members is not added up as a batch of
16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from climatemodel_tpu.constants import Omega, R_earth, p_surface_earth
from climatemodel_tpu.models import ensemble as jens
from climatemodel_tpu.models import real_gas as jrg
from climatemodel_tpu.models import shallow_water as jsw
from climatemodel_tpu.models.grey import GreyGas as JGreyGas
from climatemodel_tpu.parallel import halo as jhalo
from climatemodel_tpu.spectral import humidity as jhum
from climatemodel_tpu_torch.models import column as pcol
from climatemodel_tpu_torch.models import ensemble as pens
from climatemodel_tpu_torch.models import real_gas as prg
from climatemodel_tpu_torch.models import shallow_water as psw
from climatemodel_tpu_torch.models.grey import GreyGas as PGreyGas
from climatemodel_tpu_torch.parallel import collectives as pcolls
from climatemodel_tpu_torch.parallel import ensemble as pe
from climatemodel_tpu_torch.parallel import halo as phalo
from climatemodel_tpu_torch.parallel import mesh as pmesh
from climatemodel_tpu_torch.spectral import humidity as phum
from climatemodel_tpu_torch.utils import interop

try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

CPU = torch.device('cpu')
DTYPES = {'f64': (jnp.float64, torch.float64),
          'f32': (jnp.float32, torch.float32)}
TOL = {'f32': 1e-5, 'f64': 1e-10}
TOL_DP_TP = {'f32': 1e-4, 'f64': 1e-9}
GREY = dict(nz=24, ny=1, tau_lw_func='scale_height',
            tau_lw_func_args=[0.22 * p_surface_earth, 4.0])
F_GREY = np.linspace(900.0, 1500.0, 16)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_mesh():
    return JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ('data', 'x'))


def port_mesh(shape=(2, 4)):
    return pmesh.make_mesh(('data', 'x'), shape=shape, devices=[CPU] * 8)


def on_axis(mesh, axis):
    """Put the leading axis of every leaf of a tree on ``axis``."""
    def put(x):
        x = jnp.asarray(x)
        return jax.device_put(x, NamedSharding(
            mesh, P(*((axis,) + (None,) * (x.ndim - 1)))))
    return lambda tree: jax.tree_util.tree_map(put, tree)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def steps_then_values(steps, T, want_steps, want_T, tol):
    """The multi-chip dry run's check of a dp march: >= 90% of the members stop at the
    reference's step, and those members' T agree within ``tol``."""
    same = np.asarray(steps) == np.asarray(want_steps)
    assert same.mean() >= 0.9, same.mean()
    err = rel(np.asarray(T)[same], np.asarray(want_T)[same])
    assert err < tol, err
    return same.mean(), err


def jax_bound(dtype, tol, port_1, jax_1):
    """The bound of the port's composition against JAX's: ``tol`` in f64;
    in f32 the unsharded pair's gap (on the members of ``(steps, T)`` that
    stop at the same step) plus ``tol``."""
    if dtype == 'f64':
        return tol
    same = np.asarray(port_1[0]) == np.asarray(jax_1[0])
    return rel(np.asarray(port_1[1])[same], np.asarray(jax_1[1])[same]) + tol


def equal_info(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# --------------------------------------------------------------------------
# grey dp
# --------------------------------------------------------------------------

def grey_inputs(dtype):
    jd, pd = DTYPES[dtype]
    jw = JGreyGas(dtype=jd, **GREY)
    pw = PGreyGas(dtype=pd, device='cpu', **GREY)
    return jens.grey_ensemble(jw, F_GREY), pens.grey_ensemble(pw, F_GREY)


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
def test_grey_dp_matches_jax_and_the_unsharded_port(dtype):
    """Members on the whole mesh (JAX: P(('data', 'x'))): the port's march
    against JAX's within the dry run's bound, and bit-equal to the unsharded
    port's march in T, t and every EquilibriumInfo field; K3's plain twin
    runs once per shard and iteration (``iterations``)."""
    (sj, fj, pij, pcj), (sp, fp, pip, pcp) = grey_inputs(dtype)
    dist = on_axis(jax_mesh(), ('data', 'x'))
    oj, ij = jens.grey_evolve_ensemble(dist(sj), dist(fj), pij, pcj,
                                       jnp.asarray(1e-2, sj.T.dtype),
                                       max_steps=20)
    tel = {}
    op, ip = pe.grey_evolve_ensemble_sharded(
        port_mesh(), sp, fp, pip, pcp, 1e-2, axis_name=('data', 'x'),
        telemetry=tel, max_steps=20)
    steps_then_values(ip.steps.numpy(), op.T.numpy(), np.asarray(ij.steps),
                      np.asarray(oj.T), TOL[dtype])
    ref, ri = pens.grey_evolve_ensemble(sp, fp, pip, pcp, 1e-2,
                                        max_steps=20)
    assert torch.equal(op.T, ref.T) and torch.equal(op.t, ref.t)
    assert equal_info(ip, ri)
    assert len(tel['iterations']) == 8
    assert all(i >= 20 for i in tel['iterations'])


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
def test_grey_dp_convective_matches_jax(dtype):
    """The radiative-convective march, the faithful adjustment ('reference',
    12 steps), on every member: within the bound of the unsharded port and
    of JAX's composition (f64 measured 1.0e-14 and 1.5e-14; in f32 the
    sharded march is the unsharded one bit for bit, and both differ from
    JAX's by 8.2e-5)."""
    (sj, fj, pij, pcj), (sp, fp, pip, pcp) = grey_inputs(dtype)
    kw = dict(convective_adjust=True, conv_method='reference', max_steps=12)
    ft = jnp.asarray(1e-2, sj.T.dtype)
    dist = on_axis(jax_mesh(), ('data', 'x'))
    oj, _ = jens.grey_evolve_ensemble(dist(sj), dist(fj), pij, pcj, ft, **kw)
    mesh = pmesh.make_mesh(('data',), devices=[CPU] * 8)
    op, _ = pe.grey_evolve_ensemble_sharded(mesh, sp, fp, pip, pcp, 1e-2,
                                            **kw)
    ref, ri = pens.grey_evolve_ensemble(sp, fp, pip, pcp, 1e-2, **kw)
    assert rel(op.T, ref.T) < TOL[dtype]
    oj1, ij1 = jens.grey_evolve_ensemble(sj, fj, pij, pcj, ft, **kw)
    assert rel(op.T, oj.T) < jax_bound(dtype, TOL[dtype],
                                       (ri.steps, ref.T), (ij1.steps, oj1.T))


@pytest.mark.parametrize('kw', [
    dict(convective_adjust=True, conv_method='isotonic', max_steps=12),
    dict(check_every=4, max_steps=40),
    dict(check_every=4, dip_memory=True, max_steps=40),
    dict(fused_stats=False, max_steps=20),
], ids=['isotonic', 'check_every', 'dip_memory', 'split_stats'])
def test_grey_dp_options_bit_equal_to_the_unsharded_port(kw):
    """The march options under a member sharding (f64, 'data' = 8): the
    isotonic convective march, check_every chunks, dip_memory and the
    unfused step each end bit-equal to the unsharded port's march."""
    _, (sp, fp, pip, pcp) = grey_inputs('f64')
    mesh = pmesh.make_mesh(('data',), devices=[CPU] * 8)
    op, ip = pe.grey_evolve_ensemble_sharded(mesh, sp, fp, pip, pcp, 1e-2,
                                             **kw)
    ref, ri = pens.grey_evolve_ensemble(sp, fp, pip, pcp, 1e-2, **kw)
    assert torch.equal(op.T, ref.T) and equal_info(ip, ri)


def test_grey_dp_robust_finish_remaps_members():
    """The robust march in f32 on 'data' = 4: every member the unsharded
    f64 finish completes, the sharded one completes too, each shard on its
    own members, with global indices; states and info bit-equal."""
    _, (sp, fp, pip, pcp) = grey_inputs('f32')
    mesh = pmesh.make_mesh(('data',), devices=[CPU] * 4)
    tel = {}
    got = pe.grey_evolve_ensemble_robust_sharded(
        mesh, sp, fp, pip, pcp, 1e-3, max_steps=50, telemetry=tel)
    want = pens.grey_evolve_ensemble_robust(sp, fp, pip, pcp, 1e-3,
                                            max_steps=50)
    assert len(want[2]) > 4
    np.testing.assert_array_equal(got[2], want[2])
    assert sum(tel['finished']) == len(want[2])
    assert torch.equal(got[0].T, want[0].T) and equal_info(got[1], want[1])


# --------------------------------------------------------------------------
# real gas: tp, dp, dp x tp
# --------------------------------------------------------------------------

def gases(dtype):
    jd, pd = DTYPES[dtype]
    kw = dict(nz=20, ny=1, molecule_names=['single_line'], T_g=260.0,
              q_funcs_args={'single_line': ()}, n_nu_bands=40,
              delta_temp_change=0.1)
    return (jrg.RealGas(dtype=jd, q_funcs={'single_line': jhum.co2}, **kw),
            prg.RealGas(dtype=pd, device='cpu',
                        q_funcs={'single_line': phum.co2}, **kw))


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
def test_real_gas_tp_net_flux_matches_jax(dtype):
    """Bands on 8 shards (40 bands: 5 a shard, three of them without a
    long-wave band): the psum of the shards' partial net fluxes against
    JAX's net flux with its band arrays on P(('data', 'x')), and against
    the unsharded port's band sum, within the dry run's bound."""
    jg, pg = gases(dtype)
    ba = jg.band_arrays
    T_col = jnp.asarray(jg.T[:, 0], jg.dtype)
    T_g = jnp.asarray(jg.T_g, jg.dtype)
    tau = jnp.asarray(jg.tau_interface, jg.dtype)
    delta = jnp.asarray(jg.nu_bands['delta'], jg.dtype)
    spec = on_axis(jax_mesh(), ('data', 'x'))
    ba_s = ba.replace(idx=spec(ba.idx), w=spec(ba.w), delta=spec(ba.delta),
                      centre=spec(ba.centre))
    want = jrg._net_flux(T_col, T_g, tau, ba_s, spec(jg._F_star_factor),
                         spec(delta))
    tau_p, ba_p, F_p, delta_p, _, _ = pens.real_gas_ensemble(
        pg, F_scales=[1.0])[3]
    cache = prg.precompute_transmission(tau_p, ba_p)
    mesh = pmesh.make_mesh(('x',), devices=[CPU] * 8)
    bas, caches, Fs, deltas = pe.shard_bands(mesh, 'x', ba_p, cache, F_p,
                                             delta_p)
    assert [int(b.lw_list.numel()) for b in bas][-3:] == [0, 0, 0]
    T = torch.tensor(np.asarray(T_col))[None, :, None]
    T_gs = [torch.tensor([float(T_g)], dtype=T.dtype)] * 8
    net, diff = pe.real_gas_net_fn_band_sharded(mesh, 'x', T_gs, caches, bas,
                                                Fs, deltas)(T)
    assert rel(net[0, :, 0], want) < TOL[dtype]
    n1, d1 = prg.real_gas_net_and_diff_cached(T[..., 0], T_gs[0], cache,
                                              ba_p, F_p, delta_p)
    assert rel(net[..., 0], n1) < TOL[dtype]
    assert rel(diff[..., 0], d1) < TOL[dtype]


def rg_members(jg, pg, n):
    scales = np.linspace(0.95, 1.05, n)
    return (jens.real_gas_ensemble(jg, F_scales=scales),
            pens.real_gas_ensemble(pg, F_scales=scales))


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
def test_real_gas_dp_matches_jax(dtype):
    """16 members on the whole mesh, the shared cache replicated: within
    the bound of JAX's composition and of the unsharded port (the same
    steps for every member; f32 measured bit-equal to the unsharded port,
    both 1.5e-4 from JAX's marches)."""
    jg, pg = gases(dtype)
    (sj, scj, tgj, aj), (sp, scp, tgp, ap) = rg_members(jg, pg, 16)
    ft = jnp.asarray(1e-1, jg.dtype)
    dist = on_axis(jax_mesh(), ('data', 'x'))
    oj, ij = jens.real_gas_evolve_ensemble(
        dist(sj), dist(scj), dist(tgj), *aj, ft, max_steps=30)
    op, ip = pe.real_gas_evolve_ensemble_sharded(
        port_mesh(), sp, scp, tgp, *ap, 1e-1, member_axis=('data', 'x'),
        max_steps=30)
    ref, ri = pens.real_gas_evolve_ensemble(sp, scp, tgp, *ap, 1e-1,
                                            max_steps=30)
    oj1, ij1 = jens.real_gas_evolve_ensemble(sj, scj, tgj, *aj, ft,
                                             max_steps=30)
    steps_then_values(ip.steps.numpy(), op.T.numpy(), np.asarray(ij.steps),
                      np.asarray(oj.T), jax_bound(
                          dtype, TOL[dtype], (ri.steps, ref.T),
                          (ij1.steps, oj1.T)))
    assert torch.equal(ip.steps, ri.steps)
    assert rel(op.T, ref.T) < TOL[dtype]


def test_real_gas_dp_stacked_tau_folds_per_shard():
    """stacked_tau (one composition per member): each shard folds its own
    members' caches; the march within the f64 bound of the unsharded
    port's."""
    _, pg = gases('f64')
    sp, scp, tgp, ap = pens.real_gas_ensemble(
        pg, F_scales=np.linspace(0.95, 1.05, 8))
    taus = torch.stack([ap[0] * s for s in np.linspace(0.9, 1.1, 8)])
    args = (taus,) + ap[1:]
    mesh = pmesh.make_mesh(('data',), devices=[CPU] * 4)
    op, ip = pe.real_gas_evolve_ensemble_sharded(
        mesh, sp, scp, tgp, *args, 1e-1, stacked_tau=True, max_steps=30)
    ref, ri = pens.real_gas_evolve_ensemble(sp, scp, tgp, *args, 1e-1,
                                            stacked_tau=True, max_steps=30)
    assert torch.equal(ip.steps, ri.steps)
    assert rel(op.T, ref.T) < TOL['f64']


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
@pytest.mark.parametrize('shape', [(2, 4), (4, 2)], ids=['2x4', '4x2'])
def test_real_gas_dp_x_tp_matches_jax(dtype, shape):
    """Members on 'data' and bands on 'x': each data row marches once with
    its band sum psum'd over 'x'.  Against JAX's composition (members on
    P('data'), bands on P('x')) within 1e-4 / 1e-9 on the step-matched
    members (f32: plus the unsharded pair's gap), and the unsharded port
    within the same bound."""
    jg, pg = gases(dtype)
    n = 2 * shape[0]
    (sj, scj, tgj, aj), (sp, scp, tgp, ap) = rg_members(jg, pg, n)
    jmesh = JMesh(np.asarray(jax.devices()[:8]).reshape(shape),
                  ('data', 'x'))
    band, dp = on_axis(jmesh, 'x'), on_axis(jmesh, 'data')
    tau_i, ba0, F0, d0, p_i, p_c = aj
    ba = ba0.replace(idx=band(ba0.idx), w=band(ba0.w), delta=band(ba0.delta),
                     centre=band(ba0.centre))
    ft = jnp.asarray(1e-1, jg.dtype)
    oj, ij = jens.real_gas_evolve_ensemble(
        dp(sj), dp(scj), dp(tgj), tau_i, ba, band(F0), band(d0), p_i, p_c,
        ft, max_steps=30)
    tel = {}
    op, ip = pe.real_gas_evolve_ensemble_sharded(
        port_mesh(shape), sp, scp, tgp, *ap, 1e-1, band_axis='x',
        telemetry=tel, max_steps=30)
    assert len(tel['iterations']) == shape[0]
    ref, ri = pens.real_gas_evolve_ensemble(sp, scp, tgp, *ap, 1e-1,
                                            max_steps=30)
    oj1, ij1 = jens.real_gas_evolve_ensemble(sj, scj, tgj, *aj, ft,
                                             max_steps=30)
    steps_then_values(ip.steps.numpy(), op.T.numpy(), np.asarray(ij.steps),
                      np.asarray(oj.T), jax_bound(
                          dtype, TOL_DP_TP[dtype], (ri.steps, ref.T),
                          (ij1.steps, oj1.T)))
    steps_then_values(ip.steps.numpy(), op.T.numpy(), ri.steps.numpy(),
                      ref.T.numpy(), TOL_DP_TP[dtype])


# --------------------------------------------------------------------------
# shallow water dp x sp
# --------------------------------------------------------------------------

def sw_kw(nx, ny=10, wind='forced'):
    """The El Nino world of the JAX package's multi-chip dry run."""
    h_mean, g_use = 100.0, 0.05
    c = np.sqrt(g_use * h_mean)
    beta = 2 * Omega / R_earth
    L_def = np.sqrt(c / beta)
    dx = L_def / 2
    return dict(nx=nx, ny=ny, dx=dx, dy=dx, dt=0.05 * dx / c, f_0=0.0,
                beta=beta, r=1 / (10 * 30 * 24 * 3600), g=g_use,
                numerical_solver='richtmyer',
                boundary_type={'x': 'walls', 'y': 'walls'},
                initial_info={'type': 'el_nino', 'max_h_surface': 110.0,
                              'min_h_surface': 90.0, 'y_std': L_def,
                              'add_noise': False, 'wind': {'type': wind}})


def port_sw(kw, jworld, dtype):
    world = psw.ShallowWater(**kw, device='cpu', dtype=dtype)
    world._state = interop.sw_state_from_numpy(jax.device_get(jworld.state),
                                               'cpu', dtype)
    return world


def jax_dp_sp_step(world, mesh, batch):
    """One step of JAX's batched composition: the per-shard body vmapped
    over the local members inside shard_map, members on 'data' and x on
    'x' (the JAX package's multi-chip dry run, step for step)."""
    d = world.dtype
    st = world.state
    h = jnp.broadcast_to(st.h[None, 1:-1], (batch,) + st.h[1:-1].shape)
    u = jnp.broadcast_to(st.u[None, 1:-1], h.shape)
    v = jnp.broadcast_to(st.v[None, 1:-1], h.shape)
    t, dt0, dtp, g_, hm, dx, dy = (jnp.asarray(x, d) for x in (
        0.0, world.dt_0, world.dt_0, world.g, world.h_mean, world.dx,
        world.dy))
    helper = jhalo.ShardedShallowWater(world, mesh, axis_name='x')
    body = jhalo.make_sharded_step(mesh, 'x', solver='richtmyer',
                                   linear=False, bx='walls', by='walls',
                                   wind_type='forced', target_courant=0.1)
    s3, rep = P('data', 'x', None), P()
    in_specs = (s3, s3, s3, rep, rep, rep, P('x', None, None),
                P('x', None, None), P('x', None), rep, rep, rep, rep, rep,
                rep, rep, P('x', None), P('x', None))
    out_specs = (s3, s3, s3, P('data'), P('data'), P('data'))

    def step(h, u, v, t, dt0, dtp, f_cor_pad, h_base_pad, r_int, g,
             h_mean, dx, dy, gamma, tau0, fluct, east_w, west_w):
        f_cor_pad, h_base_pad = f_cor_pad[0], h_base_pad[0]

        def one(h1, u1, v1):
            return body(h1, u1, v1, t, dt0, dtp, f_cor_pad, h_base_pad,
                        r_int, g, h_mean, dx, dy, gamma, tau0, fluct,
                        east_w, west_w)
        return jax.vmap(one)(h, u, v)

    fn = shard_map(step, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    return jax.jit(fn)(h, u, v, t, dt0, dtp, helper.f_cor_pad,
                       helper.h_base_pad, helper.r_int, g_, hm, dx, dy,
                       helper.wind_gamma, helper.wind_tau0,
                       helper.wind_fluct, helper.east_w, helper.west_w)


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
def test_sw_dp_sp_step_matches_jax(dtype):
    """4 members of the 18 x 10 world (nx = 4 x-shards * 4 + 2) on
    ('data', 'x') = 2 x 4, one step: h, u, v within the dry run's bound of
    JAX's batched composition, and t, dt, ok per member equal."""
    jd, pd = DTYPES[dtype]
    kw = sw_kw(nx=4 * 4 + 2)
    jworld = jsw.ShallowWater(**kw, dtype=jd)
    want = jax_dp_sp_step(jworld, jax_mesh(), 4)
    pworld = port_sw(kw, jworld, pd)
    st = pworld.state
    fields = [f.expand(4, -1, -1) for f in (st.h, st.u, st.v)]
    ens = phalo.ShardedShallowWaterEnsemble(pworld, port_mesh(), *fields)
    got = ens.run(1)
    for g, w in zip(got[:3], want[:3]):
        assert rel(g[:, 1:-1], w) < TOL[dtype]
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize('wind', ['forced', None], ids=['el_nino', 'no_wind'])
def test_sw_dp_sp_members_bit_equal(wind):
    """Members that differ (h scaled by 1 + k / 100, a uniform u of 2k
    m/s, so each has its own CFL dt; the walls' ghost cells set), 6 steps
    on 2 x 4 and on 4 x 2: each member bit-equal to ``ShardedShallowWater``
    on its data row (its own dt, ok and wind sums), and to the unsharded
    port's run (El Nino: within 1e-12, its masked sums added shard by
    shard)."""
    kw = sw_kw(nx=4 * 4 + 2, wind=wind)
    base = psw.ShallowWater(**kw, device='cpu', dtype=torch.float64)
    st = base.state
    h, u, v = (torch.stack(f) for f in zip(*(
        psw.apply_boundary_conditions(st.h * (1 + 0.01 * k), st.u + 2.0 * k,
                                      st.v, 'walls', 'walls')
        for k in range(8))))
    for shape in ((2, 4), (4, 2)):
        mesh = port_mesh(shape)
        got = phalo.ShardedShallowWaterEnsemble(base, mesh, h, u, v).run(6)
        assert len(set(got[4].tolist())) > 1          # dt per member
        for k in range(8):
            row = psw.ShallowWater(**kw, device='cpu', dtype=torch.float64)
            row._state = row.state.replace(h=h[k].clone(), u=u[k].clone())
            one = psw.ShallowWater(**kw, device='cpu', dtype=torch.float64)
            one._state = row.state
            phalo.ShardedShallowWater(
                row, pmesh.make_mesh(('x',), devices=[CPU] * shape[1]),
                use_kernel=False).run(6)
            one.run(nt=6, snapshots=False)
            ref = row.state
            for g, w in zip(got, (ref.h, ref.u, ref.v, ref.t, ref.dt,
                                  ref.ok)):
                assert torch.equal(g[k], w)
            ref = one.state
            for g, w in zip(got, (ref.h, ref.u, ref.v, ref.t, ref.dt)):
                if wind is None:
                    assert torch.equal(g[k], w)
                else:
                    np.testing.assert_allclose(g[k], w, rtol=1e-12,
                                               atol=1e-12)


# --------------------------------------------------------------------------
# splitting, gathering, devices and aliasing
# --------------------------------------------------------------------------

def test_uneven_splits_and_wrong_devices_raise():
    _, (sp, fp, pip, pcp) = grey_inputs('f64')
    with pytest.raises(ValueError, match='not divisible'):
        pcolls.shard_members(pmesh.make_mesh(('data',), devices=[CPU] * 3),
                             'data', sp)
    with pytest.raises(ValueError, match='not divisible'):
        pe.grey_evolve_ensemble_sharded(
            pmesh.make_mesh(('data',), devices=[CPU] * 5), sp, fp, pip, pcp,
            1e-2, max_steps=2)
    with pytest.raises(ValueError, match='blocks for a mesh'):
        pe.grey_evolve_ensemble_sharded(port_mesh(), sp, fp, pip, pcp, 1e-2,
                                        max_steps=2)
    _, pg = gases('f64')
    tau, ba, F, delta, _, _ = pens.real_gas_ensemble(pg, F_scales=[1.0])[3]
    with pytest.raises(ValueError, match='40 bands not divisible'):
        pe.shard_bands(pmesh.make_mesh(('x',), devices=[CPU] * 3), 'x', ba,
                       prg.precompute_transmission(tau, ba), F, delta)
    mesh = pmesh.make_mesh(('data',), devices=[CPU] * 4)
    shards = pcolls.shard_members(mesh, 'data', sp)
    shards[2] = shards[2].map(lambda x: x.to('meta'))
    with pytest.raises(ValueError, match='not on its mesh device'):
        pcolls.gather_members(mesh, 'data', shards)


def test_shards_own_their_storage():
    """On a mesh of one repeated device every shard of a split is a copy of
    its own: writing one shard in place leaves the other shards, the
    source and the gathered result as they were."""
    _, (sp, _, _, _) = grey_inputs('f64')
    mesh = port_mesh()
    src = sp.T.clone()
    shards = pcolls.shard_members(mesh, ('data', 'x'), sp)
    ptrs = {s.T.data_ptr() for s in shards} | {sp.T.data_ptr()}
    assert len(ptrs) == 9
    before = [s.T.clone() for s in shards]
    back = pcolls.gather_members(mesh, ('data', 'x'), shards)
    shards[3].T.add_(1.0)
    shards[3].tsi.removed.fill_(True)
    assert torch.equal(sp.T, src) and torch.equal(back.T, src)
    assert not bool(back.tsi.removed.any())
    for k, (s, b) in enumerate(zip(shards, before)):
        assert torch.equal(s.T, b) == (k != 3)
    # replicas along 'x' (members on 'data' only) are copies too
    rep = pcolls.shard_members(mesh, 'data', sp)
    assert torch.equal(rep[0].T, rep[1].T)
    rep[0].T.zero_()
    assert not bool((rep[1].T == 0).any())


def test_debug_names_the_global_member():
    """A debug march over shards raises for the first failing member by
    its index in the whole ensemble."""
    _, (sp, fp, pip, pcp) = grey_inputs('f64')
    bad = sp.T.clone()
    bad[13, 5] = float('nan')
    mesh = pmesh.make_mesh(('data',), devices=[CPU] * 4)
    with pytest.raises(pcol.MarchDebugError, match='member 13:'):
        pe.grey_evolve_ensemble_sharded(mesh, sp.replace(T=bad), fp, pip,
                                        pcp, 1e-2, max_steps=5, debug=True)
