"""Port vs JAX: the x-sharded shallow-water world (``parallel/halo.py``,
``ShardedShallowWater``) on the plain stencils and on the fused kernel's
``bx='given'`` mode (K6; its plain twin on the CPU), each against the JAX
package's ``ShardedShallowWater`` on the 8 virtual CPU devices of
``tests/conftest.py``; then the port's kernel path against the unsharded
port, the fallback, and the two JAX faults the port does not copy (F4, F5
in ROADMAP.md).

Both packages run in float64; the port starts from the JAX world's own
state (``utils/interop``).  The bounds are the ones ``tests/test_sharded.py``
holds JAX's sharded runs to against its unsharded ones: rtol 1e-12 /
atol 1e-12 (the kernel path atol 5e-12), El Nino 1e-11 on h (its masked
sums are added in another order).  The port's mesh is eight shards of the
CPU device, ``[cpu] * 8``: every shard on one device, as four shards of one
card run on the H100."""
import copy

import jax
import numpy as np
import pytest
import torch

from climatemodel_tpu.constants import Omega, R_earth
from climatemodel_tpu.models import shallow_water as jsw
from climatemodel_tpu.parallel import halo as jhalo
from climatemodel_tpu.parallel import mesh as jmesh
from climatemodel_tpu_torch.models import shallow_water as psw
from climatemodel_tpu_torch.ops import stencils as pst
from climatemodel_tpu_torch.parallel import halo as phalo
from climatemodel_tpu_torch.parallel import mesh as pmesh
from climatemodel_tpu_torch.utils import interop

CPU = torch.device('cpu')
TIGHT = dict(rtol=1e-12, atol=1e-12)

# tests/test_sharded.py:13-17 and :357-361
GRAV = dict(
    nx=42, ny=30, dx=100e3, dy=100e3, dt=60.0, f_0=1e-4, beta=1.6e-11,
    initial_info={'type': 'height_gaussian', 'min_h_surface': 9750.0,
                  'max_h_surface': 10750.0, 'x0': 0.0, 'y0': 0.0,
                  'x_std': 500e3, 'y_std': 500e3, 'add_noise': False})
KGRAV = dict(GRAV, nx=66, initial_info=dict(GRAV['initial_info'],
                                            x_std=800e3, y_std=800e3))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def jax_mesh(n=8):
    return jmesh.make_mesh(('x',), devices=jax.devices()[:n])


def port_mesh(n=8):
    return pmesh.make_mesh(('x',), devices=[CPU] * n)


def port_world(kw, jworld, dtype=torch.float64):
    """The port's world of ``kw`` on the CPU, started from the JAX world's
    state."""
    world = psw.ShallowWater(**copy.deepcopy(kw), device='cpu', dtype=dtype)
    world._state = interop.sw_state_from_numpy(jax.device_get(jworld.state),
                                               'cpu', dtype)
    return world


def both(kw, nt, n=8, **sharded_kw):
    """Run ``kw``'s world sharded n ways in both packages from JAX's initial
    state; return (JAX world, port world, the port's sharded wrapper)."""
    jworld = jsw.ShallowWater(**copy.deepcopy(kw))
    pworld = port_world(kw, jworld)
    jhalo.ShardedShallowWater(jworld, jax_mesh(n), **sharded_kw).run(nt=nt)
    sh = phalo.ShardedShallowWater(pworld, port_mesh(n), **sharded_kw)
    sh.run(nt=nt)
    return jworld, pworld, sh


def assert_close(jworld, pworld, h_tol=TIGHT, uv_atol=1e-12):
    np.testing.assert_allclose(pworld.h, np.asarray(jworld.h), **h_tol)
    np.testing.assert_allclose(pworld.u, np.asarray(jworld.u), atol=uv_atol)
    np.testing.assert_allclose(pworld.v, np.asarray(jworld.v), atol=uv_atol)
    assert float(pworld.state.t) == pytest.approx(float(jworld.state.t),
                                                  rel=1e-14)
    assert float(pworld.state.dt) == pytest.approx(float(jworld.state.dt),
                                                   rel=1e-14)
    assert bool(pworld.state.ok) == bool(jworld.state.ok)


@pytest.mark.parametrize('bx,by', [('periodic', 'walls'), ('walls', 'walls'),
                                   ('periodic', 'periodic')])
def test_sharded_matches_jax(bx, by):
    jworld, pworld, sh = both(dict(GRAV, boundary_type={'x': bx, 'y': by}),
                              40)
    assert not sh.use_kernel and sh.local_nx == 5
    assert_close(jworld, pworld)


@pytest.mark.parametrize('solver', ['lax_friedrichs', 'lax_wendroff'])
def test_sharded_other_schemes_match_jax(solver):
    jworld, pworld, _ = both(dict(GRAV, numerical_solver=solver,
                                  boundary_type={'x': 'periodic',
                                                 'y': 'walls'}), 20)
    assert_close(jworld, pworld)


@pytest.mark.parametrize('bx', ['walls', 'periodic'])
def test_sharded_maccormack_periodic_y_matches_jax(bx):
    """maccormack reads ghost corners: the periodic-y corner rules (and the
    f[-1,-1] = f[-2,-1] quirk) on the edge shards."""
    jworld, pworld, _ = both(dict(GRAV, boundary_type={'x': bx,
                                                       'y': 'periodic'},
                                  numerical_solver='maccormack'), 40)
    assert_close(jworld, pworld)


@pytest.mark.parametrize('bx,by', [('walls', 'walls'), ('periodic', 'walls'),
                                   ('walls', 'periodic'),
                                   ('periodic', 'periodic')])
def test_sharded_el_nino_matches_jax(bx, by):
    """The forced wind closure's folded ghost-inclusive masks, for every
    boundary pair (periodic y routes the corner weights)."""
    jworld, pworld, _ = both(el_nino(34, 20, bx, by), 30)
    assert_close(jworld, pworld, dict(rtol=1e-11, atol=1e-11))


@pytest.mark.parametrize('wind', ['seasonal', 'seasonal_forced', 'unforced'])
def test_sharded_wind_types_match_jax(wind):
    jworld, pworld, _ = both(el_nino(34, 20, 'walls', 'walls', wind=wind), 30)
    assert_close(jworld, pworld, dict(rtol=1e-11, atol=1e-11))


@pytest.mark.parametrize('bx', ['walls', 'periodic'])
def test_kernel_path_matches_jax_kernel_path(bx):
    """richtmyer_pallas sharded 8 ways: the port's per-shard K6 'given'
    mode (its plain twin here) against JAX's per-shard Pallas frame kernel
    (interpret mode), at test_sharded.py's bound for JAX against its own
    unsharded kernel path."""
    kw = dict(KGRAV, boundary_type={'x': bx, 'y': 'walls'},
              numerical_solver='richtmyer_pallas')
    jworld, pworld, sh = both(kw, 40)
    assert sh.use_kernel and sh.local_nx == 8
    assert_close(jworld, pworld, dict(rtol=1e-12, atol=5e-12), 5e-12)


def test_kernel_path_el_nino_matches_jax_kernel_path():
    kw = el_nino(66, 20, 'walls', 'walls', numerical_solver='richtmyer_pallas')
    jworld, pworld, sh = both(kw, 30)
    assert sh.use_kernel
    assert_close(jworld, pworld, dict(rtol=1e-11, atol=1e-11))


def test_kernel_path_calls_the_given_mode_once_per_shard_and_step(
        monkeypatch):
    calls = []
    real = pst.richtmyer_step_bc

    def spy(*args, **kw):
        calls.append(args[12:14])
        return real(*args, **kw)
    monkeypatch.setattr(pst, 'richtmyer_step_bc', spy)
    kw = dict(KGRAV, boundary_type={'x': 'walls', 'y': 'walls'},
              numerical_solver='richtmyer_pallas')
    world = psw.ShallowWater(**kw, device='cpu', dtype=torch.float64)
    sh = phalo.ShardedShallowWater(world, port_mesh(4))
    sh.run(nt=7)
    assert calls == [('given', 'walls')] * 28
    # the per-shard max2 the run ends with is each shard's own
    for i, m in enumerate(sh.max2):
        rows = slice(1 + i * sh.local_nx, 1 + (i + 1) * sh.local_nx)
        u, v = world.state.u[rows, 1:-1], world.state.v[rows, 1:-1]
        assert bool(m == torch.max(u * u + v * v))


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('case', ['periodic', 'walls', 'mountain'])
def test_kernel_path_bit_equal_to_unsharded_port(case, dtype):
    """The aliasing guard: eight shards of one device, wind-free, bit-equal
    to the unsharded kernel path (``sw_simulate``) in h, u, v, t and dt —
    the halo copies are exact and max is exact.  'mountain' adds the
    orography gradients, cut per shard."""
    bx = 'periodic' if case == 'periodic' else 'walls'
    kw = dict(KGRAV, boundary_type={'x': bx, 'y': 'walls'},
              numerical_solver='richtmyer_pallas')
    if case == 'mountain':
        kw['orography_info'] = {'type': 'mountain', 'max_h_base': 500.0,
                                'x0': 0.0, 'y0': 0.0, 'x_std': 5e5,
                                'y_std': 5e5}
    world = psw.ShallowWater(**kw, device='cpu', dtype=dtype)
    ref = psw.sw_simulate(world.state, world.params, 40,
                          **world._step_kwargs())
    sh = phalo.ShardedShallowWater(world, port_mesh(8))
    assert sh.use_kernel
    sh.run(nt=40)
    for f in ('h', 'u', 'v', 't', 'dt', 'ok'):
        assert torch.equal(getattr(world.state, f), getattr(ref, f)), f


def test_el_nino_kernel_path_close_to_unsharded_port():
    """With the wind closure the masked sums are added shard by shard, not
    as one torch.sum: ulp-close to the unsharded kernel path, not
    bit-equal."""
    kw = el_nino(66, 20, 'walls', 'walls', numerical_solver='richtmyer_pallas')
    world = psw.ShallowWater(**kw, device='cpu', dtype=torch.float64)
    ref = psw.sw_simulate(world.state, world.params, 30,
                          **world._step_kwargs())
    phalo.ShardedShallowWater(world, port_mesh(8)).run(nt=30)
    np.testing.assert_allclose(world.h, ref.h.numpy(), rtol=1e-12)
    np.testing.assert_allclose(world.u, ref.u.numpy(), atol=1e-13)
    assert float(world.state.t) == pytest.approx(float(ref.t), rel=1e-14)


def test_fallback_warns_and_matches_jax():
    """Periodic y cannot shard onto K6: the port warns, runs the plain
    richtmyer stencils and matches JAX's (which falls back on it too);
    use_kernel=True raises."""
    kw = dict(GRAV, boundary_type={'x': 'walls', 'y': 'periodic'},
              numerical_solver='richtmyer_pallas')
    jworld = jsw.ShallowWater(**copy.deepcopy(kw))
    pworld = port_world(kw, jworld)
    with pytest.warns(UserWarning, match='falling back'):
        jsh = jhalo.ShardedShallowWater(jworld, jax_mesh())
    with pytest.warns(UserWarning, match='falling back'):
        sh = phalo.ShardedShallowWater(pworld, port_mesh())
    assert not sh.use_kernel and not jsh.use_kernel
    assert sh.solver == 'richtmyer'
    jsh.run(nt=20)
    sh.run(nt=20)
    assert_close(jworld, pworld)
    with pytest.raises(ValueError, match='use_kernel'):
        phalo.ShardedShallowWater(psw.ShallowWater(**kw, device='cpu'),
                                  port_mesh(), use_kernel=True)


def test_jax_untileable_interior_runs_the_kernel_path_in_the_port():
    """JAX falls back on 40/8 = 5 rows a shard (no multiple-of-8 band, a
    TPU tiling term); the port's kernel takes any shape, so it shards onto
    K6 and matches JAX's plain fallback."""
    kw = dict(GRAV, boundary_type={'x': 'periodic', 'y': 'walls'},
              numerical_solver='richtmyer_pallas')
    jworld = jsw.ShallowWater(**copy.deepcopy(kw))
    pworld = port_world(kw, jworld)
    with pytest.warns(UserWarning, match='falling back'):
        jhalo.ShardedShallowWater(jworld, jax_mesh()).run(nt=20)
    sh = phalo.ShardedShallowWater(pworld, port_mesh())
    assert sh.use_kernel
    sh.run(nt=20)
    assert_close(jworld, pworld, dict(rtol=1e-12, atol=5e-12), 5e-12)


@pytest.mark.parametrize('solver', ['richtmyer', 'richtmyer_pallas'])
def test_f4_resumed_aborted_world_does_not_step(solver):
    """F4: JAX seeds the sharded scan's ok with True, so an aborted world
    resumed sharded steps on.  The port seeds ok from the world's state:
    the fields stay frozen (t and dt advance, as in the unsharded run), and
    run() raises after committing."""
    kw = dict(KGRAV, boundary_type={'x': 'walls', 'y': 'walls'},
              numerical_solver=solver)
    world = psw.ShallowWater(**kw, device='cpu', dtype=torch.float64)
    world._state = psw.sw_simulate(world.state, world.params, 3,
                                   **world._step_kwargs()).replace(
        ok=torch.tensor(False))
    start = world.state
    ref = psw.sw_simulate(start, world.params, 5, **world._step_kwargs())
    with pytest.raises(ValueError, match='time step very small'):
        phalo.ShardedShallowWater(world, port_mesh(4)).run(nt=5)
    for f in ('h', 'u', 'v'):
        assert torch.equal(getattr(world.state, f), getattr(start, f)), f
    assert not bool(world.state.ok)
    assert torch.equal(world.state.t, ref.t)
    assert torch.equal(world.state.dt, ref.dt)


def test_abort_commits_then_raises():
    """A run that reaches dt < 10 s commits the frozen state, then raises,
    as the unsharded run does."""
    kw = dict(GRAV, boundary_type={'x': 'walls', 'y': 'walls'})
    world = psw.ShallowWater(**kw, device='cpu', dtype=torch.float64)
    world.dt_0 = 5.0
    world._state = world.state.replace(dt=torch.tensor(5.0,
                                                       dtype=torch.float64))
    h0 = world.state.h.clone()
    with pytest.raises(ValueError, match='time step very small'):
        phalo.ShardedShallowWater(world, port_mesh(4)).run(nt=3)
    assert not bool(world.state.ok)
    assert torch.equal(world.state.h, h0)
    assert float(world.state.t) == 15.0


def test_shapes_rejected():
    with pytest.raises(ValueError, match='not divisible'):
        phalo.ShardedShallowWater(psw.ShallowWater(**dict(GRAV, nx=25),
                                                   device='cpu'),
                                  port_mesh(8))
    mesh2 = pmesh.make_mesh(('x', 'y'), shape=(4, 2), devices=[CPU] * 8)
    with pytest.raises(ValueError, match='1-D mesh'):
        phalo.ShardedShallowWater(psw.ShallowWater(**GRAV, device='cpu'),
                                  mesh2)
