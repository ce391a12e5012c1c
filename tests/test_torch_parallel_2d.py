"""Port vs JAX: the 2-D (x, y) decomposition of the shallow-water world
(``parallel/halo.ShardedShallowWater2D``) on (4, 2) and (2, 4) meshes of the
8 virtual CPU devices against the JAX package's, and against the unsharded
port; F5, the ``richtmyer_pallas`` swap, warns.

float64, the port started from the JAX world's state; bounds as
``tests/test_sharded.py`` holds JAX's 2-D runs to its unsharded ones
(rtol 1e-12 / atol 1e-12, El Nino 1e-11 on h)."""
import jax
import pytest
import torch

from climatemodel_tpu.models import shallow_water as jsw
from climatemodel_tpu.parallel import halo as jhalo
from climatemodel_tpu.parallel import mesh as jmesh
from climatemodel_tpu_torch.models import shallow_water as psw
from climatemodel_tpu_torch.parallel import halo as phalo
from climatemodel_tpu_torch.parallel import mesh as pmesh

from test_torch_parallel import GRAV, assert_close, el_nino, port_world

CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_2d(kw, nt, shape=(4, 2)):
    jworld = jsw.ShallowWater(**kw)
    pworld = port_world(kw, jworld)
    jhalo.ShardedShallowWater2D(jworld, jmesh.make_mesh(
        ('x', 'y'), shape=shape, devices=jax.devices()[:8])).run(nt=nt)
    phalo.ShardedShallowWater2D(pworld, pmesh.make_mesh(
        ('x', 'y'), shape=shape, devices=[CPU] * 8)).run(nt=nt)
    return jworld, pworld


@pytest.mark.parametrize('shape', [(4, 2), (2, 4)])
@pytest.mark.parametrize('bx,by', [('periodic', 'walls'), ('walls', 'walls'),
                                   ('periodic', 'periodic')])
def test_2d_matches_jax(bx, by, shape):
    assert_close(*both_2d(dict(GRAV, nx=34, ny=26,
                               boundary_type={'x': bx, 'y': by}), 30, shape))


@pytest.mark.parametrize('bx,by', [('walls', 'periodic'),
                                   ('periodic', 'periodic'),
                                   ('periodic', 'walls'), ('walls', 'walls')])
def test_2d_maccormack_matches_jax(bx, by):
    """maccormack reads ghost corners: the global periodic-y corner rules
    through the y-ring exchange, the walls-y corners cell by cell."""
    assert_close(*both_2d(dict(GRAV, nx=34, ny=26, numerical_solver=
                               'maccormack', boundary_type={'x': bx,
                                                            'y': by}), 30))


def test_2d_maccormack_periodic_y_2x4_matches_jax():
    """The y ring spans 4 shards: the corner values cross shards that are
    neither source nor destination."""
    assert_close(*both_2d(dict(GRAV, nx=34, ny=26, numerical_solver=
                               'maccormack', boundary_type={
                                   'x': 'periodic', 'y': 'periodic'}), 30,
                          (2, 4)))


@pytest.mark.parametrize('bx,by', [('walls', 'walls'), ('periodic', 'walls'),
                                   ('walls', 'periodic'),
                                   ('periodic', 'periodic')])
def test_2d_el_nino_matches_jax(bx, by):
    """The wind closure's 2-D mask fold (x rows, then y cells, the
    periodic-y corners routed to their sources)."""
    assert_close(*both_2d(el_nino(34, 18, bx, by), 25),
                 dict(rtol=1e-11, atol=1e-11))


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_2d_bit_equal_to_unsharded_port(dtype):
    """Wind-free, the blocks' elementwise steps and the exact max give the
    unsharded port's numbers bit for bit."""
    kw = dict(GRAV, nx=34, ny=26, boundary_type={'x': 'periodic',
                                                 'y': 'walls'})
    world = psw.ShallowWater(**kw, device='cpu', dtype=dtype)
    ref = psw.sw_simulate(world.state, world.params, 30,
                          **world._step_kwargs())
    phalo.ShardedShallowWater2D(world, pmesh.make_mesh(
        ('x', 'y'), shape=(4, 2), devices=[CPU] * 8)).run(nt=30)
    for f in ('h', 'u', 'v', 't', 'dt'):
        assert torch.equal(getattr(world.state, f), getattr(ref, f)), f


def test_f5_richtmyer_pallas_warns_and_matches_jax():
    """F5: JAX's 2-D decomposition swaps richtmyer_pallas for the plain
    richtmyer silently; the port makes the same swap with a UserWarning
    that names it, and gives JAX's numbers."""
    kw = dict(GRAV, nx=34, ny=26, numerical_solver='richtmyer_pallas',
              boundary_type={'x': 'walls', 'y': 'walls'})
    jworld = jsw.ShallowWater(**kw)
    pworld = port_world(kw, jworld)
    mesh = pmesh.make_mesh(('x', 'y'), shape=(4, 2), devices=[CPU] * 8)
    with pytest.warns(UserWarning, match='richtmyer_pallas'):
        sh = phalo.ShardedShallowWater2D(pworld, mesh)
    assert sh.solver == 'richtmyer'
    jhalo.ShardedShallowWater2D(jworld, jmesh.make_mesh(
        ('x', 'y'), shape=(4, 2), devices=jax.devices()[:8])).run(nt=20)
    sh.run(nt=20)
    assert_close(jworld, pworld)


def test_2d_f4_and_shapes():
    """A resumed aborted world does not step (F4), and an interior the
    mesh does not divide is rejected."""
    kw = dict(GRAV, nx=34, ny=26)
    world = psw.ShallowWater(**kw, device='cpu', dtype=torch.float64)
    world._state = world.state.replace(ok=torch.tensor(False))
    h0 = world.state.h.clone()
    mesh = pmesh.make_mesh(('x', 'y'), shape=(4, 2), devices=[CPU] * 8)
    with pytest.raises(ValueError, match='time step very small'):
        phalo.ShardedShallowWater2D(world, mesh).run(nt=4)
    assert torch.equal(world.state.h, h0)
    with pytest.raises(ValueError, match='not divisible'):
        phalo.ShardedShallowWater2D(psw.ShallowWater(**dict(kw, ny=27),
                                                     device='cpu'), mesh)
