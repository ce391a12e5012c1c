"""Port vs JAX: the shallow-water engine (``models/shallow_water.py``) —
scenario construction, ``sw_step`` through the fused kernel's interior mode
(K5) and the plain schemes, ``sw_simulate(_snapshots)`` through its
boundary-condition mode (K6, the JAX package's padded-frame path), and
``ShallowWater.run`` end to end.

Both packages run in float64 on the CPU; the JAX Pallas kernels run in
interpret mode.  The port starts from the JAX package's own state and
parameters (``utils/interop``), so both step the same numbers.  The plain
kernel and schemes take the JAX operations in the same order; XLA may fuse
a product and a sum into one multiply-add, so a step agrees to a few ulp
(``STEP``), and the differences grow slowly over a run."""
import copy
import inspect

import jax
import numpy as np
import pytest
import torch

from climatemodel_tpu.constants import Omega, R_earth
from climatemodel_tpu.models import shallow_water as jsw
from climatemodel_tpu_torch.models import column as pcol
from climatemodel_tpu_torch.models import shallow_water as psw
from climatemodel_tpu_torch.utils import interop


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's parallel loops over fields above its grain size (~33k cells,
    the 150 x 75 world) then spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# per step: a few ulp of f64 on h ~ 1e2-1e4 m and u, v ~ 1e-3-1 m/s
STEP = dict(rtol=1e-12, atol=1e-13)

# the El Nino world of tests/test_pallas_stencils.py:128-147 (forced wind,
# mountain orography, walls)
EL_NINO = dict(nx=34, ny=130, dx=100e3, dy=100e3, dt=60.0, f_0=0.0,
               beta=1e-11, r=1e-7, g=0.05,
               orography_info={'type': 'mountain', 'max_h_base': 5.0,
                               'x0': 0.0, 'y0': 0.0, 'x_std': 3e5,
                               'y_std': 3e5},
               boundary_type={'x': 'walls', 'y': 'walls'},
               initial_info={'type': 'el_nino', 'max_h_surface': 110.0,
                             'min_h_surface': 90.0, 'y_std': 4e5,
                             'add_noise': False, 'wind': {'type': 'forced'}})


def gaussian(bx, by, nx=34, ny=130):
    """The height_gaussian world of tests/test_pallas_stencils.py:150-168."""
    return dict(nx=nx, ny=ny, dx=100e3, dy=100e3, dt=60.0, f_0=1e-4,
                beta=0.0, r=0.0, boundary_type={'x': bx, 'y': by},
                initial_info={'type': 'height_gaussian',
                              'min_h_surface': 9750.0,
                              'max_h_surface': 9850.0, 'x0': 0.0, 'y0': 0.0,
                              'x_std': 3e5, 'y_std': 3e5, 'add_noise': False})


GRAV_WAVE = dict(
    nx=40, ny=40, dx=100e3, dy=100e3, dt=60.0, f_0=0.0, beta=0.0,
    initial_info={'type': 'height_gaussian', 'min_h_surface': 9750.0,
                  'max_h_surface': 10750.0, 'x0': 0.0, 'y0': 0.0,
                  'x_std': 800e3, 'y_std': 800e3, 'add_noise': False})


def el_nino_script(nx=150, ny=75):
    """shallow_script.py's El Nino world (the verify recipe) at 150 x 75."""
    h_mean, g_use = 100.0, 0.05
    c = np.sqrt(g_use * h_mean)
    beta = 2 * Omega / R_earth
    L = np.sqrt(c / beta)
    dx = L / 5
    r = 1 / (10 * 30 * 24 * 3600)
    return dict(nx=nx, ny=ny, dx=dx, dy=dx, dt=0.01 * dx / c, f_0=0.0,
                beta=beta, r=r, g=g_use,
                boundary_type={'x': 'walls', 'y': 'walls',
                               'y_walls_damp': {'dist_thresh':
                                                (ny / 2) * dx - 6 * dx,
                                                'r': r * 100}},
                initial_info={'type': 'el_nino', 'max_h_surface': 110.0,
                              'min_h_surface': 90.0, 'y_std': L,
                              'add_noise': False, 'wind': {'type': 'forced'}})


def _pair(kw, solver, **port_kw):
    """(JAX world, port world on the CPU in float64) of one configuration;
    each gets its own copy of the mutable scenario dicts."""
    j = jsw.ShallowWater(**copy.deepcopy(kw), numerical_solver=solver)
    p = psw.ShallowWater(**copy.deepcopy(kw), numerical_solver=solver,
                         device='cpu', dtype=torch.float64, **port_kw)
    return j, p


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_state(p, j, tol=STEP):
    for k in ('h', 'u', 'v'):
        np.testing.assert_allclose(_np(getattr(p, k)), _np(getattr(j, k)),
                                   err_msg=k, **tol)
    np.testing.assert_allclose(float(p.t), float(j.t), rtol=1e-14)
    assert bool(p.ok) == bool(j.ok)


def _from_jax(jw):
    """The JAX world's state and parameters as port dataclasses."""
    state, params = jax.device_get((jw.state, jw.params))
    return (interop.sw_state_from_numpy(state, device='cpu',
                                        dtype=torch.float64),
            interop.sw_params_from_numpy(params, device='cpu',
                                         dtype=torch.float64))


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------

SCENARIOS = {
    'uniform_zonal': ({'type': 'uniform_zonal', 'mean_h_surface': 1000.0,
                       'u_mean': 10.0, 'add_noise': True}, {}),
    'sinusoidal_zonal': ({'type': 'sinusoidal_zonal', 'mean_h_surface':
                          1000.0, 'u_max': 5.0, 'n_periods': 2, 'y0': 0.0,
                          'add_noise': False}, {'f_0': 0.0, 'beta': 1e-11}),
    'jet_zonal': ({'type': 'jet_zonal', 'mean_h_surface': 1000.0,
                   'u_max': 5.0, 'jet_width': 3e5, 'y0': 0.0,
                   'add_noise': False}, {}),
    'height_gaussian': (gaussian('walls', 'walls')['initial_info'], {}),
    'height_step': ({'type': 'height_step', 'min_h_surface': 900.0,
                     'max_h_surface': 1000.0, 'direction': 'x',
                     'discontinuity_pos': 0.0, 'add_noise': True}, {}),
    'el_nino': (EL_NINO['initial_info'], {'f_0': 0.0, 'beta': 1e-11,
                                          'g': 0.05}),
}


@pytest.mark.parametrize('name', list(SCENARIOS))
def test_initial_conditions_match_jax(name):
    """Every scenario builds the JAX package's state and parameters bit for
    bit (the same host NumPy code, the noise from ``noise_seed``), with
    slope orography under the zonal flows."""
    info, over = SCENARIOS[name]
    kw = dict(nx=21, ny=17, dx=1e5, dy=1.2e5, dt=60.0, f_0=1e-4, beta=0.0,
              r=1e-7, initial_info=info, noise_seed=3,
              boundary_type={'x': 'walls', 'y': 'walls',
                             'y_walls_damp': {'dist_thresh': 6e5, 'r': 1e-5}},
              orography_info=({'type': 'slope', 'max_h_base': 10.0}
                              if name.endswith('zonal') else None))
    kw.update(over)
    j, p = _pair(kw, 'richtmyer')
    for k in ('h', 'u', 'v'):
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k), err_msg=k)
    jp = jax.device_get(j.params)
    for f in jp.__dataclass_fields__:
        np.testing.assert_array_equal(_np(getattr(p.params, f)),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    assert p.initial_info == j.initial_info
    assert p._step_kwargs() == j._step_kwargs()


def test_interop_round_trip():
    jw = jsw.ShallowWater(**copy.deepcopy(EL_NINO))
    st, pa = _from_jax(jw)
    js, jp = jax.device_get((jw.state, jw.params))
    for f in ('h', 'u', 'v', 't', 'dt', 'ok'):
        np.testing.assert_array_equal(_np(getattr(st, f)),
                                      np.asarray(getattr(js, f)))
    assert st.ok.dtype == torch.bool and pa.east_mask.dtype == torch.float64
    np.testing.assert_array_equal(pa.west_mask.numpy(),
                                  np.asarray(jp.west_mask))


def test_entry_points_default_to_the_card():
    """ShallowWater, the interop constructors and init_time_step_info build
    on the card unless given a device; without a card they raise."""
    for fn in (psw.ShallowWater.__init__, interop.sw_state_from_numpy,
               interop.sw_params_from_numpy,
               interop.time_step_info_from_numpy,
               interop.column_state_from_numpy,
               interop.grey_forcing_from_numpy, pcol.init_time_step_info):
        assert inspect.signature(fn).parameters['device'].default == 'cuda', fn
    kw = gaussian('walls', 'walls', 8, 8)
    if torch.cuda.is_available():
        assert psw.ShallowWater(**kw).state.h.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            psw.ShallowWater(**kw)
    assert psw.ShallowWater(**kw, device='cpu').state.h.dtype == torch.float32


# --------------------------------------------------------------------------
# the step and the runs against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize('solver', ['richtmyer_pallas', 'richtmyer'])
def test_el_nino_steps_and_run_match_jax(solver):
    """The El Nino forced-wind world with orography: four ``sw_step`` calls
    from one shared state (K5 plus the plain BCs and wind for
    richtmyer_pallas), then ``sw_simulate`` for four steps (K6 for
    richtmyer_pallas, the JAX frame path) against JAX's."""
    jw = jsw.ShallowWater(**copy.deepcopy(EL_NINO), numerical_solver=solver)
    kw = jw._step_kwargs()
    assert kw['row_geometry'] and not kw['flat_orography']
    st, pa = _from_jax(jw)
    js = jw.state
    for _ in range(4):
        js = jsw.sw_step(js, jw.params, **kw)
        st = psw.sw_step(st, pa, **kw)
        _close_state(st, js)
    st0, _ = _from_jax(jw)
    js = jsw.sw_simulate(jw.state, jw.params, 4, **kw)
    ps = psw.sw_simulate(st0, pa, 4, **kw)
    _close_state(ps, js)
    # the step-by-step port agrees with its own run to the last bit for
    # the plain scheme, and for the kernel: K5 + plain BCs == K6
    for k in ('h', 'u', 'v'):
        assert torch.equal(getattr(ps, k), getattr(st, k)), k


@pytest.mark.parametrize('solver', ['richtmyer_pallas', 'richtmyer'])
@pytest.mark.parametrize('bx,by', [('periodic', 'walls'),
                                   ('periodic', 'periodic'),
                                   ('walls', 'periodic'), ('walls', 'walls')])
def test_gaussian_run_every_boundary_matches_jax(bx, by, solver):
    """The wind-free height_gaussian world under every boundary combination:
    five steps of ``sw_simulate`` against JAX's (the Pallas frame path for
    richtmyer_pallas), and the port's ``sw_step`` loop equal to its run."""
    jw = jsw.ShallowWater(**gaussian(bx, by), numerical_solver=solver)
    kw = jw._step_kwargs()
    st, pa = _from_jax(jw)
    js = jsw.sw_simulate(jw.state, jw.params, 5, **kw)
    ps = psw.sw_simulate(st, pa, 5, **kw)
    _close_state(ps, js)
    for _ in range(5):
        st = psw.sw_step(st, pa, **kw)
    for k in ('h', 'u', 'v'):
        assert torch.equal(getattr(ps, k), getattr(st, k)), k


@pytest.mark.parametrize('solver', ['richtmyer_pallas', 'richtmyer'])
def test_snapshots_follow_the_run(solver):
    """``sw_simulate_snapshots`` returns the trajectory of ``sw_simulate``:
    each snapshot equals the run cut at that step, the final state the last
    snapshot."""
    p = psw.ShallowWater(**copy.deepcopy(EL_NINO), numerical_solver=solver,
                         device='cpu', dtype=torch.float64)
    kw = p._step_kwargs()
    final, (t, h, u, v) = psw.sw_simulate_snapshots(p.state, p.params, 3, 2,
                                                    **kw)
    assert h.shape == (3, 34, 130) and t.shape == (3,)
    for s in range(3):
        ref = psw.sw_simulate(p.state, p.params, 2 * (s + 1), **kw)
        for snap, k in ((h, 'h'), (u, 'u'), (v, 'v')):
            assert torch.equal(snap[s], getattr(ref, k)), (s, k)
        assert float(t[s]) == float(ref.t)
    assert torch.equal(final.h, h[-1]) and torch.equal(final.u, u[-1])


# --------------------------------------------------------------------------
# ShallowWater end to end
# --------------------------------------------------------------------------

@pytest.mark.parametrize('solver', ['richtmyer_pallas', 'richtmyer'])
def test_el_nino_script_run_matches_jax(solver):
    """shallow_script.py's El Nino world at 150 x 75, three simulated days
    (928 steps, snapshots every 309 steps), against JAX's ``run`` with the
    jnp richtmyer solver (the JAX kernel needs a multiple-of-8 divisor of
    nx-2 = 148 and falls back to it).  The port's richtmyer_pallas takes the
    kernel's op order (reciprocal then products), ~1e-12 relative from jnp
    richtmyer per step at most (tests/test_pallas_stencils.py).  Measured
    after 928 damped, non-chaotic steps: 1.3e-13 m in h (~100 m) and
    2.4e-15 m/s in u and v (~0.1 m/s) for either solver; the bounds are 1e-11
    and 1e-13, a hundred and forty times that."""
    kw = el_nino_script()
    j = jsw.ShallowWater(**copy.deepcopy(kw))
    p = psw.ShallowWater(**copy.deepcopy(kw), numerical_solver=solver,
                         device='cpu', dtype=torch.float64)
    dj = j.run(n_days=3, save_every=86400)
    dp = p.run(n_days=3, save_every=86400)
    assert dp['h'].shape == dj['h'].shape == (4, 150, 75)
    np.testing.assert_allclose(dp['t'], dj['t'], rtol=1e-13)
    np.testing.assert_allclose(dp['h'], dj['h'], rtol=0, atol=1e-11)
    np.testing.assert_allclose(dp['u'], dj['u'], rtol=0, atol=1e-13)
    np.testing.assert_allclose(dp['v'], dj['v'], rtol=0, atol=1e-13)
    assert float(p.state.t) == pytest.approx(float(j.state.t), rel=1e-13)
    # the east/west seesaw diagnostics and the seasonal wind helper
    w = p.initial_info['wind']
    for a, b in zip(p.get_average_east_west_boundary_thickness(
            dp['h'], w['x_average_width'], w['y_average_width']),
            j.get_average_east_west_boundary_thickness(
            dj['h'], w['x_average_width'], w['y_average_width'])):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    np.testing.assert_array_equal(p.el_nino_seasonal_wind(dp['t']),
                                  j.el_nino_seasonal_wind(dp['t']))


def test_bench_world_turns_unstable_in_both_packages():
    """bench_sw's El Nino world keeps its full height (ny = 1026, |y| up to
    3.2e7 m, so f * dt ~ 0.2 at the y edges, where the explicit Coriolis
    source grows inertial oscillations) at 66 columns: both packages agree
    while it is calm, and both abort (dt < 10 s) within 900 steps."""
    kw = el_nino_script(nx=66, ny=1026)
    j = jsw.ShallowWater(**copy.deepcopy(kw))
    st, pa = _from_jax(j)
    kj = j._step_kwargs()
    kp = dict(kj, solver='richtmyer_pallas')
    js = jsw.sw_simulate(j.state, j.params, 300, **kj)
    ps = psw.sw_simulate(st, pa, 300, **kp)
    assert bool(js.ok) and bool(ps.ok)
    assert float(np.abs(np.asarray(js.u)).max()) < 0.1
    np.testing.assert_allclose(ps.u.numpy(), np.asarray(js.u), rtol=0,
                               atol=1e-12)
    js = jsw.sw_simulate(js, j.params, 600, **kj)
    ps = psw.sw_simulate(ps, pa, 600, **kp)
    assert not bool(js.ok) and not bool(ps.ok)


@pytest.mark.parametrize('solver', ['richtmyer_pallas', 'richtmyer'])
def test_run_executes_exactly_nt_steps(solver):
    """run(nt, save_every) executes exactly nt steps (full snapshot chunks
    plus a remainder), as a loop of time_step calls does
    (tests/test_shallow_water.py::test_run_executes_exactly_nt_steps)."""
    kw = dict(nx=18, ny=12, dx=100e3, dy=100e3, dt=60.0, f_0=1e-4,
              beta=1.6e-11, numerical_solver=solver, device='cpu',
              dtype=torch.float64,
              initial_info={'type': 'height_gaussian',
                            'min_h_surface': 9750.0, 'max_h_surface': 10750.0,
                            'x0': 0.0, 'y0': 0.0, 'x_std': 300e3,
                            'y_std': 300e3, 'add_noise': False})
    for nt, save_steps in [(10, 7), (5, 10), (12, 4)]:
        ref = psw.ShallowWater(**kw)
        for _ in range(nt):
            ref.time_step(float(ref.state.t), save_every=1e18)
        world = psw.ShallowWater(**kw)
        data = world.run(nt=nt, save_every=save_steps * world.dt_0)
        assert float(world.state.t) == pytest.approx(float(ref.state.t))
        np.testing.assert_allclose(world.h, ref.h, rtol=1e-12)
        n_snaps = nt // save_steps
        assert len(data['t']) == (1 + n_snaps if n_snaps else 2)


def test_run_snapshots_match_loop():
    w1 = psw.ShallowWater(**GRAV_WAVE, device='cpu', dtype=torch.float64)
    data = w1.run(nt=20, save_every=60.0)
    assert data['h'].shape[0] == 21    # initial + 20 snapshots (1 per step)
    w2 = psw.ShallowWater(**GRAV_WAVE, device='cpu', dtype=torch.float64)
    t = 0.0
    for _ in range(20):
        t, _ = w2.time_step(t, save_every=1e9)
    np.testing.assert_allclose(data['h'][-1], w2.h, rtol=1e-12)
    np.testing.assert_allclose(data['t'][-1], t, rtol=1e-12)
    # time_step keeps the reference data_dict semantics
    w3 = psw.ShallowWater(**GRAV_WAVE, device='cpu', dtype=torch.float64)
    t, dd = w3.time_step(0.0, save_every=60.0)
    assert len(dd['t']) == 2 and dd['h'][1].shape == (40, 40)


@pytest.mark.parametrize('solver', ['richtmyer_pallas', 'richtmyer'])
def test_tiny_dt_aborts(solver):
    """An absurd velocity collapses the CFL dt below 10 s: time_step and run
    raise ValueError('time step very small'), and the state is frozen."""
    kw = dict(GRAV_WAVE)
    kw['initial_info'] = dict(kw['initial_info'], max_h_surface=12000.0)
    for how in ('time_step', 'run'):
        world = psw.ShallowWater(**kw, numerical_solver=solver, device='cpu',
                                 dtype=torch.float64)
        st = world.state
        world._state = st.replace(u=st.u + 1e5, t=st.t + 1.0)
        frozen = world.state.h.clone()
        with pytest.raises(ValueError, match='time step very small'):
            if how == 'time_step':
                world.time_step(1.0)
            else:
                world.run(nt=3, snapshots=False)
        assert torch.equal(world.state.h, frozen)


@pytest.mark.parametrize('solver', ['richtmyer_pallas', 'richtmyer'])
def test_mass_conservation_periodic(solver):
    """Fully periodic domain: the conservative form preserves total mass
    (tests/test_shallow_water.py::test_mass_conservation_periodic)."""
    kw = dict(GRAV_WAVE, boundary_type={'x': 'periodic', 'y': 'periodic'})
    world = psw.ShallowWater(**kw, numerical_solver=solver, device='cpu',
                             dtype=torch.float64)
    m0 = world.h[1:-1, 1:-1].sum()
    world.run(nt=100, snapshots=False)
    m1 = world.h[1:-1, 1:-1].sum()
    assert abs(m1 - m0) / m0 < 1e-9


def test_linear_pallas_rejected():
    with pytest.raises(ValueError):
        psw.ShallowWater(nx=34, ny=20, dx=1e5, dy=1e5, dt=60, f_0=1e-4,
                         beta=0, linear=True, device='cpu',
                         numerical_solver='richtmyer_pallas')
