"""Port vs JAX: the single-world ``GreyGas`` (``models/grey.py``) — the
analytic-equilibrium tests of test_grey_rce.py run through the port, and the
single-column march held to JAX's step by step (see test_torch_ensemble.py
for why free-running marches are not compared endpoint to endpoint)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.constants import p_surface_earth
from climatemodel_tpu.models.grey import GreyGas as JGreyGas
from climatemodel_tpu_torch.models.grey import GreyGas, GreySwEquilibrium
from climatemodel_tpu_torch.ops import optical_depth as od
from test_torch_column import lockstep_march


def _evolve_tight(world, n_calls=2, flux_thresh=1e-4):
    """As test_grey_rce.py:20-24: two fresh calls reach tight balance."""
    for _ in range(n_calls):
        world.evolve_to_equilibrium(flux_thresh=flux_thresh, save=False,
                                    t_end=30.0)


def test_no_sw_equilibrium_matches_analytic():
    """test_grey_rce.py:27 through the port (f64, as the JAX suite runs):
    T_eqb = ((F/2 sigma)(1 + tau))^(1/4) to <0.1 K where tau > 0.03."""
    world = GreyGas(nz=100, ny=1, tau_lw_func='scale_height',
                    tau_lw_func_args=[0.22 * p_surface_earth, 4.0],
                    dtype=torch.float64, device='cpu')
    up_eqb, down_eqb, T_eqb, *_, correct = world.equilibrium_sol()
    assert correct
    _evolve_tight(world)
    active = world.tau[:, 0] > 0.03
    err = np.abs(world.T - T_eqb)[active]
    assert err.max() < 0.1, f'max T error {err.max():.4f} K'
    act_i = world.tau_interface[:, 0] > 0.03
    assert np.abs(world.up_lw_flux - up_eqb)[act_i].max() < 0.3
    assert np.abs(world.down_lw_flux - down_eqb)[act_i].max() < 0.3


def test_sw_equilibrium_matches_analytic():
    """test_grey_rce.py:44 through the port: exponential lw + sw with an
    integer alpha ratio against the closed form (bottom cell excluded, as
    there: its O(dtau^2) discretisation bias is ~0.7 K)."""
    p_width_lw = 100000.0
    alpha_sw = od.get_exponential_alpha(p_width_lw) / 5
    world = GreyGas(nz=150, ny=1, tau_lw_func='exponential',
                    tau_lw_func_args=[p_width_lw, 4.0],
                    tau_sw_func='exponential',
                    tau_sw_func_args=[od.get_exponential_p_width(alpha_sw),
                                      0.6],
                    dtype=torch.float64, device='cpu')
    *_, T_eqb, _, _, correct = world.equilibrium_sol()
    assert correct
    _evolve_tight(world)
    active = world.tau[:, 0] > 0.03
    active[0] = False
    err = np.abs(world.T - T_eqb)[active]
    assert err.max() < 0.1, f'max T error {err.max():.4f} K'


def test_sw_closed_form_matches_jax():
    """GreySwEquilibrium is host NumPy in both packages: equal to 1e-15."""
    from climatemodel_tpu.models.grey import GreySwEquilibrium as JSw
    from climatemodel_tpu.ops import optical_depth as jod
    alpha_sw = od.get_exponential_alpha(100000.0) / 3
    args = ([100000.0, 4.0], [od.get_exponential_p_width(alpha_sw), 0.5])
    A = 0.3 * np.exp(-1.0)
    calc_p = GreySwEquilibrium(1367.0, A,
                               od.make_profile('exponential', args[0], 1e5),
                               od.make_profile('exponential', args[1], 1e5))
    calc_j = JSw(1367.0, A, jod.make_profile('exponential', args[0], 1e5),
                 jod.make_profile('exponential', args[1], 1e5))
    t2 = np.linspace(0, 0.5, 40)
    for name in ('T', 'up_lw_flux', 'down_lw_flux', 'up_sw_flux',
                 'down_sw_flux'):
        np.testing.assert_allclose(getattr(calc_p, name)(t2),
                                   getattr(calc_j, name)(t2), rtol=1e-15)


@pytest.mark.parametrize('tau_lw_func,args', [
    ('scale_height', [0.22 * p_surface_earth, 4.0]),
    ('exponential', [100000, 4])])
def test_single_column_march_step_by_step_matches_jax(tau_lw_func, args):
    """JAX's single-column GreyGas march (flux, then the split statistics:
    no fused stats) in f32, every step from JAX's carry: the port's step
    keeps T within 0.1 K on the active levels (tau > 0.03) at every step of
    the whole march."""
    wj = JGreyGas(nz=40, ny=1, tau_lw_func=tau_lw_func,
                  tau_lw_func_args=args, dtype=jnp.float32)
    batch = lambda x: x[None]  # noqa: E731
    carry, rec = lockstep_march(
        jax.tree_util.tree_map(batch, wj.state),
        jax.tree_util.tree_map(batch, wj.forcing), wj.p_interface,
        wj.p[:, 0], 1e-3, max_steps=500_000, fused=False)
    active = (wj.tau[:, 0] > 0.03).reshape(-1)
    assert len(rec) > 50
    dT = max(r['dT_lev'][0, active].max() for r in rec)
    n_flags = sum(int((~r['flags_same']).sum()) for r in rec)
    print(f'{tau_lw_func}: {len(rec)} steps, max |dT| on active levels '
          f'{dT:.3g} K, {n_flags} flag flips')
    assert dT <= 0.1


def test_single_column_api():
    """The ported GreyGas surface: a save=False march converges with the
    reference's flags, a repeat march restarts the clock and honours
    T_initial (test_grey_rce.py:170), and the parts not ported raise
    (snapshots, chunk_steps, bake_forcing, check_every > 1,
    take_time_step)."""
    world = GreyGas(nz=30, ny=1, tau_lw_func='scale_height',
                    tau_lw_func_args=[0.22 * p_surface_earth, 4.0],
                    device='cpu')
    assert world.T.shape == (world.nz - 1, 1) and world.T.dtype == np.float32
    data = world.evolve_to_equilibrium(flux_thresh=1e-2, save=False)
    info = world._equilibrium_info
    assert bool(info.equilibrium) and int(info.steps) > 1
    assert len(data['t']) == 2 and data['t'][-1] > 0
    T_eq = world.T.copy()
    world.evolve_to_equilibrium(T_initial=T_eq + 10.0, flux_thresh=1e-2,
                                save=False)
    assert float(world.state.t[0]) > 0
    active = world.tau[:, 0] > 0.1
    dev = np.abs(world.T - T_eq)[active].max()
    assert 1e-4 < dev < 5.0
    for kwargs in (dict(save=True), dict(save=False, chunk_steps=10),
                   dict(save=False, bake_forcing=True),
                   dict(save=False, check_every=4)):
        with pytest.raises(NotImplementedError):
            world.evolve_to_equilibrium(**kwargs)
    with pytest.raises(NotImplementedError):
        world.take_time_step(0.0)
