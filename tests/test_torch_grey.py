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
    T_initial (test_grey_rce.py:170), the march options run and converge
    (snapshots, chunk_steps, bake_forcing, check_every > 1, take_time_step),
    debug refuses what the JAX package refuses, and plot_eqb draws its
    three panels (its data is held to JAX's in test_torch_olr_plots.py)."""
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
        data = world.evolve_to_equilibrium(flux_thresh=1e-2, **kwargs)
        assert bool(world._equilibrium_info.equilibrium), kwargs
        assert len(data['t']) == len(data['T']) >= 2
    t, delta = world.take_time_step(0.0)
    assert t > 0 and delta == 1e6
    data = world.evolve_to_equilibrium()      # save=True, JAX's default
    assert bool(world._equilibrium_info.equilibrium) and len(data['t']) > 2
    for kwargs in (dict(save=True), dict(save=False, check_every=8),
                   dict(save=False, dip_memory=True)):
        with pytest.raises(ValueError, match='debug'):
            world.evolve_to_equilibrium(debug=True, **kwargs)
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = world.plot_eqb(*world.equilibrium_sol()[:5])
    assert len(ax) == 3 and all(len(a.lines) > 0 for a in ax)
    plt.close(fig)


def _latitude_worlds():
    """The same f64 latitude world (ny = 6, the step-function albedo of
    bench.py:565-570 with icy poles) in both packages."""
    kw = dict(nz=20, ny=6, tau_lw_func='scale_height',
              tau_lw_func_args=[0.22 * p_surface_earth, 4.0],
              albedo=lambda lat: np.where(np.abs(lat) > 60, 0.6, 0.3))
    return (JGreyGas(dtype=jnp.float64, **kw),
            GreyGas(dtype=torch.float64, device='cpu', **kw))


def _assert_forcing_equal(wj, wp):
    fj, fp = jax.device_get(wj.forcing), wp.forcing
    for name in ('dtau', 'tau_sw_interface', 'albedo_mod',
                 'solar_latitude_factor', 'F_stellar'):
        np.testing.assert_array_equal(getattr(fp, name)[0].numpy(),
                                      np.asarray(getattr(fj, name)), name)


def test_latitude_world_step_by_step_matches_jax_across_mutations():
    """A latitude grid (ny = 6, one dt shared across latitudes) in f64: the
    port's march step from JAX's carry stays within 1e-9 K with the same
    controller and flags at every step of three marches, across the two
    mutations the ice-albedo sweep makes between marches: an in-place
    ``albedo[idx] = ...`` (read live through albedo_mod when there is no sw
    absorber, ice_albedo.py:121) and ``tau_lw_func_args`` followed by
    ``update_grid()`` (ice_albedo.py:145-147).  The worlds' forcings are
    equal after each mutation, and the port world's own march converges
    each time within 1.5 K of JAX's (free-running marches, see
    test_torch_ice_albedo.py)."""
    wj, wp = _latitude_worlds()
    batch = lambda x: x[None]  # noqa: E731

    def march():
        _assert_forcing_equal(wj, wp)
        st = wj.state.replace(t=jnp.zeros_like(wj.state.t))
        carry, rec = lockstep_march(
            jax.tree_util.tree_map(batch, st),
            jax.tree_util.tree_map(batch, wj.forcing), wj.p_interface,
            wj.p[:, 0], 1e-3, max_steps=500_000, fused=False)
        assert len(rec) > 20
        assert max(r['dT'].max() for r in rec) <= 1e-9
        assert max(r['rel_dt'].max() for r in rec) <= 1e-9
        assert all(r['ind_same'].all() and r['flags_same'].all()
                   for r in rec)
        for w in (wj, wp):
            w.evolve_to_equilibrium(flux_thresh=1e-3, save=False)
        assert bool(wp._equilibrium_info.equilibrium)
        assert np.abs(wp.T - np.asarray(wj.T)).max() < 1.5
        return len(rec)

    n = [march()]
    albedo_before = wp.forcing.albedo_mod.clone()
    for w in (wj, wp):
        w.albedo[[1, 4]] += 0.1               # in place, as the ramp does
    assert not torch.equal(wp.forcing.albedo_mod, albedo_before)
    n.append(march())
    for w in (wj, wp):
        w.tau_lw_func_args = (0.22 * p_surface_earth, 3.5)
        w.update_grid()
    assert wp.tau_interface[0, 0] == pytest.approx(3.5, rel=1e-6)
    n.append(march())
    print(f'lockstep steps per march: {n}')


def test_grey_latitude_ensemble_matches_jax():
    """``grey_latitude_ensemble`` splits the latitude world into ny
    single-column members: every field equal to JAX's, then the
    independent-dt march of those members held to JAX's step by step
    (fused net+stats, f64: within 1e-9 K, same controller and flags), and
    the port's own march ends every member converged or timed out."""
    from climatemodel_tpu.models import ensemble as jens
    from climatemodel_tpu_torch.models import ensemble as pens
    wj, wp = _latitude_worlds()
    sj, fj, pij, pcj = jax.device_get(jens.grey_latitude_ensemble(wj))
    sp, fp, pip, pcp = pens.grey_latitude_ensemble(wp)
    np.testing.assert_array_equal(pip.numpy(), pij)
    np.testing.assert_array_equal(pcp.numpy(), pcj)
    for name in ('dtau', 'tau_sw_interface', 'albedo_mod',
                 'solar_latitude_factor', 'F_stellar'):
        np.testing.assert_array_equal(getattr(fp, name).numpy(),
                                      getattr(fj, name), name)
    for name in ('T', 'net_flux', 't'):
        np.testing.assert_array_equal(getattr(sp, name).numpy(),
                                      getattr(sj, name), name)
    for name, x in vars(sp.tsi).items():
        np.testing.assert_array_equal(x.numpy(), getattr(sj.tsi, name), name)
    np.testing.assert_array_equal(sp.T[:, :, 0].T.numpy(), wp.T)
    carry, rec = lockstep_march(jens.grey_latitude_ensemble(wj)[0],
                                jens.grey_latitude_ensemble(wj)[1], pij, pcj,
                                1e-3, max_steps=3000)
    assert len(rec) > 20
    assert max(r['dT'][r['go']].max() for r in rec) <= 1e-9
    assert all((r['ind_same'] & r['flags_same'])[r['go']].all() for r in rec)
    fs, info = pens.grey_evolve_ensemble(sp, fp, pip, pcp, 1e-3,
                                         max_steps=3000)
    # the icy poles time out (t_end 4 years), in JAX's march too
    assert bool((info.equilibrium | info.timed_out).all())
    assert not bool((info.nan | info.failed).any())
    assert not np.asarray(carry[4])[[0, -1]].any()
