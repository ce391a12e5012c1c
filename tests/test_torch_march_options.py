"""Port vs JAX, and the port against itself: the march options of
``GreyGas.evolve_to_equilibrium`` and ``column.evolve_to_equilibrium`` —
the snapshot march (``save=True``) and its flux lag, ``take_time_step``
and ``save_data``, ``check_every`` on the single-world and ensemble paths
and with ``chunk_steps``, ``dip_memory``, ``bake_forcing`` and ``debug``
(test_grey_rce.py:99-170, :203-518 and test_debug.py run through the port).

Free-running marches of the two packages part in their last bits after
~50-100 steps (ROADMAP Queue 3 note), so they are compared where their
paths cannot part: step-capped marches with an unreachable threshold, the
first steps, and the discrete layout of what they return.  The port's
options are held bit for bit to the port's per-step march wherever the JAX
package pins that identity."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.constants import p_surface_earth
from climatemodel_tpu.models import column as jcol
from climatemodel_tpu.models.grey import GreyGas as JGreyGas
from climatemodel_tpu.models.grey import _grey_evolve
from climatemodel_tpu_torch.models import column as pcol
from climatemodel_tpu_torch.models import ensemble as pens
from climatemodel_tpu_torch.models.grey import GreyGas, grey_fluxes

CPU64 = dict(dtype=torch.float64, device='cpu')
THERMOSPHERE = dict(tau_lw_func='scale_height_and_peak_in_atmosphere',
                    tau_lw_func_args=[51000, 4, 100, 600, 0.1],
                    tau_sw_func='scale_height_and_peak_in_atmosphere',
                    tau_sw_func_args=[p_surface_earth, 0.12, 100, 20, 0.002])
EXPO = dict(nz=40, ny=1, tau_lw_func='exponential',
            tau_lw_func_args=[100000, 4])


def _pair(**kw):
    return JGreyGas(dtype=jnp.float64, **kw), GreyGas(**kw, **CPU64)


def _equal_march(w1, w2):
    """Two port worlds' marches ended bit for bit alike."""
    i1, i2 = w1._equilibrium_info, w2._equilibrium_info
    assert torch.equal(w1.state.T, w2.state.T)
    assert torch.equal(w1.state.t, w2.state.t)
    for f in i1._fields:
        np.testing.assert_array_equal(getattr(i1, f), getattr(i2, f), f)


# --------------------------------------------------------------------------
# save=True, take_time_step, save_data
# --------------------------------------------------------------------------

def test_save_mode_matches_fast_mode():
    """test_grey_rce.py:99: the snapshot march ends where the save=False
    march ends — bit for bit in the port (one march step for both paths),
    with the same steps and flags; its data_dict has a time and a
    temperature per step (plus the seed), the clock strictly increasing,
    as JAX's does."""
    kw = dict(nz=30, ny=1, tau_lw_func='scale_height',
              tau_lw_func_args=[0.22 * p_surface_earth, 2.0])
    w1, w2 = GreyGas(**kw, **CPU64), GreyGas(**kw, **CPU64)
    w1.evolve_to_equilibrium(flux_thresh=1e-3, save=False)
    data = w2.evolve_to_equilibrium(flux_thresh=1e-3, save=True,
                                    chunk_steps=64)
    _equal_march(w1, w2)
    steps = int(w2._equilibrium_info.steps)
    assert len(data['t']) == len(data['T']) == steps + 1
    assert np.all(np.diff(data['t']) > 0)
    np.testing.assert_array_equal(data['T'][-1], w1.T)
    assert data['t'][-1] == float(w1.state.t[0])
    wj = JGreyGas(dtype=jnp.float64, **kw)
    dj = wj.evolve_to_equilibrium(flux_thresh=1e-3, save=True)
    assert set(dj) == set(data)
    assert len(dj['t']) == int(wj._equilibrium_info.steps) + 1
    # the forced first step is the same step in both packages
    np.testing.assert_allclose(data['t'][:2], dj['t'][:2], rtol=1e-12)
    np.testing.assert_allclose(data['T'][1], dj['T'][1], rtol=1e-12)


def test_fused_save_flux_lag_parity():
    """test_grey_rce.py:140: with 'tau' and 'flux' in data_dict every list
    has one entry per time stamp, the flux stored with step k is the flux
    of step k-1's temperature (the reference's save_data lag, bit for bit
    here) and the tau entries repeat the static grids; the keys and lengths
    of the layout are JAX's."""
    def seed(w):
        return {'t': [0.0], 'T': [w.T.copy()],
                'tau': {'lw': [w.tau.copy()], 'sw': [w.tau_sw.copy()]},
                'flux': {'lw_up': [w.up_lw_flux], 'lw_down': [w.down_lw_flux],
                         'sw_up': [w.up_sw_flux],
                         'sw_down': [w.down_sw_flux]}}
    wj, wp = _pair(nz=25, ny=1, tau_lw_func='scale_height',
                   tau_lw_func_args=[0.22 * p_surface_earth, 2.0])
    data = wp.evolve_to_equilibrium(data_dict=seed(wp), flux_thresh=5e-2,
                                    save=True, chunk_steps=16)
    dj = wj.evolve_to_equilibrium(data_dict=seed(wj), flux_thresh=5e-2,
                                  save=True)
    n = len(data['t'])
    assert n > 3 and len(data['T']) == n and len(data['tau']['lw']) == n
    for key in ('lw_up', 'lw_down', 'sw_up', 'sw_down'):
        assert len(data['flux'][key]) == n
    for k in (2, n - 1):
        fx = grey_fluxes(torch.from_numpy(data['T'][k - 1])[None],
                         wp.forcing)
        for key, f in zip(('lw_up', 'lw_down', 'sw_up', 'sw_down'), fx):
            np.testing.assert_array_equal(data['flux'][key][k], f[0].numpy())
    np.testing.assert_array_equal(data['tau']['lw'][-1], wp.tau)
    np.testing.assert_array_equal(wp.up_lw_flux, data['flux']['lw_up'][-1])
    assert set(dj) == set(data) and set(dj['flux']) == set(data['flux'])
    assert len(dj['t']) == len(dj['flux']['lw_up']) == len(dj['tau']['sw'])
    np.testing.assert_allclose(data['flux']['lw_up'][1],
                               dj['flux']['lw_up'][1], rtol=1e-12)


def test_take_time_step_and_save_data_match_jax():
    """``take_time_step`` (grey.py:296-344), a latitude world in f64: the
    returned time and delta, the temperature and the lagged flux views
    after each of five steps (the first forced, t = 0; the third with
    ``changing_tau`` after a tau mutation) within 1e-12 of JAX's;
    ``return_dt`` and ``save_data`` as JAX's."""
    kw = dict(nz=25, ny=3, tau_lw_func='scale_height',
              tau_lw_func_args=[0.22 * p_surface_earth, 3.0])
    wj, wp = _pair(**kw)
    t_j = t_p = 0.0
    data_j, data_p = ({'t': [], 'T': [], 'flux': {k: [] for k in (
        'lw_up', 'lw_down', 'sw_up', 'sw_down')}} for _ in range(2))
    for k in range(5):
        changing = k == 2
        if changing:
            for w in (wj, wp):
                w.tau_lw_func_args = (0.22 * p_surface_earth, 3.5)
        out_j = wj.take_time_step(t_j, changing_tau=changing, return_dt=True)
        out_p = wp.take_time_step(t_p, changing_tau=changing, return_dt=True)
        np.testing.assert_allclose(out_p, out_j, rtol=1e-12)
        t_j, t_p = out_j[0], out_p[0]
        np.testing.assert_allclose(wp.T, np.asarray(wj.T), rtol=1e-12)
        np.testing.assert_allclose(wp.up_lw_flux, np.asarray(wj.up_lw_flux),
                                   rtol=1e-12)
        wj.save_data(data_j, t_j)
        wp.save_data(data_p, t_p)
    assert out_p[1] != 1e6
    for key in ('t', 'T'):
        np.testing.assert_allclose(data_p[key], data_j[key], rtol=1e-12)
    np.testing.assert_allclose(data_p['flux']['sw_down'],
                               np.asarray(data_j['flux']['sw_down']),
                               rtol=1e-12)


def test_evolve_snapshots_repeat_the_final_state():
    """``column.evolve_snapshots`` with more snapshots than the march needs
    and a 'post' snapshot function: the snapshots after the exit repeat
    the final state, and each snapshot's extra is its own temperature's."""
    w = GreyGas(nz=20, ny=1, tau_lw_func='scale_height',
                tau_lw_func_args=[0.22 * p_surface_earth, 2.0], **CPU64)
    forcing = w.forcing
    net_fn, p_int, p_c = w._march_inputs(forcing)
    st, info, snaps = pcol.evolve_snapshots(
        w.state, net_fn, p_int, p_c, n_snaps=400, steps_per_snap=2,
        flux_thresh=1e-2, snapshot_fn=lambda T: (T * 2,),
        snapshot_on='post')
    steps = snaps['steps'][:, 0]
    last = int(torch.nonzero(steps == info.steps[0])[0, 0])
    assert bool(info.equilibrium[0]) and last < 399
    assert torch.equal(snaps['T'][-1], st.T)
    assert bool((snaps['steps'][last:] == info.steps).all())
    assert torch.equal(snaps['extra'][0], 2 * snaps['T'])
    assert bool((torch.diff(steps[:last]) == 2).all())
    assert 1 <= int(steps[last] - steps[last - 1]) <= 2


# --------------------------------------------------------------------------
# check_every, dip_memory, chunk_steps
# --------------------------------------------------------------------------

def _capped(package, k, max_steps):
    """A world marched ``max_steps`` steps with an unreachable threshold
    (no exit fires), ``check_every=k``, f64."""
    if package == 'jax':
        w = JGreyGas(dtype=jnp.float64, **EXPO)
        st, info = _grey_evolve(
            w.state, w.forcing, jnp.asarray(w.p_interface),
            jnp.asarray(w.p[:, 0]), jnp.asarray(1e-12), t_end=1e9,
            max_steps=max_steps, check_every=k)
        return np.asarray(st.T), float(st.t), int(info.steps)
    w = GreyGas(**EXPO, **CPU64)
    net_fn, p_int, p_c = w._march_inputs(w.forcing)
    st, info = pcol.evolve_to_equilibrium(
        w.state, net_fn, p_int, p_c, flux_thresh=1e-12, t_end=1e9,
        max_steps=max_steps, check_every=k)
    return st.T[0].numpy(), float(st.t[0]), int(info.steps[0])


@pytest.mark.parametrize('max_steps', [13, 14])
def test_check_every_chunked_exit(max_steps):
    """test_grey_rce.py:203: capped at a step count with no exit firing,
    ``check_every=4`` is the per-step march's physics (the reduced steps
    skip only the exit statistics): bit-identical T and t in the port.  The
    chunk runs past the cap to the next check (a 2-step prefix and chunks
    of 4: 14 steps for a cap of 13), in both packages, and the port's
    capped state is within 1e-9 relative of JAX's."""
    T4, t4, s4 = _capped('port', 4, max_steps)
    T1, t1, s1 = _capped('port', 1, 14)
    Tj, tj, sj = _capped('jax', 4, max_steps)
    assert s4 == sj == 14 and s1 == 14
    np.testing.assert_array_equal(T4, T1)
    assert t4 == t1
    np.testing.assert_allclose(T4, Tj, rtol=1e-9)
    assert t4 == pytest.approx(tj, rel=1e-9)


def test_check_every_adaptive_march_converges():
    """test_grey_rce.py:203, second half: the full adaptive march with
    ``check_every=4``, twice (the reference experiments' pattern), converges
    to the per-step march's equilibrium within 0.2 K where tau > 0.03."""
    w1, w4 = GreyGas(**EXPO, **CPU64), GreyGas(**EXPO, **CPU64)
    for _ in range(2):
        w1.evolve_to_equilibrium(flux_thresh=1e-3, save=False)
        w4.evolve_to_equilibrium(flux_thresh=1e-3, save=False, check_every=4)
    assert bool(w4._equilibrium_info.equilibrium)
    active = w1.tau[:, 0] > 0.03
    assert np.abs(w1.T - w4.T)[active].max() < 0.2


def _expo_ensemble(F, dtype=torch.float64):
    w = GreyGas(**EXPO, dtype=dtype, device='cpu')
    return w, pens.grey_ensemble(w, F)


def test_check_every_ensemble_path():
    """test_grey_rce.py:248: ``check_every=4`` on the ensemble march (each
    member its own chunk clock): every member converges or times out,
    within 1 K of the per-step march; capped with no exit firing, the
    ensemble's T is bit-identical to the per-step one and within 1e-9
    relative of JAX's vmapped march."""
    from climatemodel_tpu.models import ensemble as jens
    F = np.linspace(1100.0, 1500.0, 8)
    world, (states, forcings, p_int, p_c) = _expo_ensemble(F)
    out1, info1 = pens.grey_evolve_ensemble(states, forcings, p_int, p_c,
                                            1e-3, max_steps=5000)
    out4, info4 = pens.grey_evolve_ensemble(states, forcings, p_int, p_c,
                                            1e-3, max_steps=5000,
                                            check_every=4)
    assert bool((info4.equilibrium | info4.timed_out).all())
    active = torch.from_numpy(world.tau[:, 0] > 0.03)
    assert (out1.T - out4.T).abs()[:, active].max() < 1.0
    c1, _ = pens.grey_evolve_ensemble(states, forcings, p_int, p_c, 1e-12,
                                      max_steps=22, t_end=1e9)
    c4, i4 = pens.grey_evolve_ensemble(states, forcings, p_int, p_c, 1e-12,
                                       max_steps=22, t_end=1e9,
                                       check_every=4)
    assert torch.equal(c1.T, c4.T) and bool((i4.steps == 22).all())
    wj = JGreyGas(dtype=jnp.float64, **EXPO)
    sj, fj, pij, pcj = jens.grey_ensemble(wj, F)
    cj, ij = jens.grey_evolve_ensemble(sj, fj, pij, pcj, jnp.asarray(1e-12),
                                       max_steps=22, t_end=1e9,
                                       check_every=4)
    np.testing.assert_array_equal(i4.steps.numpy(), np.asarray(ij.steps))
    np.testing.assert_allclose(c4.T.numpy(), np.asarray(cj.T), rtol=1e-9)


def test_check_every_with_chunked_device_calls():
    """test_grey_rce.py:300: ``check_every=4`` with ``chunk_steps=25`` (the
    chunk re-entry skips the two-step prefix) converges within 1 K of the
    per-step march where tau > 0.03."""
    w_ref, w_chunk = GreyGas(**EXPO, **CPU64), GreyGas(**EXPO, **CPU64)
    w_ref.evolve_to_equilibrium(flux_thresh=1e-3, save=False)
    w_chunk.evolve_to_equilibrium(flux_thresh=1e-3, save=False,
                                  chunk_steps=25, check_every=4)
    assert bool(w_chunk._equilibrium_info.equilibrium)
    active = w_ref.tau[:, 0] > 0.03
    assert np.abs(w_ref.T - w_chunk.T)[active].max() < 1.0


def _thermo(**kw):
    return GreyGas(nz=60, ny=1, **THERMOSPHERE, **kw)


@pytest.mark.parametrize('conv', [False, True])
def test_dip_memory_bit_identical_to_per_step(conv):
    """test_grey_rce.py:344 and :318: ``check_every=8, dip_memory=True``,
    alone and with ``chunk_steps=25, check_every=4``, ends bit for bit where
    the per-step march ends (state, step count, delta, flags, time), with
    and without convective adjustment."""
    w1 = _thermo(**CPU64)
    w1.evolve_to_equilibrium(flux_thresh=1e-3, save=False,
                             convective_adjust=conv)
    for kw in (dict(check_every=8), dict(chunk_steps=25, check_every=4)):
        w8 = _thermo(**CPU64)
        w8.evolve_to_equilibrium(flux_thresh=1e-3, save=False,
                                 convective_adjust=conv, dip_memory=True,
                                 **kw)
        _equal_march(w1, w8)


@pytest.mark.parametrize('max_steps,ft', [(5000, 1e-3), (37, 1e-9)])
def test_dip_memory_ensemble_exact(max_steps, ft):
    """test_grey_rce.py:376 and :402: the K=4 dip-memory ensemble march is
    bit-identical to the per-step one member by member, the exit flags
    included, and a capped march freezes at the cap (37 steps) instead of
    running on to the chunk's end."""
    F = np.linspace(1100.0, 1500.0, 8)
    _, (states, forcings, p_int, p_c) = _expo_ensemble(F)
    out1, info1 = pens.grey_evolve_ensemble(states, forcings, p_int, p_c, ft,
                                            max_steps=max_steps)
    out4, info4 = pens.grey_evolve_ensemble(states, forcings, p_int, p_c, ft,
                                            max_steps=max_steps,
                                            check_every=4, dip_memory=True)
    assert torch.equal(out1.T, out4.T)
    for a, b in zip(info1, info4):
        assert torch.equal(a, b)
    if max_steps == 37:
        assert bool((info4.steps == 37).all())


def test_f32_noise_blocked_member_finishes_in_f64_with_dip_memory():
    """test_grey_rce.py:426 through the port with ``check_every=8,
    dip_memory=True`` passed to both the f32 march and its f64 finish:
    the same finished members and states, bit for bit, as the per-step
    cadence (test_torch_ensemble.py holds that one to JAX's)."""
    world = GreyGas(nz=60, ny=1, tau_lw_func='scale_height',
                    tau_lw_func_args=[0.22 * p_surface_earth, 4.0],
                    device='cpu')
    F = np.array([900.0, 1200.0, 1550.57387057, 1579.68253968])
    states, forcings, p_int, p_c = pens.grey_ensemble(world, F)
    outs = []
    for kw in ({}, dict(check_every=8, dip_memory=True)):
        fs, info = pens.grey_evolve_ensemble(states, forcings, p_int, p_c,
                                             1e-3, max_steps=3000, **kw)
        outs.append(pens.grey_finish_unconverged_f64(
            fs, info, forcings, p_int, p_c, 1e-3, max_steps=3000, **kw))
    (fs0, i0, fin0), (fs1, i1, fin1) = outs
    np.testing.assert_array_equal(fin0, fin1)
    assert bool(i1.equilibrium.all())
    assert torch.equal(fs0.T, fs1.T)
    for a, b in zip(i0, i1):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# bake_forcing
# --------------------------------------------------------------------------

def test_bake_forcing_matches_dynamic_march():
    """test_grey_rce.py:477-518: ``bake_forcing`` has no compile to bake
    into on the GPU, so it is the same march: bit for bit equal to the
    dynamic one on a radiative world and a convective one, and after an
    in-place albedo mutation of a latitude world (which must reach the
    march: its temperatures fall, as in JAX's test)."""
    for make, kw in (
            (lambda: GreyGas(**EXPO, **CPU64), {}),
            (lambda: _thermo(**CPU64), dict(convective_adjust=True,
                                            t_end=30.0))):
        w_dyn, w_baked = make(), make()
        for _ in range(2):
            w_dyn.evolve_to_equilibrium(flux_thresh=1e-3, save=False, **kw)
            w_baked.evolve_to_equilibrium(flux_thresh=1e-3, save=False,
                                          bake_forcing=True, **kw)
            _equal_march(w_dyn, w_baked)
    worlds = [GreyGas(nz=40, ny=4, tau_lw_func='exponential',
                      tau_lw_func_args=[100000, 4],
                      albedo=lambda lat: np.full_like(lat, 0.3), **CPU64)
              for _ in range(2)]
    for bake in (False, True):
        worlds[bake].evolve_to_equilibrium(flux_thresh=1e-3, save=False,
                                           bake_forcing=bake)
    T_warm = worlds[1].T.copy()
    for bake in (False, True):
        worlds[bake].albedo[:] = 0.4
        worlds[bake].evolve_to_equilibrium(flux_thresh=1e-3, save=False,
                                           bake_forcing=bake)
    _equal_march(*worlds)
    assert worlds[1].T.max() < T_warm.max() - 2.0


# --------------------------------------------------------------------------
# debug
# --------------------------------------------------------------------------

def _toy_march(net_fn, package, nz=12, T0=250.0, **kw):
    """test_debug.py's toy column under ``net_fn`` (written for JAX arrays
    of [nz-1, ny] T; the port's [B, nz-1, ny] T goes through it one member
    at a time), f64: (error message or None, steps, nan, failed)."""
    from jax.experimental import checkify
    p_col = np.linspace(float(p_surface_earth), 100.0, nz)
    p_c = 0.5 * (p_col[:-1] + p_col[1:])
    if package == 'jax':
        state = jcol.ColumnState(
            T=jnp.full((nz - 1, 1), float(T0)), t=jnp.asarray(0.0),
            net_flux=jnp.zeros((nz, 1)),
            tsi=jcol.init_time_step_info(nz - 1, dtype=jnp.float64))
        err, (st, info) = checkify.checkify(jax.jit(
            lambda s: jcol.evolve_to_equilibrium(
                s, net_fn, jnp.asarray(p_col)[:, None], jnp.asarray(p_c),
                flux_thresh=1e-3, max_steps=50, debug=True, **kw)),
            errors=checkify.user_checks)(state)
        msg = err.get()            # checkify appends which check failed
        msg = msg and msg.removesuffix(' (`check` failed)')
        return msg, int(info.steps), bool(info.nan), bool(info.failed)

    def port_net(T):
        return torch.from_numpy(np.asarray(net_fn(jnp.asarray(T[0].numpy())))
                                ).to(T.dtype)[None]
    state = pcol.ColumnState(
        T=torch.full((1, nz - 1, 1), float(T0), dtype=torch.float64),
        t=torch.zeros((1,), dtype=torch.float64),
        net_flux=torch.zeros((1, nz, 1), dtype=torch.float64),
        tsi=pcol.init_time_step_info(nz - 1, batch=1, dtype=torch.float64,
                                     device='cpu'))
    try:
        _, info = pcol.evolve_to_equilibrium(
            state, port_net, torch.from_numpy(p_col)[:, None],
            torch.from_numpy(p_c), flux_thresh=1e-3, max_steps=50,
            debug=True, **kw)
    except pcol.MarchDebugError as e:
        return str(e), None, None, None
    return None, int(info.steps[0]), bool(info.nan[0]), bool(info.failed[0])


def _nan_at_3(T):
    return jnp.zeros((T.shape[0] + 1, T.shape[1]), T.dtype).at[3, 0].set(
        jnp.nan)


def _cooling_at_5(T):
    net = jnp.zeros((T.shape[0] + 1, T.shape[1]), T.dtype)
    net = net.at[5, 0].set(-1e9 - 1e6 * T[5, 0])
    return net.at[6, 0].set(1e9 + 1e6 * T[5, 0])


def _healthy(T):
    return jnp.zeros((T.shape[0] + 1, T.shape[1]), T.dtype)


@pytest.mark.parametrize('net_fn,T0,words', [
    (_nan_at_3, 250.0, ('non-finite net flux', 'interface 3', 'step 1')),
    (_cooling_at_5, 5.5, ('below zero', 'level 5', 'step 6')),
    (_healthy, 250.0, None)])
def test_debug_reports_what_checkify_reports(net_fn, T0, words):
    """test_debug.py's toy columns: the port's host-side debug check raises
    where JAX's checkify check records an error, with JAX's message: the
    same kind, flat index and step, and its temperature and simulated time
    within 1e-9 relative; a healthy march raises nothing and converges in
    the same number of steps.  The cooling column starts at 5.5 K (test_
    debug.py: 5 K) so that no step lands on 0 K exactly: there XLA's fused
    multiply-add (T + dt * tendency in one rounding) and the port's two
    roundings fall on either side of zero (-1.3e-17 K at step 5 in JAX, 0 K
    in the port, which goes below zero at step 6)."""
    msg_j, steps_j, *_ = _toy_march(net_fn, 'jax', T0=T0)
    msg_p, steps_p, *_ = _toy_march(net_fn, 'port', T0=T0)
    if words is None:
        assert msg_j is None and msg_p is None and steps_p == steps_j
        return
    assert all(w in msg_j and w in msg_p for w in words), (msg_j, msg_p)
    number = r'-?\d+\.?\d*(?:e[-+]?\d+)?(?= K| s)'
    assert re.sub(number, '#', msg_p) == re.sub(number, '#', msg_j)
    np.testing.assert_allclose(np.float64(re.findall(number, msg_p)),
                               np.float64(re.findall(number, msg_j)),
                               rtol=1e-9)


def test_debug_march_options():
    """The GreyGas debug march is bit-identical to the plain one
    (test_debug.py:114); a NaN planted in T_initial raises naming the
    non-finite level and step 1 where the plain march raises the sentinel's
    FloatingPointError (:122), in one call and with ``chunk_steps``
    (:146); per-step checks only (:102, :138)."""
    def world():
        return GreyGas(nz=30, ny=1, tau_lw_func='scale_height',
                       tau_lw_func_args=[0.22 * p_surface_earth, 4.0],
                       device='cpu')
    w1, w2 = world(), world()
    w1.evolve_to_equilibrium(flux_thresh=1e-1, save=False)
    w2.evolve_to_equilibrium(flux_thresh=1e-1, save=False, debug=True)
    _equal_march(w1, w2)
    T0 = world().T.copy()
    T0[7] = np.nan
    for kw in ({}, dict(chunk_steps=16)):
        with pytest.raises(pcol.MarchDebugError, match='non-finite') as exc:
            world().evolve_to_equilibrium(flux_thresh=1e-1, save=False,
                                          debug=True, T_initial=T0, **kw)
        assert 'step 1' in str(exc.value)
    with pytest.raises(FloatingPointError):
        world().evolve_to_equilibrium(flux_thresh=1e-1, save=False,
                                      T_initial=T0)
    with pytest.raises(ValueError, match='check_every'):
        w = world()
        net_fn, p_int, p_c = w._march_inputs(w.forcing)
        pcol.evolve_to_equilibrium(w.state, net_fn, p_int, p_c,
                                   debug=True, check_every=8)


def test_verbose_prints_a_line_a_chunk(capsys):
    """``verbose`` alone marches in chunks of 1000 steps and prints the
    reference's per-chunk line (base.py:324-327) at each chunk's end; the
    march is the per-step one bit for bit."""
    w1, w2 = GreyGas(**EXPO, **CPU64), GreyGas(**EXPO, **CPU64)
    w1.evolve_to_equilibrium(flux_thresh=1e-3, save=False)
    w2.evolve_to_equilibrium(flux_thresh=1e-3, save=False, verbose=True)
    _equal_march(w1, w2)
    out = capsys.readouterr().out
    assert out.startswith(f'step {int(w2._equilibrium_info.steps)}: t = ')
    assert 'delta_net_flux = ' in out

