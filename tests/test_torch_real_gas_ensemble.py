"""Port vs JAX: the real-gas ensembles (the real-gas half of
``models/ensemble.py``): members sharing one composition (one
TransmissionCache, a batched matmul over the long-wave bands a step) and
members each with their own (``stacked_tau``), the batched ground-temperature
solve, and the bf16 cache on the ensemble path.

Marches are held step by step from a shared carry (``rg_lockstep`` in
test_torch_real_gas.py): JAX's vmapped real-gas march body drives the
trajectory and the port's lock-step ``column.march_step`` takes the same
carry before every step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.models import ensemble as jens
from climatemodel_tpu.models import real_gas as jrg
from climatemodel_tpu.spectral import humidity as jhum
from climatemodel_tpu_torch.models import ensemble as pens
from climatemodel_tpu_torch.models import real_gas as prg
from climatemodel_tpu_torch.spectral import earth_tables as pet
from climatemodel_tpu_torch.spectral import humidity as phum
from test_torch_real_gas import (DTYPES, EARTH, active_cells, earth_kw, rel,
                                 rg_lockstep, single_line_kw, steps_of)

F_SCALES = [0.9, 1.0, 1.1, 1.05]


@pytest.fixture(scope='module')
def earth_folder(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp('lut'))
    _, built = pet.ensure_earth_tables(folder)
    assert set(built) == set(EARTH)
    return folder


def test_real_gas_ensemble_inputs_match_jax(earth_folder):
    """real_gas_ensemble: fresh per-member states (isothermal at each T_g,
    t = 0, a new controller), the scales and T_gs, and the shared march
    args equal to JAX's (f64)."""
    jw = jrg.RealGas(dtype=jnp.float64, **earth_kw(earth_folder))
    pw = prg.RealGas(dtype=torch.float64, device='cpu',
                     **earth_kw(earth_folder))
    T_gs = [255.0, 265.0, 275.0]
    sj, scj, tj, aj = jens.real_gas_ensemble(jw, F_scales=[0.9, 1.0, 1.1],
                                             T_g_values=T_gs)
    sp, scp, tq, ap = pens.real_gas_ensemble(pw, F_scales=[0.9, 1.0, 1.1],
                                             T_g_values=T_gs)
    np.testing.assert_array_equal(sp.T.numpy(), np.asarray(sj.T))
    np.testing.assert_array_equal(sp.t.numpy(), np.asarray(sj.t))
    np.testing.assert_array_equal(scp.numpy(), np.asarray(scj))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(tj))
    for name in ('delta_t', 'max_delta_t', 'delta_t_step', 'max_tend_ind',
                 'removed'):
        np.testing.assert_array_equal(getattr(sp.tsi, name).numpy(),
                                      np.asarray(getattr(sj.tsi, name)))
    np.testing.assert_array_equal(ap[0].numpy(), np.asarray(aj[0]))   # tau
    for a, b in zip(ap[2:], aj[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _ensemble_lockstep(jw, scales, T_gs, flux_thresh, max_steps, **kw):
    sj, scj, tgj, args = jens.real_gas_ensemble(jw, F_scales=scales,
                                                T_g_values=T_gs)
    return rg_lockstep(sj, scj, tgj, *args, flux_thresh,
                       max_steps=max_steps, t_end=20.0, **kw)


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
def test_shared_cache_ensemble_step_by_step_matches_jax(earth_folder, dtype):
    """4 members of the earth column sharing one composition, each with its
    insolation scale and T_g; every step of every member from JAX's carry
    (the port steps them as one batch: one matmul over the bands with the
    members as its N).  f64, 300 steps: T within 1e-8 K (measured 3.0e-9),
    t and dt within 1e-8 relative (measured 1.0e-9: near equilibrium the
    controlling tendency is ~1e-8 of the band fluxes it is the difference
    of), the controller, threshold and flags equal.  f32, 60
    steps: T within 0.1 K, and within 1e-3 K on the active cells (tau >
    0.03), the bounds of the single column (test_torch_real_gas.py)."""
    jw = jrg.RealGas(dtype=DTYPES[dtype][0], **earth_kw(earth_folder))
    n = 300 if dtype == 'f64' else 60
    carry, rec = _ensemble_lockstep(jw, F_SCALES, [265.19, 260.0, 270.0,
                                                   265.19], 1e-3, n)
    dT = steps_of(rec, 'dT')
    flips = int((~steps_of(rec, 'ind_same')).sum())
    print(f'{dtype}: {len(rec)} steps, max |dT| {dT.max():.3g} K, {flips} '
          f'controller flips, JAX equilibrium {np.asarray(carry[4])}')
    assert len(rec) > 50
    if dtype == 'f64':
        assert dT.max() <= 1e-8
        assert steps_of(rec, 'rel_t').max() <= 1e-8
        assert steps_of(rec, 'rel_dt').max() <= 1e-8
        assert flips == 0 and steps_of(rec, 'flags_same').all()
        assert steps_of(rec, 'ft_same').all()
    else:
        assert dT.max() <= 0.1
        act = active_cells(jw.tau_interface)
        lev = np.concatenate([r['dT_lev'][r['go']] for r in rec])
        assert lev[:, act].max() <= 1e-3


def _compos_pair(co2_ppmv):
    kw = lambda hum, c: dict(  # noqa: E731
        nz=24, ny=1, molecule_names=['single_line'], T_g=260.0,
        q_funcs={'single_line': hum.co2},
        q_funcs_args={'single_line': (c, 80000)}, delta_temp_change=0.1,
        n_nu_bands=30)
    jws = [jrg.RealGas(dtype=jnp.float64, **kw(jhum, c)) for c in co2_ppmv]
    pws = [prg.RealGas(dtype=torch.float64, device='cpu', **kw(phum, c))
           for c in co2_ppmv]
    return jws, pws


def test_stacked_tau_ensemble_step_by_step_matches_jax():
    """stacked_tau: three compositions of the single-line column (180, 370
    and 740 ppmv), each member with its own cache; every step from JAX's
    carry (f64), until JAX's march stops: T within 1e-7 K (measured 1.6e-8,
    on the 740 ppmv member near its equilibrium, where dt is largest), the
    controller and flags equal.  The inputs of real_gas_compos_ensemble
    equal JAX's."""
    jws, pws = _compos_pair([180, 370, 740])
    sj, scj, tgj, args = jens.real_gas_compos_ensemble(jws)
    sp, scp, tgp, argp = pens.real_gas_compos_ensemble(pws)
    np.testing.assert_array_equal(argp[0].numpy(), np.asarray(args[0]))
    np.testing.assert_array_equal(sp.T.numpy(), np.asarray(sj.T))
    np.testing.assert_array_equal(tgp.numpy(), np.asarray(tgj))
    carry, rec = rg_lockstep(sj, scj, tgj, *args, 1e-4, max_steps=300,
                             t_end=20.0, stacked=True)
    dT = steps_of(rec, 'dT')
    print(f'stacked: {len(rec)} steps, max |dT| {dT.max():.3g} K')
    assert len(rec) > 20
    assert dT.max() <= 1e-7
    assert (steps_of(rec, 'ind_same').all()
            and steps_of(rec, 'flags_same').all())
    with pytest.raises(ValueError, match='share nz'):
        pens.real_gas_compos_ensemble(
            [pws[0], prg.RealGas(dtype=torch.float64, device='cpu',
                                 **single_line_kw(phum, nz=30))])


def test_ensemble_free_running_and_bf16_path():
    """The port's own ensemble march of the single-line column (f32, 2
    members, shared cache, and stacked over the same composition): every
    member stops cleanly, the stacked march equals the shared one bit for
    bit, and the bf16 cache lands within the solo column's 0.6 K of the f32
    one on the active cells (tests/test_real_gas_perf_modes.py:100-113)."""
    kw = dict(nz=40, ny=1, molecule_names=['single_line'], T_g=260.0,
              q_funcs={'single_line': phum.co2},
              q_funcs_args={'single_line': ()}, delta_temp_change=0.1,
              dtype=torch.float32, device='cpu')
    gas = prg.RealGas(**kw)
    states, sc, T_gs, args = pens.real_gas_ensemble(gas, F_scales=[1.0, 1.1])
    out32, info = pens.real_gas_evolve_ensemble(states, sc, T_gs, *args,
                                                1e-2, t_end=20.0)
    assert not bool(info.nan.any() | info.failed.any())
    assert bool((info.equilibrium | info.timed_out).all())
    taus = torch.stack([args[0], args[0]])
    out_st, _ = pens.real_gas_evolve_ensemble(states, sc, T_gs, taus,
                                              *args[1:], 1e-2, t_end=20.0,
                                              stacked_tau=True)
    assert torch.equal(out_st.T, out32.T)
    out16, info16 = pens.real_gas_evolve_ensemble(
        states, sc, T_gs, *args, 1e-2, t_end=20.0,
        cache_dtype=torch.bfloat16)
    act = active_cells(gas.tau_interface, 0.3)
    err = (out32.T - out16.T).abs()[:, act, 0]
    print(f'bf16 ensemble: {float(err.max()):.3f} K')
    assert float(err.max()) < 0.6
    assert not bool(info16.nan.any() | info16.failed.any())


@pytest.mark.parametrize('stacked', [False, True])
def test_find_Tg_ensemble_matches_jax(stacked):
    """real_gas_find_Tg_ensemble (a vectorised secant, one ensemble march a
    trial): the port's T_g of every member within the solve's tol (0.5 K)
    of JAX's, every member converged, for 3 insolation scales of one
    composition and for 3 compositions (stacked_tau)."""
    if stacked:
        jws, pws = _compos_pair([180, 370, 740])
        inj = jens.real_gas_compos_ensemble(jws)
        inp = pens.real_gas_compos_ensemble(pws)
    else:
        kw = lambda h: single_line_kw(h, nz=24)  # noqa: E731
        jw = jrg.RealGas(dtype=jnp.float64, **kw(jhum))
        pw = prg.RealGas(dtype=torch.float64, device='cpu', **kw(phum))
        inj = jens.real_gas_ensemble(jw, F_scales=[0.95, 1.0, 1.05])
        inp = pens.real_gas_ensemble(pw, F_scales=[0.95, 1.0, 1.05])
    Tg_j, _, out_j = jens.real_gas_find_Tg_ensemble(*inj, flux_thresh=0.1,
                                                    tol=0.5,
                                                    stacked_tau=stacked)
    Tg_p, st_p, out_p = pens.real_gas_find_Tg_ensemble(
        *inp, flux_thresh=0.1, tol=0.5, stacked_tau=stacked)
    print(f'stacked={stacked}: JAX {np.asarray(Tg_j)}, port {Tg_p.numpy()}, '
          f'iterations {out_j["iterations"]} / {out_p["iterations"]}')
    assert bool(out_p['converged'].all())
    assert np.abs(Tg_p.numpy() - np.asarray(Tg_j)).max() <= 0.5
    assert float(st_p.t.abs().max()) == 0.0
    assert rel(st_p.tsi.delta_t.numpy(), np.asarray(
        inj[0].tsi.delta_t)) == 0.0
