"""Port vs JAX: the real-gas band column (``models/real_gas.py``) and the two
things its march adds to the column machinery (``p_descending=False`` and a
net flux function returning (net, net_diff)).

Small sizes: the single-line toy gas at nz 24-50 with 30 bands, and the
4-gas fabricated earth column at nz = 40.  The earth tables are built once
per module by the port into a temporary folder; the JAX package reads the
same files (they are bit-equal to its own ``backend='numpy'`` build,
``test_torch_spectral.py``), so both start from the same tau.

The march is held step by step from a shared carry (:func:`rg_lockstep`):
JAX's vmapped real-gas march body drives the trajectory, and before every
step the port takes the same carry and the JAX package's own transmission
operators (``utils/interop.transmission_cache_from_numpy``).  Free-running
marches part in the last bit (ROADMAP, Queue 3), so endpoints are
never compared across packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.models import column as jcol
from climatemodel_tpu.models import real_gas as jrg
from climatemodel_tpu.spectral import humidity as jhum
from climatemodel_tpu_torch.models import column as pcol
from climatemodel_tpu_torch.models import real_gas as prg
from climatemodel_tpu_torch.spectral import earth_tables as pet
from climatemodel_tpu_torch.spectral import humidity as phum
from climatemodel_tpu_torch.utils import interop

DTYPES = {'f64': (jnp.float64, torch.float64),
          'f32': (jnp.float32, torch.float32)}
EARTH = ['CO2', 'CH4', 'H2O', 'O3']


def single_line_kw(hum, nz=30, T_g=260.0, **kw):
    """The single-line toy column (bench.py:200's gas) at 30 bands."""
    return dict(nz=nz, ny=1, molecule_names=['single_line'], T_g=T_g,
                q_funcs={'single_line': hum.co2},
                q_funcs_args={'single_line': ()}, delta_temp_change=0.1,
                n_nu_bands=30, **kw)


def earth_kw(folder, nz=40, **kw):
    """The 4-gas earth column (test_earth_tables.py:102) at nz = 40."""
    return dict(nz=nz, ny=1, molecule_names=EARTH, T_g=265.19, p_toa=0.1,
                temp_change=1, delta_temp_change=0.1, table_folder=folder,
                **kw)


@pytest.fixture(scope='module')
def earth_folder(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp('lut'))
    _, built = pet.ensure_earth_tables(folder)
    assert set(built) == set(EARTH)
    return folder


def pair(kw_of, dtype='f64', **kw):
    """(JAX world, port world on the CPU) from one keyword recipe."""
    jd, pd = DTYPES[dtype]
    jw = jrg.RealGas(dtype=jd, **kw_of(jhum), **kw)
    pw = prg.RealGas(dtype=pd, device='cpu', **kw_of(phum), **kw)
    return jw, pw


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def as_dict(x):
    return {k: (None if v is None else np.asarray(v)) for k, v in
            dataclasses.asdict(jax.device_get(x)).items()}


# --------------------------------------------------------------------------
# the lockstep march
# --------------------------------------------------------------------------

def _jax_step_fn(ba, F, delta, p_int, p_c, *, t_end, max_steps, stacked,
                 convective_adjust, conv_method):
    """jit(vmap) of one step of JAX's real-gas march body with the vmapped
    while-loop's freeze (models/real_gas.py:366-390, models/ensemble.py:
    310-325)."""
    def one(carry, scale, T_g, cache, t0):
        def net_fn(T):
            return jrg.real_gas_net_and_diff_cached(
                T[:, 0], T_g, cache, ba, F * scale, delta)
        body = jcol._march_body(
            net_fn, p_int, p_c, t0, convective_adjust=convective_adjust,
            t_end=t_end, conv_thresh=1e-5, conv_t_multiplier=5.0,
            net_flux_thresh=1e-7, net_flux_percentile=95, p_descending=False,
            use_delta_exit=True, conv_method=conv_method)
        _st, _ft, _d, i, eqb, failed, nan, tout = carry
        go = ~eqb & ~tout & ~failed & ~nan & (i < max_steps)
        new = body(carry)
        return jax.tree_util.tree_map(lambda n, o: jnp.where(go, n, o),
                                      new, carry), go
    return jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0 if stacked else None,
                                          0)))


def rg_lockstep(jstates, scales, T_gs, tau, ba, F, delta, p_int, p_c,
                flux_thresh, *, max_steps, t_end=4.0, stacked=False,
                cache_dtype=None, convective_adjust=False,
                conv_method='reference'):
    """March JAX's batched real-gas states step by step; before every step
    hand the same carry (and JAX's transmission operators) to the port's
    ``column.march_step``.  Returns (JAX final carry, records): per step,
    the members that stepped and the port-minus-JAX differences after it."""
    dt_j = jstates.T.dtype
    dt_p = {jnp.float64: torch.float64, jnp.float32: torch.float32}[
        jnp.dtype(dt_j).type]
    if stacked:
        cache = jax.vmap(lambda t: jrg.precompute_transmission(
            t, ba, cache_dtype))(tau)
    else:
        cache = jrg.precompute_transmission(tau, ba, cache_dtype)
    step = _jax_step_fn(ba, F, delta, p_int, p_c, t_end=t_end,
                        max_steps=max_steps, stacked=stacked,
                        convective_adjust=convective_adjust,
                        conv_method=conv_method)
    B = jstates.T.shape[0]
    f = lambda v, d=dt_j: jnp.full((B,), v, d)  # noqa: E731
    carry = (jstates, f(flux_thresh), f(1e6), f(0, jnp.int32),
             f(False, bool), f(False, bool), f(False, bool), f(False, bool))
    t0 = jstates.t

    tp = lambda x: torch.tensor(np.asarray(x)).to(dt_p)  # noqa: E731
    cache_p = interop.transmission_cache_from_numpy(as_dict(cache), 'cpu',
                                                    dt_p)
    ba_p = interop.band_arrays_from_numpy(as_dict(ba), 'cpu', dt_p)
    net_fn = prg.real_gas_net_fn(tp(T_gs), cache_p, ba_p,
                                 tp(F)[None] * tp(scales)[:, None], tp(delta))
    p_int_p = tp(p_int)
    conv_kw = dict(convective_adjust=True, conv_method=conv_method,
                   p_centre_col=tp(p_c), p_descending=False
                   ) if convective_adjust else {}
    t0_p = torch.tensor(np.asarray(t0))
    records = []
    while True:
        new, go = step(carry, scales, T_gs, cache, t0)
        go = np.asarray(go)
        if not go.any():
            return carry, records
        host = jax.device_get(carry)
        st_p = interop.column_state_from_numpy(dataclasses.asdict(host[0]),
                                               device='cpu', dtype=dt_p)
        out = pcol.march_step(st_p, torch.tensor(host[1]),
                              torch.tensor(host[3]), t0_p, net_fn, p_int_p,
                              t_end=t_end, **conv_kw)
        st_j, ft_j, _delta_j, _i, *flags_j = jax.device_get(new)
        st_q, ft_q, _delta_q, *flags_q = out
        r = lambda a, b: np.abs(a - b) / np.maximum(  # noqa: E731
            np.abs(b), np.finfo(b.dtype).tiny)
        records.append(dict(
            go=go, dT_lev=np.abs(st_q.T.numpy() - st_j.T).reshape(B, -1),
            dT=np.abs(st_q.T.numpy() - st_j.T).reshape(B, -1).max(1),
            rel_t=r(st_q.t.numpy(), st_j.t),
            rel_dt=r(st_q.tsi.dt.numpy(), st_j.tsi.dt),
            ind_same=st_q.tsi.max_tend_ind.numpy() == st_j.tsi.max_tend_ind,
            flags_same=np.all([q.numpy() == j for q, j in
                               zip(flags_q, flags_j)], axis=0),
            ft_same=ft_q.numpy() == ft_j,
            conv_flips=(st_q.tsi.convective.numpy()
                        != st_j.tsi.convective).sum(1),
            n_conv=np.asarray(st_j.tsi.convective).sum(1)))
        carry = new


def steps_of(records, key):
    return np.concatenate([r[key][r['go']] for r in records])


def world_lockstep(jw, flux_thresh, max_steps, **kw):
    """:func:`rg_lockstep` of a single JAX world (a batch of one)."""
    dt = jw.dtype
    st = jax.tree_util.tree_map(lambda x: x[None], jw.state)
    return rg_lockstep(
        st, jnp.ones((1,), dt), jnp.full((1,), jw.T_g, dt), jw.tau_device,
        jw.band_arrays, jw._F_star_factor,
        jnp.asarray(jw.nu_bands['delta'], dt), jnp.asarray(jw.p_interface, dt),
        jnp.asarray(jw.p[:, 0], dt), flux_thresh, max_steps=max_steps, **kw)


# --------------------------------------------------------------------------
# construction: grids, bands, tau, weights, initial fluxes
# --------------------------------------------------------------------------

@pytest.mark.parametrize('nz', [24, 50, 'auto'])
def test_single_line_construction_matches_jax(nz):
    """Host grids bit-equal: the pressure grid (fixed nz and 'auto'), the
    wavenumber grid and bands, the packed bands, tau, the flux-integral
    weights and the spline matrix S.  The initial band fluxes (f64) within
    1e-12 relative."""
    jw, pw = pair(lambda h: single_line_kw(h, nz=nz))
    assert jw.nz == pw.nz
    for name in ('p_interface', 'p', 'nu', 'nu_lw', 'nu_sw', 'tau_interface',
                 '_W_up', '_W_down', '_S'):
        np.testing.assert_array_equal(getattr(pw, name), getattr(jw, name),
                                      name)
    for k in ('centre', 'delta', 'sw'):
        np.testing.assert_array_equal(pw.nu_bands[k], jw.nu_bands[k], k)
    for k in ('idx', 'w', 'lw_idx', 'lw_w', 'lw_list'):
        np.testing.assert_array_equal(getattr(pw._packed, k),
                                      getattr(jw._packed, k), k)
    assert rel(pw.up_flux, jw.up_flux) <= 1e-12
    assert rel(pw.down_flux, jw.down_flux) <= 1e-12
    assert rel(pw.net_flux, jw.net_flux) <= 1e-12
    assert pw.state.T.shape == (1, pw.nz - 1, 1)
    assert pw.state.net_flux.device.type == 'cpu'


def test_earth_construction_and_fluxes_match_jax(earth_folder):
    """The 4-gas column at nz = 40: tau and the grids bit-equal; fluxes and
    the OLR breakdown (real_gas.py:643-665) within 1e-12 relative in f64."""
    jw, pw = pair(lambda h: earth_kw(earth_folder))
    np.testing.assert_array_equal(pw.tau_interface, jw.tau_interface)
    np.testing.assert_array_equal(pw.p_interface, jw.p_interface)
    up_j, down_j, olr_j = jw.get_flux(include_olr_breakdown=True)
    up_p, down_p, olr_p = pw.get_flux(include_olr_breakdown=True)
    assert rel(up_p, up_j) <= 1e-12 and rel(down_p, down_j) <= 1e-12
    for k in ('surface', 'atmos'):
        assert rel(olr_p[k], olr_j[k]) <= 1e-12, k
    np.testing.assert_allclose(olr_p['surface'] + olr_p['atmos'], up_p[0],
                               rtol=1e-12)


@pytest.mark.parametrize('cache_dtype', [None, 'bf16'])
@pytest.mark.parametrize('dtype', ['f64', 'f32'])
def test_net_and_diff_and_fluxes_match_jax(earth_folder, dtype, cache_dtype):
    """real_gas_fluxes_cached, real_gas_fluxes, _net_and_diff and the march
    path real_gas_net_and_diff_cached of both layouts, from the same cache
    and a perturbed temperature profile, for 3 members with their own T_g
    and insolation scale.  f64: within 1e-12 relative of the flux scale.
    f32: within 2e-5 of it (XLA's and PyTorch's exp and matmul orders; the
    largest of the two packages' own f32-vs-f64 errors is of that size)."""
    jd, pd = DTYPES[dtype]
    jw = jrg.RealGas(dtype=jd, **earth_kw(earth_folder))
    cd_j = None if cache_dtype is None else jnp.bfloat16
    cache = jrg.precompute_transmission(jw.tau_device, jw.band_arrays, cd_j)
    ba = jw.band_arrays
    delta = jnp.asarray(jw.nu_bands['delta'], jd)
    rng = np.random.default_rng(7)
    T = jw.T[:, 0][None] + rng.normal(0, 5, (3, jw.nz - 1))
    T_g = np.array([265.19, 250.0, 280.0])
    scales = np.array([1.0, 0.9, 1.1])
    F = jw._F_star_factor

    cache_p = interop.transmission_cache_from_numpy(as_dict(cache), 'cpu', pd)
    ba_p = interop.band_arrays_from_numpy(as_dict(ba), 'cpu', pd)
    tp = lambda x: torch.tensor(np.asarray(x)).to(pd)  # noqa: E731
    F_p = tp(F)[None] * tp(scales)[:, None]
    bound = 1e-12 if dtype == 'f64' else 2e-5

    outs_p = prg.real_gas_net_and_diff_cached(tp(T), tp(T_g), cache_p, ba_p,
                                              F_p, tp(delta))
    up_p, down_p = prg.real_gas_fluxes_cached(tp(T), tp(T_g), cache_p, ba_p,
                                              F_p)
    nd_p = prg._net_and_diff(up_p, down_p, tp(delta))
    for k in range(3):
        Tk, Tgk = jnp.asarray(T[k], jd), jnp.asarray(T_g[k], jd)
        net_j, diff_j = jrg.real_gas_net_and_diff_cached(
            Tk, Tgk, cache, ba, F * scales[k], delta)
        scale = float(jnp.abs(net_j).max())
        up_j, down_j = jrg.real_gas_fluxes_cached(Tk, Tgk, cache, ba,
                                                  F * scales[k])
        fl_scale = float(jnp.maximum(jnp.abs(up_j).max(),
                                     jnp.abs(down_j).max()))
        assert np.abs(outs_p[0][k].numpy() - np.asarray(net_j)[:, 0]).max() \
            <= bound * scale
        assert np.abs(outs_p[1][k].numpy() - np.asarray(diff_j)[:, 0]).max() \
            <= bound * scale
        assert np.abs(up_p[k].numpy() - np.asarray(up_j)).max() \
            <= bound * fl_scale
        assert np.abs(down_p[k].numpy() - np.asarray(down_j)).max() \
            <= bound * fl_scale
        net2_j, diff2_j = jrg._net_and_diff(up_j, down_j, delta)
        assert np.abs(nd_p[0][k].numpy() - np.asarray(net2_j)[:, 0]).max() \
            <= bound * scale
        assert np.abs(nd_p[1][k].numpy() - np.asarray(diff2_j)[:, 0]).max() \
            <= bound * scale
    if cache_dtype is None:
        # the uncached flux folds its own transmission from tau
        up_u, down_u = prg.real_gas_fluxes(tp(T[:1]), tp(T_g[:1]),
                                           tp(jw.tau_device), ba_p, tp(F))
        up_j, down_j = jrg.real_gas_fluxes(
            jnp.asarray(T[0], jd), jnp.asarray(T_g[0], jd), jw.tau_device,
            ba, F)
        assert np.abs(up_u[0].numpy() - np.asarray(up_j)).max() <= \
            bound * float(jnp.abs(up_j).max())
        assert np.abs(down_u[0].numpy() - np.asarray(down_j)).max() <= \
            bound * float(jnp.abs(down_j).max())


# --------------------------------------------------------------------------
# the column machinery: p_descending=False and net_diff
# --------------------------------------------------------------------------

@pytest.mark.parametrize('conv', [None, 'reference', 'isotonic'])
def test_update_temp_toa_first_with_net_diff_matches_jax(earth_folder, conv):
    """One ``update_temp`` of a TOA-first column with the caller's net_diff,
    radiative and with each convective adjustment (the isotonic one through
    the plain K4 twin on the CPU), from the same f64 state: T, t and dt
    within 1e-12 relative (T within 1e-8 for 'isotonic', whose fit
    amplifies its prefix sums' rounding ~3e5 times, ROADMAP Queue 3), the
    controller's index and masks equal.  The state is the earth column with
    a superadiabatic lowest 10 cells (T ~ p^0.4), so the adjustment acts
    there, past the first step."""
    jw = jrg.RealGas(dtype=jnp.float64, **earth_kw(earth_folder))
    st = jw.state
    p = jw.p[:, 0]
    T0 = np.asarray(st.T)[:, 0].copy()
    T0[-10:] = T0[-10] * (p[-10:] / p[-10]) ** 0.4
    st = st.replace(T=jnp.asarray(T0[:, None]), t=jnp.asarray(1e5))
    cache = jrg.precompute_transmission(jw.tau_device, jw.band_arrays)
    delta = jnp.asarray(jw.nu_bands['delta'])
    p_int = jnp.asarray(jw.p_interface)
    p_c = jnp.asarray(jw.p[:, 0])
    net, diff = jrg.real_gas_net_and_diff_cached(
        st.T[:, 0], jnp.asarray(jw.T_g), cache, jw.band_arrays,
        jw._F_star_factor, delta)
    kw = dict(convective_adjust=conv is not None,
              conv_method=conv or 'reference')
    st_j, delta_j = jcol.update_temp(st, net, p_int, p_c, p_descending=False,
                                     net_flux_diff=diff, **kw)

    st_p = interop.column_state_from_numpy(
        dataclasses.asdict(jax.device_get(st)), 'cpu', torch.float64)
    conv_kw = dict(convective_adjust=True, conv_method=conv,
                   p_centre_col=torch.tensor(np.asarray(p_c))) if conv else {}
    st_q, delta_q = pcol.update_temp(
        st_p, torch.tensor(np.asarray(net))[None],
        torch.tensor(np.asarray(p_int)), p_descending=False,
        net_flux_diff=torch.tensor(np.asarray(diff))[None], **conv_kw)
    assert rel(st_q.T[0].numpy(), st_j.T) <= (1e-8 if conv == 'isotonic'
                                              else 1e-12)
    assert rel(st_q.t.numpy(), st_j.t) <= 1e-12
    assert rel(st_q.tsi.dt.numpy(), st_j.tsi.dt) <= 1e-12
    assert rel(delta_q.numpy(), delta_j) <= 1e-12
    for name in ('max_tend_ind', 'removed', 'convective'):
        np.testing.assert_array_equal(getattr(st_q.tsi, name)[0].numpy(),
                                      np.asarray(getattr(st_j.tsi, name)))
    if conv:
        assert bool(np.asarray(st_j.tsi.convective).any())
    # the net_diff is what the tendency uses: twice it halves dt
    st_r, _ = pcol.update_temp(st_p, torch.tensor(np.asarray(net))[None],
                               torch.tensor(np.asarray(p_int)),
                               p_descending=False,
                               net_flux_diff=2 * torch.tensor(
                                   np.asarray(diff))[None], **conv_kw)
    assert rel(2 * st_r.tsi.dt.numpy(), st_q.tsi.dt.numpy()) <= 1e-15


# --------------------------------------------------------------------------
# marches, step by step from a shared carry
# --------------------------------------------------------------------------

def _lockstep_summary(rec):
    dT = steps_of(rec, 'dT')
    return (dT, int((~steps_of(rec, 'ind_same')).sum()),
            int((~steps_of(rec, 'flags_same')).sum()))


def active_cells(tau_interface, thresh=0.03):
    """Cells whose lower interface has tau > thresh at some wavenumber (the
    optically active levels; the thin TOA levels carry a tendency that is
    f32 rounding noise in both packages)."""
    return np.asarray(tau_interface).max(axis=1)[1:] > thresh


@pytest.mark.parametrize('case', ['single_line_f64', 'earth_f64',
                                  'single_line_f32', 'earth_f32'])
def test_march_step_by_step_matches_jax(earth_folder, case):
    """The per-step march (``_real_gas_evolve``), every step from JAX's
    carry and operators.

    f64, until JAX's march stops or 300 steps: T within 1e-8 K (measured
    1.4e-9 single line, 4.1e-9 earth: near equilibrium dt reaches ~1e7 s and
    moves T by dt g/c_p E/dp for a net_diff rounding E), t and dt within
    1e-9 relative, the controlling level, the threshold and the exit flags
    equal at every step.

    f32, the first 60 steps: T within 0.1 K on every level (measured
    0.017 K single line, 0.03 K earth).  The tendency is a difference of
    ~1e2 W/m^2 band fluxes, so in f32 it carries ~3e-3 relative rounding
    noise in both packages (more at the earth column's thin TOA levels,
    where it is all noise), and the controlling level of the near-isothermal
    single-line column flips from the first step.  On the earth column's
    active cells (tau > 0.03) the steps agree within 1e-3 K, the bound the
    card-vs-CPU check of chip_smoke.py holds (measured 4.6e-5 K)."""
    name, dtype = case.rsplit('_', 1)
    if name == 'earth':
        jw = jrg.RealGas(dtype=DTYPES[dtype][0], **earth_kw(earth_folder))
        ft = 1e-3
    else:
        jw = jrg.RealGas(dtype=DTYPES[dtype][0], **single_line_kw(jhum))
        ft = 1e-4
    n = 300 if dtype == 'f64' else 60
    carry, rec = world_lockstep(jw, ft, max_steps=n, t_end=20.0)
    dT, ind_flips, flag_flips = _lockstep_summary(rec)
    print(f'{case}: {len(rec)} steps, max |dT| {dT.max():.3g} K, '
          f'{ind_flips} controller and {flag_flips} flag flips, JAX '
          f'equilibrium {bool(np.asarray(carry[4])[0])}')
    assert len(rec) > 50
    if dtype == 'f64':
        assert dT.max() <= 1e-8
        assert steps_of(rec, 'rel_t').max() <= 1e-9
        assert steps_of(rec, 'rel_dt').max() <= 1e-9
        assert ind_flips == 0 and flag_flips == 0
        assert steps_of(rec, 'ft_same').all()
    else:
        assert dT.max() <= 0.1
        if name == 'earth':
            act = active_cells(jw.tau_interface)
            dT_act = np.stack([r['dT_lev'][0] for r in rec])[:, act]
            assert dT_act.max() <= 1e-3


@pytest.mark.parametrize('method', ['reference', 'isotonic'])
def test_convective_march_step_by_step_matches_jax(earth_folder, method):
    """The radiative-convective march of the earth column (TOA-first
    adjustment; K4's plain twin for 'isotonic'), f64, every step from JAX's
    carry until JAX's march stops or 300 steps: the controller, the flags
    and the convective masks equal at every step, with up to 14 convective
    levels.  T within 1e-8 K for 'reference' (measured 2.5e-9); within
    1e-6 K for 'isotonic' (measured 5.3e-7: the fit amplifies the rounding
    of its prefix sums ~3e5 times, and the port forms them by its own rule,
    ROADMAP Queue 3)."""
    jw = jrg.RealGas(dtype=jnp.float64, **earth_kw(earth_folder))
    carry, rec = world_lockstep(jw, 1e-3, max_steps=300, t_end=20.0,
                                convective_adjust=True, conv_method=method)
    dT, ind_flips, flag_flips = _lockstep_summary(rec)
    conv_flips = int(steps_of(rec, 'conv_flips').sum())
    print(f'{method}: {len(rec)} steps, max |dT| {dT.max():.3g} K, '
          f'{conv_flips} convective-mask flips')
    assert len(rec) > 100
    assert steps_of(rec, 'n_conv').max() > 0
    assert dT.max() <= (1e-8 if method == 'reference' else 1e-6)
    assert ind_flips == 0 and flag_flips == 0 and conv_flips == 0


# --------------------------------------------------------------------------
# the march options, within the port: each is the per-step march
# --------------------------------------------------------------------------

def _fresh(kw_of=None, dtype=torch.float64, **kw):
    return prg.RealGas(dtype=dtype, device='cpu',
                       **(kw_of or single_line_kw)(phum), **kw)


def test_march_options_equal_the_per_step_march():
    """``check_every`` with ``dip_memory``, ``debug``, ``chunk_steps`` and
    the ``save=True`` snapshot march (default chunks and chunks of 7) end
    bit-equal to the per-step march; the snapshot trajectory holds every
    step, and its last temperature is the endpoint.  The per-step march is
    held to JAX step by step above."""
    ref = _fresh()
    ref.evolve_to_equilibrium(flux_thresh=1e-4, t_end=20.0)
    steps = int(ref._equilibrium_info.steps)
    runs = {
        'dip': dict(check_every=4, dip_memory=True),
        'debug': dict(debug=True),
        'chunked': dict(chunk_steps=7),
        'save': dict(save=True),
        'save_7': dict(save=True, chunk_steps=7),
    }
    for name, kw in runs.items():
        w = _fresh()
        data = w.evolve_to_equilibrium(flux_thresh=1e-4, t_end=20.0, **kw)
        np.testing.assert_array_equal(w.T, ref.T, name)
        assert int(w._equilibrium_info.steps) == steps, name
        assert float(w.state.t[0]) == float(ref.state.t[0]), name
        if kw.get('save'):
            assert len(data['t']) == steps + 1
            np.testing.assert_array_equal(data['T'][-1], ref.T)
    # check_every without dip_memory: the exit is checked every 4th step,
    # so the march may run up to 3 steps past the per-step exit
    w = _fresh()
    w.evolve_to_equilibrium(flux_thresh=1e-4, t_end=20.0, check_every=4)
    assert steps <= int(w._equilibrium_info.steps) <= steps + 3


def test_save_snapshot_fluxes_match_jax():
    """save=True with 'flux' records the lw/sw-split band sums at every
    step's post-step temperature (real_gas.py:720-746); each is held to the
    JAX package's fluxes at that temperature within 1e-12 of the flux
    scale (f64).  save_data appends the same sums of the current state."""
    w = _fresh()
    keys = ('lw_up', 'lw_down', 'sw_up', 'sw_down')
    data = {'t': [0.0], 'T': [w.T], 'flux': {k: [] for k in keys}}
    data = w.evolve_to_equilibrium(data, flux_thresh=1e-4, t_end=20.0,
                                   save=True, chunk_steps=16)
    n = len(data['t']) - 1
    assert all(len(data['flux'][k]) == n for k in keys) and n > 20
    jw = jrg.RealGas(dtype=jnp.float64, **single_line_kw(jhum))
    sw = jw.nu_bands['sw']
    d = jw.nu_bands['delta']
    for k in (0, n // 2, n - 1):
        up, down = jrg.real_gas_fluxes(jnp.asarray(data['T'][k + 1][:, 0]),
                                       jnp.asarray(jw.T_g), jw.tau_device,
                                       jw.band_arrays, jw._F_star_factor)
        up, down = np.asarray(up), np.asarray(down)
        want = {'lw_up': up @ np.where(sw, 0, d),
                'lw_down': down @ np.where(sw, 0, d),
                'sw_up': up @ np.where(sw, d, 0),
                'sw_down': down @ np.where(sw, d, 0)}
        for key in keys:
            assert np.abs(data['flux'][key][k] - want[key]).max() <= \
                1e-12 * np.abs(want[key]).max(), (k, key)
    data = w.save_data(data, 1.0)
    for key in keys:
        np.testing.assert_allclose(data['flux'][key][-1],
                                   data['flux'][key][-2], rtol=1e-12)


def test_take_time_step_matches_jax():
    """Ten ``take_time_step`` calls, each from JAX's state handed to the
    port: T and the net flux within 1e-12 relative (f64); t and the delta
    statistic within 1e-11 (measured 2.4e-12: take_time_step, like JAX's,
    differences the two band sums directly, so the tendency that sets dt
    carries the cancellation's rounding).  The port's take_time_step takes
    the full-precision cache, JAX's folds the transmission every call."""
    jw, pw = pair(single_line_kw)
    t = 0.0
    for _ in range(10):
        pw._state = interop.column_state_from_numpy(
            dataclasses.asdict(jax.device_get(jw.state)), 'cpu',
            torch.float64)
        tj, dj = jw.take_time_step(t)
        tq, dq = pw.take_time_step(t)
        assert abs(tq - tj) <= 1e-11 * abs(tj) and \
            abs(dq - dj) <= 1e-11 * abs(dj)
        assert rel(pw.T, jw.T) <= 1e-12
        assert rel(pw.net_flux, jw.net_flux) <= 1e-12
        t = tj


def test_earth_column_reaches_equilibrium(earth_folder):
    """The flagship 4-gas march (real_gas_script.py:56) at nz = 40, f64,
    reaches TRUE equilibrium by t_end=50, as tests/test_earth_tables.py
    asserts for JAX; and again in f32."""
    for dtype in (torch.float64, torch.float32):
        w = prg.RealGas(dtype=dtype, device='cpu', **earth_kw(earth_folder))
        assert w.nz == 40 and np.isfinite(w.net_flux).all()
        w.evolve_to_equilibrium(flux_thresh=1e-3, save=False, t_end=50.0)
        info = w._equilibrium_info
        assert bool(info.equilibrium) and not bool(info.timed_out) \
            and not bool(info.failed)
        assert np.isfinite(w.T).all() and 80 < w.T.min() and w.T.max() < 500


def test_bf16_cache_close_to_f32():
    """The bf16 cache (row-differenced layout, upcast before each product)
    against the f32 cache on the single-line column of
    tests/test_real_gas_perf_modes.py:40-54 (nz = 40, f32, flux_thresh
    1e-2, t_end 20): the equilibria of the optically active cells (tau >
    0.3) within that test's bound, 0.6 K."""
    kw = dict(nz=40, ny=1, molecule_names=['single_line'], T_g=260.0,
              q_funcs={'single_line': phum.co2},
              q_funcs_args={'single_line': ()}, delta_temp_change=0.1,
              dtype=torch.float32, device='cpu')
    ref = prg.RealGas(**kw)
    ref.evolve_to_equilibrium(flux_thresh=1e-2, t_end=20.0)
    fast = prg.RealGas(cache_dtype=torch.bfloat16, **kw)
    cache = fast.transmission(torch.bfloat16)
    assert cache.M_sum is None and cache.D_sum.dtype == torch.bfloat16
    assert cache.row0_sum.dtype == torch.float32
    fast.evolve_to_equilibrium(flux_thresh=1e-2, t_end=20.0)
    act = active_cells(ref.tau_interface, 0.3)
    err = np.abs(ref.T[:, 0] - fast.T[:, 0])[act]
    print(f'bf16 vs f32: {err.max():.3f} K on {act.sum()} active cells')
    assert float(err.max()) < 0.6
    assert np.isfinite(fast.T).all()


def test_Tg_solvers_match_jax():
    """``inital_Tg_guess`` (T_g=None: Newton on the initial column net flux,
    real_gas.py:505-528) gives JAX's T_g within 1e-9 K and the same rebuilt
    bands; ``find_Tg`` (a full march per secant iteration) lands within its
    tol (0.5 K) of JAX's."""
    jw, pw = pair(lambda h: single_line_kw(h, nz=24, T_g=None))
    assert abs(pw.T_g - jw.T_g) <= 1e-9
    np.testing.assert_array_equal(pw.nu_bands['centre'],
                                  jw.nu_bands['centre'])
    assert rel(pw.net_flux, jw.net_flux) <= 1e-9
    Tg_j = jw.find_Tg(flux_thresh=0.1, tol=0.5)
    Tg_p = pw.find_Tg(flux_thresh=0.1, tol=0.5)
    print(f'find_Tg: JAX {Tg_j:.4f} K, port {Tg_p:.4f} K')
    assert abs(Tg_p - Tg_j) <= 0.5


def test_evolve_change_compos_and_debug_error():
    """evolve_change_compos re-equilibrates after each stage and restarts
    the next one at full delta_t; a debug march that meets a non-finite
    temperature names it."""
    w = _fresh()
    data = w.evolve_change_compos([255.0, 265.0], [{'single_line': ()}] * 2,
                                  flux_thresh=1e-2, t_end=0.5)
    assert w.T_g == 265.0 and len(data['t']) == 3
    assert float(w.state.tsi.delta_t[0]) == float(w.state.tsi.max_delta_t[0])
    bad = _fresh()
    T = bad.T.copy()
    T[3] = np.nan
    bad.T = T
    with pytest.raises(pcol.MarchDebugError, match='non-finite'):
        bad.evolve_to_equilibrium(flux_thresh=1e-4, debug=True)
