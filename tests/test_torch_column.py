"""Port vs JAX: the column machinery — one temperature update and the
adaptive time-step controller from the same state, carried across with
``climatemodel_tpu_torch/utils/interop.py``, plus the percentile helpers."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.models import column as jcol
from climatemodel_tpu.models.grey import GreyGas as JGreyGas
from climatemodel_tpu.models.grey import _grey_evolve, grey_net_flux as jnet
from climatemodel_tpu_torch.models import column as pcol
from climatemodel_tpu_torch.models.grey import grey_net_flux as pnet
from climatemodel_tpu_torch.utils import interop

# f64: the only difference between the two is the last bit of a few exps
# (XLA's CPU exp vs PyTorch's), so 1e-12 relative.
REL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _as_dict(state):
    return dataclasses.asdict(jax.device_get(state))


def _marched_jax_world(steps):
    """A JAX f64 world marched ``steps`` steps, controller left live."""
    w = JGreyGas(nz=40, ny=1, tau_lw_func='exponential',
                 tau_lw_func_args=[100000, 4], dtype=jnp.float64)
    st, _ = _grey_evolve(w.state, w.forcing,
                         jnp.asarray(w.p_interface), jnp.asarray(w.p[:, 0]),
                         jnp.asarray(1e-12), t_end=1e9, max_steps=steps,
                         final_reset=False)
    return w, st


@pytest.mark.parametrize('steps', [0, 1, 25])
def test_update_temp_step_matches_jax(steps):
    """One update_temp step (flux, tendency, controller, T update) from the
    same f64 state: T, t, dt and max_tend to 1e-12 relative, the integer
    and mask bookkeeping equal.  steps=0 is the forced first step."""
    w, st = _marched_jax_world(steps)
    forcing = w.forcing
    p_int = jnp.asarray(w.p_interface)
    net_j = jnet(st.T, forcing)
    st_j, delta_j = jcol.update_temp(st, net_j, p_int, jnp.asarray(w.p[:, 0]))

    st_p = interop.column_state_from_numpy(_as_dict(st), device='cpu',
                                           dtype=torch.float64)
    fo_p = interop.grey_forcing_from_numpy(
        dataclasses.asdict(jax.device_get(forcing)), device='cpu',
        dtype=torch.float64)
    net_p = pnet(st_p.T, fo_p)
    assert _rel(net_p[0].numpy(), net_j) <= REL
    st_p2, delta_p = pcol.update_temp(
        st_p, net_p, torch.from_numpy(w.p_interface))
    assert _rel(st_p2.T[0].numpy(), st_j.T) <= REL
    assert _rel(st_p2.t.numpy(), st_j.t) <= REL
    assert _rel(delta_p.numpy(), delta_j) <= 1e-9   # percentile of differences
    tj, tp = st_j.tsi, st_p2.tsi
    for name in ('dt', 'max_tend', 'delta_t'):
        assert _rel(getattr(tp, name).numpy(), getattr(tj, name)) <= REL, name
    for name in ('max_tend_ind', 'n_same_1', 'n_same_2', 'removed'):
        np.testing.assert_array_equal(getattr(tp, name)[0].numpy(),
                                      np.asarray(getattr(tj, name)), name)


def _tsi_cases(n):
    """Crafted controller states exercising osc / grow / reset / each freeze
    rule, as one batch; tendencies seeded so the argmax lands at index 3."""
    rng = np.random.default_rng(5)
    cases = []
    for n1, n2, removed, prev_ind, prev_tend in [
            (0, 0, [], -1, 0.0),          # first step: reset
            (1, 11, [], 3, 1e-5),         # same index, same sign: grow+freeze
            (2, 0, [], 3, -1e-5),         # same index, sign flip: oscillate
            (21, 0, [], 3, -1e-5),        # long oscillation: freeze
            (0, 1, [0, 1, 2, 4], 3, 1e-5),  # >3 removed: freeze
            (0, 0, [], 5, 1e-5)]:         # different index: reset
        rem = np.zeros(n, bool)
        rem[removed] = True
        cases.append(dict(
            delta_t=0.5, max_delta_t=1.0, delta_t_step=0.01,
            max_tend=prev_tend, max_tend_ind=np.int32(prev_ind), dt=100.0,
            n_same_1=np.int32(n1), n_same_2=np.int32(n2), removed=rem,
            convective=np.zeros(n, bool)))
    tend = rng.normal(0, 1e-6, (len(cases), n))
    tend[:, 3] = 5e-5
    return cases, tend


def test_update_time_step_cases_match_jax():
    n = 12
    cases, tend = _tsi_cases(n)
    allowed = np.ones((len(cases), n), bool)
    allowed[:, 7] = False
    batch = {k: np.stack([np.asarray(c[k]) for c in cases]) for k in cases[0]}
    tp = pcol.update_time_step(
        interop.time_step_info_from_numpy(batch, device='cpu',
                                          dtype=torch.float64),
        torch.from_numpy(tend), torch.from_numpy(allowed))
    for k, c in enumerate(cases):
        tj = jcol.update_time_step(
            jcol.TimeStepInfo(**{f: jnp.asarray(v) for f, v in c.items()}),
            jnp.asarray(tend[k]), jnp.asarray(allowed[k]))
        for f in dataclasses.fields(jcol.TimeStepInfo):
            a = getattr(tp, f.name)[k].numpy()
            b = np.asarray(getattr(tj, f.name))
            if a.dtype.kind == 'f':
                assert _rel(a, b) <= REL, (k, f.name)
            else:
                np.testing.assert_array_equal(a, b, (k, f.name))


def test_update_time_step_tie_and_all_masked():
    """A tie takes the first index (as jnp.argmax); a member with no
    allowed level reads index 0, whose zero tendency gives the
    SECONDS_PER_DAY fallback dt (base.py:244-246)."""
    n = 6
    tsi = {k: np.stack([v, v]) for k, v in dict(
        delta_t=1.0, max_delta_t=1.0, delta_t_step=0.01, max_tend=0.0,
        max_tend_ind=np.int32(-1), dt=0.0, n_same_1=np.int32(0),
        n_same_2=np.int32(0), removed=np.zeros(n, bool),
        convective=np.zeros(n, bool)).items()}
    tend = np.array([[1e-6, -3e-6, 2e-6, 3e-6, -3e-6, 0.0],
                     [0.0, 2e-6, 3e-6, 4e-6, 5e-6, 6e-6]])
    allowed = np.array([[True] * n, [False] * n])
    tp = pcol.update_time_step(
        interop.time_step_info_from_numpy(tsi, device='cpu',
                                          dtype=torch.float64),
        torch.from_numpy(tend), torch.from_numpy(allowed))
    for k in range(2):
        tj = jcol.update_time_step(
            jcol.TimeStepInfo(**{f: jnp.asarray(v[k]) for f, v in tsi.items()}),
            jnp.asarray(tend[k]), jnp.asarray(allowed[k]))
        assert int(tp.max_tend_ind[k]) == int(tj.max_tend_ind)
        assert float(tp.dt[k]) == float(tj.dt)
    assert int(tp.max_tend_ind[0]) == 1 and int(tp.max_tend_ind[1]) == 0
    assert float(tp.dt[1]) == 86400.0


@pytest.mark.parametrize('pct', [50, 90, 95])
@pytest.mark.parametrize('n', [2, 21, 60])
def test_percentiles_match_jax(n, pct):
    """_percentile_topk and _percentile_from_stats per member against the
    JAX helpers, including the NaN sentinel (a NaN anywhere -> NaN)."""
    rng = np.random.default_rng(n + pct)
    x = rng.random((4, n))
    x[2, n // 2] = np.nan
    got = pcol._percentile_topk(torch.from_numpy(x), pct).numpy()
    m, _ = pcol.percentile_topk_params(n, pct)
    L = max(m, 2)
    top = torch.topk(torch.from_numpy(np.nan_to_num(x, nan=np.inf)), L,
                     dim=1).values
    top1 = torch.from_numpy(x).amax(dim=1)
    from_stats = pcol._percentile_from_stats(top1, top[:, L - 2],
                                             top[:, L - 1], n, pct).numpy()
    for k in range(4):
        want = float(jcol._percentile_topk(jnp.asarray(x[k]), pct))
        if np.isnan(want):
            assert np.isnan(got[k]) and np.isnan(from_stats[k])
        else:
            assert abs(got[k] - want) <= 1e-15 * abs(want)
            assert abs(from_stats[k] - want) <= 1e-15 * abs(want)
            assert abs(want - np.percentile(x[k], pct)) <= 1e-12
    assert np.isnan(got[2])


def test_check_equilibrium_and_exit_flags():
    net = torch.tensor([[[5e-4], [-2e-4]], [[3e-3], [1e-4]]],
                       dtype=torch.float64)
    delta = torch.tensor([1.0, 5e-4], dtype=torch.float64)
    eqb = pcol.check_equilibrium(net, delta, 1e-3)
    assert eqb.tolist() == [True, True]
    eqb = pcol.check_equilibrium(net, delta, 1e-3, use_delta_exit=False)
    assert eqb.tolist() == [True, False]
    for k in range(2):
        assert bool(jcol.check_equilibrium(
            jnp.asarray(net[k].numpy()), jnp.asarray(float(delta[k])), 1e-3,
            use_delta_exit=False)) == bool(eqb[k])


# --------------------------------------------------------------------------
# Lockstep: JAX's vmapped march body and the port's march_step, one step at
# a time from the same carry.  The delta-percentile march amplifies a
# last-bit difference by ~10x every ~5 steps once the controlling level
# wanders (measured on the smoke config), so two free-running marches part
# after ~50 steps whatever the precision; re-syncing every step pins each
# step's semantics over a whole march instead.
# --------------------------------------------------------------------------

def _sequential_net_flux(T, f):
    """JAX's grey net flux on its sequential walk (``lw_flux_sequential``,
    the order the Pallas kernels reproduce bit for bit) instead of the
    associative scan its CPU path takes."""
    from climatemodel_tpu.ops import two_stream as jts
    up_toa = (1.0 - f.albedo_mod) * f.solar_latitude_factor * f.F_stellar / 4.0
    up, down = jts.lw_flux_sequential(T, f.dtau, up_toa)
    up_sw, down_sw = jts.sw_flux(f.tau_sw_interface, f.albedo_mod,
                                 f.solar_latitude_factor, f.F_stellar)
    return up - down + up_sw - down_sw


def _jax_step_fn(p_int, p_c, *, t_end, max_steps, fused, sequential=False,
                 convective_adjust=False, conv_method='reference'):
    """jit(vmap) of one JAX march step with the vmapped while-loop's
    freeze, built exactly as climatemodel_tpu's ensemble (fused) or
    GreyGas (unfused) march builds its body; ``sequential`` swaps the flux
    for JAX's sequential walk (unfused only)."""
    from climatemodel_tpu.models.grey import grey_net_flux
    from climatemodel_tpu.ops import two_stream as jts
    net_flux = _sequential_net_flux if sequential else grey_net_flux

    def one(carry, f, t0):
        stats_fn = None
        if fused:
            up_toa = (1.0 - f.albedo_mod) * f.solar_latitude_factor * \
                f.F_stellar / 4.0
            up_sw, down_sw = jts.sw_flux(f.tau_sw_interface, f.albedo_mod,
                                         f.solar_latitude_factor, f.F_stellar)
            stats_fn = lambda T, prev: jts.grey_net_with_stats(  # noqa: E731
                T, f.dtau, up_toa, up_sw, down_sw, prev, pct=95)
        body = jcol._march_body(
            lambda T: net_flux(T, f), p_int, p_c, t0,
            convective_adjust=convective_adjust, t_end=t_end,
            conv_thresh=1e-5, conv_t_multiplier=5.0, net_flux_thresh=1e-7,
            net_flux_percentile=95, p_descending=True, use_delta_exit=True,
            conv_method=conv_method, net_stats_fn=stats_fn)
        _st, _ft, _d, i, eqb, failed, nan, tout = carry
        go = ~eqb & ~tout & ~failed & ~nan & (i < max_steps)
        new = body(carry)
        return jax.tree_util.tree_map(lambda n, o: jnp.where(go, n, o),
                                      new, carry), go
    return jax.jit(jax.vmap(one))


def lockstep_march(jstates, jforcings, p_interface, p_centre, flux_thresh, *,
                   max_steps, t_end=4.0, fused=True, sequential=False,
                   convective_adjust=False, conv_method='reference'):
    """March JAX's batched states step by step; before every step hand the
    same carry to the port's ``march_step``.  Returns (JAX final carry,
    records) where records lists, per step, the members that stepped and the
    port-minus-JAX differences after the step."""
    from climatemodel_tpu_torch.models.ensemble import grey_march_fns

    dt_j = jstates.T.dtype
    dt_p = {jnp.float64: torch.float64, jnp.float32: torch.float32}[
        jnp.dtype(dt_j).type]
    step = _jax_step_fn(jnp.asarray(p_interface, dt_j),
                        jnp.asarray(p_centre, dt_j), t_end=t_end,
                        max_steps=max_steps, fused=fused,
                        sequential=sequential,
                        convective_adjust=convective_adjust,
                        conv_method=conv_method)
    B = jstates.T.shape[0]
    f = lambda v, d=dt_j: jnp.full((B,), v, d)  # noqa: E731
    carry = (jstates, f(flux_thresh), f(1e6), f(0, jnp.int32),
             f(False, bool), f(False, bool), f(False, bool), f(False, bool))
    t0 = jstates.t
    fo = interop.grey_forcing_from_numpy(
        dataclasses.asdict(jax.device_get(jforcings)), device='cpu',
        dtype=dt_p)
    p_int = torch.from_numpy(np.asarray(p_interface)).to(dt_p)
    net_fn, stats_fn = grey_march_fns(fo, (B,) + jstates.net_flux.shape[1:],
                                      fused_stats=fused)
    t0_p = torch.tensor(np.asarray(t0))
    conv_kw = dict(convective_adjust=True, conv_method=conv_method,
                   p_centre_col=torch.from_numpy(np.asarray(p_centre)).to(dt_p)
                   ) if convective_adjust else {}
    records = []
    while True:
        new, go = step(carry, jforcings, t0)
        go = np.asarray(go)
        if not go.any():
            return carry, records
        host = jax.device_get(carry)
        st_p = interop.column_state_from_numpy(dataclasses.asdict(host[0]),
                                               device='cpu', dtype=dt_p)
        out = pcol.march_step(
            st_p, torch.tensor(host[1]), torch.tensor(host[3]), t0_p,
            net_fn, p_int, t_end=t_end, net_stats_fn=stats_fn, **conv_kw)
        st_j, ft_j, delta_j, _i, *flags_j = jax.device_get(new)
        st_q, ft_q, delta_q, *flags_q = out
        rel = lambda a, b: np.abs(a - b) / np.maximum(  # noqa: E731
            np.abs(b), np.finfo(b.dtype).tiny)
        records.append(dict(
            step=int(host[3][go].max()) + 1, go=go,
            dT_lev=np.abs(st_q.T.numpy() - st_j.T).reshape(B, -1),
            rel_t=rel(st_q.t.numpy(), st_j.t),
            rel_dt=rel(st_q.tsi.dt.numpy(), st_j.tsi.dt),
            ind_same=st_q.tsi.max_tend_ind.numpy() == st_j.tsi.max_tend_ind,
            flags_same=np.all([q.numpy() == j for q, j in
                               zip(flags_q, flags_j)], axis=0),
            ft_same=ft_q.numpy() == ft_j, dt_j=st_j.tsi.dt,
            conv_flips=(st_q.tsi.convective.numpy()
                        != st_j.tsi.convective).sum(1),
            abs_tend_j=np.abs(st_j.tsi.max_tend), abs_dt=np.abs(
                st_q.tsi.dt.numpy() - st_j.tsi.dt),
            abs_t=np.abs(st_q.t.numpy() - st_j.t)))
        records[-1]['dT'] = records[-1]['dT_lev'].max(1)
        carry = new
