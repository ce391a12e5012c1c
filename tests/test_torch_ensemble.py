"""Port vs JAX: the grey ensemble march (``models/ensemble.py``).

The delta-percentile exit makes the march sensitive to the last bit: a
one-ulp difference in a flux (XLA's CPU exp vs PyTorch's; JAX's CPU flux is
the associative scan, the port's the sequential walk) grows ~10x every ~5
steps once the controlling level wanders, so two free-running f64 marches of
the smoke config part by ~0.7 K and exit at different steps (measured; see
PERF.md).  The tests therefore pin the march step by step: JAX's vmapped
march body drives the trajectory and, before every step, the port takes the
same carry (``lockstep_march`` in test_torch_column.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.constants import p_surface_earth
from climatemodel_tpu.models import ensemble as jens
from climatemodel_tpu.models.grey import GreyGas as JGreyGas
from climatemodel_tpu_torch.models import ensemble as pens
from climatemodel_tpu_torch.models.grey import GreyGas as PGreyGas
from test_torch_column import lockstep_march

SMOKE = dict(nz=40, ny=1, tau_lw_func='scale_height',
             tau_lw_func_args=[0.22 * p_surface_earth, 4.0])
SMOKE_F = np.linspace(800.0, 1600.0, 64)        # bench.py:780 smoke config
DTYPES = {'f64': (jnp.float64, torch.float64),
          'f32': (jnp.float32, torch.float32)}


def _worlds(kw, dtype):
    jd, pd = DTYPES[dtype]
    return JGreyGas(dtype=jd, **kw), PGreyGas(dtype=pd, device='cpu', **kw)


def _steps(records, key):
    return np.concatenate([r[key][r['go']] for r in records])


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
def test_smoke_ensemble_step_by_step_matches_jax(dtype):
    """The bench smoke config (64 members, nz=40, max_steps 600), every step
    of every member from JAX's carry.  f64: T within 1e-9 K and t, dt
    within 1e-9 relative at every step, the controlling level, the threshold
    and all four exit flags equal (measured 1.8e-11 K, 1.1e-10, no
    mismatch).  f32: T within 0.1 K at every step (measured 0.013 K); the
    exit decision itself sits on the f32 flux noise floor (~1e-5 of ~400
    W/m^2 against a 1e-3 threshold), so controller and flag flips are
    counted and reported, not required equal."""
    wj, _ = _worlds(SMOKE, dtype)
    states, forcings, _, _ = jens.grey_ensemble(wj, SMOKE_F)
    carry, rec = lockstep_march(states, forcings, wj.p_interface,
                                wj.p[:, 0], 1e-3, max_steps=600)
    assert len(rec) == 600
    dT = _steps(rec, 'dT')
    ind_flips = int((~_steps(rec, 'ind_same')).sum())
    flag_flips = int((~_steps(rec, 'flags_same')).sum())
    print(f'{dtype}: {dT.size} member-steps, max |dT| {dT.max():.3g} K, '
          f'{ind_flips} controlling-level and {flag_flips} exit-flag flips, '
          f'JAX converged {np.asarray(carry[4]).mean():.4f}')
    if dtype == 'f64':
        assert dT.max() <= 1e-9
        assert _steps(rec, 'rel_t').max() <= 1e-9
        assert _steps(rec, 'rel_dt').max() <= 1e-9
        assert ind_flips == 0 and flag_flips == 0
        assert _steps(rec, 'ft_same').all()
    else:
        assert dT.max() <= 0.1


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
def test_smoke_ensemble_free_running(dtype):
    """Both packages march the smoke config on their own; the port's every
    member stops by equilibrium or the step cap, never nan/failed.  The
    converged fractions and step counts are reported (they differ by the
    path dependence described above, so they are not held equal)."""
    wj, wp = _worlds(SMOKE, dtype)
    sj, fj, pij, pcj = jens.grey_ensemble(wj, SMOKE_F)
    oj, ij = jens.grey_evolve_ensemble(sj, fj, pij, pcj,
                                       jnp.asarray(1e-3, wj.dtype),
                                       max_steps=600)
    sp, fp, pip, pcp = pens.grey_ensemble(wp, SMOKE_F)
    op, ip = pens.grey_evolve_ensemble(sp, fp, pip, pcp, 1e-3, max_steps=600)
    assert op.T.shape == (64, wp.nz - 1, 1) and op.T.dtype == wp.dtype
    assert not bool(ip.nan.any()) and not bool(ip.failed.any())
    assert bool((ip.equilibrium | ip.timed_out | (ip.steps == 600)).all())
    assert bool(torch.isfinite(op.T).all())
    print(f'{dtype}: converged JAX {np.asarray(ij.equilibrium).mean():.4f} '
          f'port {ip.equilibrium.double().mean():.4f}; total steps JAX '
          f'{int(np.asarray(ij.steps).sum())} port {int(ip.steps.sum())}')


CAPPED = dict(nz=40, ny=1, tau_lw_func='exponential',
              tau_lw_func_args=[100000, 4])
CAPPED_F = np.linspace(1200.0, 1400.0, 4)


@pytest.mark.parametrize('max_steps', [20, 200])
def test_capped_march_matches_jax(max_steps):
    """flux_thresh 1e-9 with t_end out of reach (f64), so the per-member
    step cap binds.  At 20 steps the two free-running marches agree: steps
    and flags equal, T, t and dt within 1e-9 relative (the last-bit growth
    above has not started).

    Run to 200 steps, member 0 of JAX's march stops at step 188 by the delta
    exit (every level frozen, so the flux stops changing: delta exactly 0)
    while the others hit the cap; the free-running port reaches that exit at
    other steps (220-234, measured), so there the march is held step by
    step: the same controlling level, threshold and flags at every step
    (the step-188 exit included), and T, t and dt within 1e-9 relative plus
    what the flux's own rounding can move them by.  Near balance the
    tendency g/c_p dF/dp is a difference of nearly equal fluxes and
    dt = delta_t / |max tendency| grows to ~1e9 s, so a flux rounding E
    moves T by up to dt g/c_p 2E/dp and dt by dt g/c_p 2E/(dp |max
    tendency|).  E is the sequential walk's worst case: nz-1 levels of one
    rounding each, amplified by up to e^tau_surface, on the largest flux
    (measured per-step T differences reach 5e-5 K from step 116 on, the
    same against JAX's own sequential walk as against its scan)."""
    from climatemodel_tpu.constants import c_p_dry, g
    wj, wp = _worlds(CAPPED, 'f64')
    sj, fj, pij, pcj = jens.grey_ensemble(wj, CAPPED_F)
    oj, ij = jens.grey_evolve_ensemble(sj, fj, pij, pcj, jnp.asarray(1e-9),
                                       max_steps=max_steps, t_end=1e9)
    sp, fp, pip, pcp = pens.grey_ensemble(wp, CAPPED_F)
    op, ip = pens.grey_evolve_ensemble(sp, fp, pip, pcp, 1e-9,
                                       max_steps=max_steps, t_end=1e9)
    assert bool((ip.equilibrium | (ip.steps == max_steps)).all())
    if max_steps == 20:
        np.testing.assert_array_equal(ip.steps.numpy(), np.asarray(ij.steps))
        for f in ('equilibrium', 'failed', 'nan', 'timed_out'):
            np.testing.assert_array_equal(getattr(ip, f).numpy(),
                                          np.asarray(getattr(ij, f)), f)
        rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()  # noqa: E731
        assert rel(op.T.numpy(), np.asarray(oj.T)) <= 1e-9
        assert rel(op.t.numpy(), np.asarray(oj.t)) <= 1e-9
        assert rel(op.tsi.dt.numpy(), np.asarray(oj.tsi.dt)) <= 1e-9
        return
    carry, rec = lockstep_march(sj, fj, wj.p_interface, wj.p[:, 0], 1e-9,
                                max_steps=max_steps, t_end=1e9)
    np.testing.assert_array_equal(np.asarray(carry[3]), np.asarray(ij.steps))
    assert np.asarray(ij.steps).tolist() == [188, 200, 200, 200]
    assert len(rec) == max_steps
    for key in ('ind_same', 'flags_same', 'ft_same'):
        assert _steps(rec, key).all(), key
    dp = np.abs(np.diff(wj.p_interface[:, 0]))                  # [nz-1]
    F_max = float(np.max(CAPPED_F)) / 4 * 3                    # > any flux
    E = (wj.nz - 1) * np.exp(wj.tau_interface[0, 0]) \
        * np.finfo(np.float64).eps * F_max
    T_max = float(np.asarray(oj.T).max())
    for r in rec:
        m = r['go']
        dt = r['dt_j'][m]
        tend_err = g / c_p_dry * 2 * E / dp                      # K/s per level
        assert (r['dT_lev'][m] <= 1e-9 * T_max
                + dt[:, None] * tend_err[None]).all(), r['step']
        dt_bound = 1e-9 * dt + dt * tend_err.max() / r['abs_tend_j'][m]
        assert (r['abs_dt'][m] <= dt_bound).all(), r['step']
    print(f'port free-running steps {ip.steps.tolist()}, '
          f'JAX {np.asarray(ij.steps).tolist()}; max per-step |dT| '
          f'{_steps(rec, "dT").max():.3g} K')


def test_fused_stats_bit_identical():
    """fused_stats=True (the K3 route) and False (K1 + separate statistics)
    march every member to the bit-identical endpoint, step count and flags
    (as test_grey_rce.py::test_fused_stats_ensemble_bit_identical)."""
    kw = dict(nz=40, ny=1, tau_lw_func='exponential',
              tau_lw_func_args=[100000, 4], tau_sw_func='exponential',
              tau_sw_func_args=[80000, 0.2])
    _, wp = _worlds(kw, 'f32')
    F = np.linspace(1100.0, 1600.0, 9)
    states, forcings, p_int, p_c = pens.grey_ensemble(wp, F)
    outs = [pens.grey_evolve_ensemble(states, forcings, p_int, p_c, 1e-3,
                                      max_steps=5000, fused_stats=fused)
            for fused in (False, True)]
    (s0, i0), (s1, i1) = outs
    same = []
    s0.map(lambda a, b: same.append(torch.equal(a, b)), s1)
    assert len(same) == 13 and all(same)
    for a, b in zip(i0, i1):
        assert torch.equal(a, b)
    assert bool(i1.equilibrium.any())


def test_f32_tail_finishes_in_f64():
    """The 4-member config of test_grey_rce.py::
    test_f32_noise_blocked_member_finishes_in_f64: after the f64 finishing
    pass every member is in equilibrium, none timed out, members that
    converged in f32 are untouched, finished members keep the f32 dtype and
    their simulated time grows."""
    wj, wp = _worlds(dict(nz=60, ny=1, tau_lw_func='scale_height',
                          tau_lw_func_args=[0.22 * p_surface_earth, 4.0]),
                     'f32')
    F = np.array([900.0, 1200.0, 1550.57387057, 1579.68253968])
    states, forcings, p_int, p_c = pens.grey_ensemble(wp, F)
    fs, info = pens.grey_evolve_ensemble(states, forcings, p_int, p_c, 1e-3,
                                         max_steps=3000)
    fs_r, info_r, finished = pens.grey_finish_unconverged_f64(
        fs, info, forcings, p_int, p_c, 1e-3, max_steps=3000)
    eqb0 = info.equilibrium.numpy()
    print(f'f32 converged {eqb0.tolist()}, finished in f64 '
          f'{np.asarray(finished).tolist()}, steps {info_r.steps.tolist()}')
    assert sorted(np.asarray(finished).tolist()) == np.nonzero(~eqb0)[0].tolist()
    assert bool(info_r.equilibrium.all())
    assert not bool(info_r.timed_out.any())
    assert fs_r.T.dtype == torch.float32
    assert torch.equal(fs_r.T[eqb0], fs.T[eqb0])
    fin = torch.as_tensor(np.asarray(finished, np.int64))
    assert bool((fs_r.t[fin] > fs.t[fin]).all())
    assert bool((info_r.steps[fin] > info.steps[fin]).all())


def test_cuda_device_never_falls_back_to_cpu():
    """Asking for the GPU without one raises; and a tensor on any device
    other than the CPU is routed to the CUDA kernels, which raise instead of
    computing elsewhere (the 'meta' device stands in for a card here)."""
    with pytest.raises((RuntimeError, AssertionError)):
        PGreyGas(nz=20, ny=1, tau_lw_func='scale_height',
                 tau_lw_func_args=[0.22 * p_surface_earth, 4.0],
                 device='cuda')
    from climatemodel_tpu_torch.ops import two_stream as pts
    T = torch.empty((5, 8), device='meta')
    with pytest.raises(ValueError, match='CUDA tensor'):
        pts.lw_flux(T, T, torch.empty((8,), device='meta'))
    with pytest.raises(ValueError, match='CUDA tensor'):
        pts.grey_net_with_stats(torch.empty((8, 5, 1), device='meta'),
                                torch.empty((8, 5, 1), device='meta'),
                                torch.empty((8, 1), device='meta'),
                                torch.empty((8, 6, 1), device='meta'),
                                torch.empty((8, 6, 1), device='meta'),
                                torch.empty((8, 6, 1), device='meta'))
