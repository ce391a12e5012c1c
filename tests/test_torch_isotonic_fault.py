"""The isotonic-ensemble fault (ROADMAP Queue 3): the 512-member nz=150
thermosphere ensemble with ``conv_method='isotonic'`` in f32 leaves 3
members unconverged in JAX on the CPU and more in the port.  Member 3
(F = 1201.76 W/m^2) is one that JAX's CPU march converges and the port's
does not.

Stepped from JAX's carry, the port's isotonic step is 2-4 K from JAX's.
Traced operation by operation on one such step, the first value that
differs is the Exner factor pi = (p / p_ref)^alpha (one ulp at some
levels: XLA's f32 pow rounds differently from PyTorch's), then the prefix
sums of v theta and v, which JAX forms with ``jnp.cumsum`` (f32, XLA's
order) and the port by its rule (a sequential double sum, each entry
rounded to f32).  The fit amplifies such rounding by sum(v) / min(v) ~3e5
on this grid.  Handing the port JAX's prefix sums closes nearly all of the
gap, XLA's pi does not; so the gap is the prefix sums' rounding, and which
members converge is decided by it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.constants import R_specific, g, p_surface_earth
from climatemodel_tpu.models import ensemble as jens
from climatemodel_tpu.models.grey import GreyGas as JGreyGas
from climatemodel_tpu_torch.ops import convection as pc
from test_torch_column import lockstep_march

THERMOSPHERE = dict(tau_lw_func='scale_height_and_peak_in_atmosphere',
                    tau_lw_func_args=[51000, 4, 100, 600, 0.1],
                    tau_sw_func='scale_height_and_peak_in_atmosphere',
                    tau_sw_func_args=[p_surface_earth, 0.12, 100, 20, 0.002])
MEMBER = 3
STEPS = 40


def jax_prefix_sums(theta, v):
    """(SV [n+1, C], SW [n+1]) as JAX forms them for the isotonic fit
    (climatemodel_tpu/ops/convection.py:233-234): ``jnp.cumsum`` in the
    dtype, row 0 zero."""
    th, vv = jnp.asarray(theta.numpy()), jnp.asarray(v.numpy())
    zero = jnp.zeros((1,), th.dtype)
    sv = jax.vmap(lambda t: jnp.concatenate([zero, jnp.cumsum(vv * t)]))(th)
    sw = jnp.concatenate([zero, jnp.cumsum(vv)])
    return (torch.from_numpy(np.asarray(sv).T.copy()),
            torch.from_numpy(np.asarray(sw).copy()))


def jax_grid_factors(p, lapse_rate, p_reference):
    """``convection.grid_factors`` with pi = (p / p_ref)^alpha formed by
    XLA (jitted) as JAX forms it, the weights the port's."""
    alpha = R_specific * lapse_rate / g
    pi = jax.jit(lambda q: (q / p_reference) ** alpha)(jnp.asarray(p.numpy()))
    return (torch.from_numpy(np.asarray(pi).copy()),
            pc._trapz_weights(p))


def _lockstep():
    wj = JGreyGas(nz=150, ny=1, dtype=jnp.float32, **THERMOSPHERE)
    F = np.linspace(1200.0, 1500.0, 512)[[MEMBER]]
    states, forcings, p_int, p_c = jens.grey_ensemble(wj, F)
    _, rec = lockstep_march(states, forcings, p_int, p_c, 0.1,
                            max_steps=STEPS, convective_adjust=True,
                            conv_method='isotonic')
    assert len(rec) == STEPS
    return np.array([r['dT'][0] for r in rec])


def test_isotonic_f32_gap_is_the_prefix_sums_rounding(monkeypatch):
    """Member 3's first 40 f32 steps, each from JAX's carry: with its own
    prefix sums the port's step is more than 2 K from JAX's at every step
    (measured 2.8-4.3 K), and still with XLA's pi in place of its own
    (measured 2.4-5.9 K); with JAX's prefix sums handed to
    ``iso_fit_plain`` (as ``isotonic_increasing_lanes`` forms them outside
    its ``pallas_call``), its first step is within 1e-4 K (one ulp of T is
    3e-5 K), half of its steps within 0.05 K (measured median 0.013 K),
    and every step within the 1 K that test_torch_convection.py states for
    an f32 step of the faithful method (measured: at most 0.81 K).  The
    rest is other rounding the fit amplifies: pi's ulps, the flux's."""
    own = _lockstep()
    with monkeypatch.context() as m:
        m.setattr(pc, 'grid_factors', jax_grid_factors)
        with_jax_pi = _lockstep()
    monkeypatch.setattr(pc, 'iso_prefix_sums', jax_prefix_sums)
    with_jax_sums = _lockstep()
    print(f'per-step max |port - JAX| over {STEPS} steps: own '
          f'{own.min():.3g}-{own.max():.3g} K, XLA pi '
          f'{with_jax_pi.min():.3g}-{with_jax_pi.max():.3g} K, JAX sums '
          f'median {np.median(with_jax_sums):.3g} K, max '
          f'{with_jax_sums.max():.3g} K')
    assert own.min() > 2.0 and with_jax_pi.min() > 2.0
    assert with_jax_sums[0] <= 1e-4
    assert np.median(with_jax_sums) <= 0.05
    assert with_jax_sums.max() <= 1.0


@pytest.mark.parametrize('dtype', ['f32', 'f64'])
def test_jax_prefix_sums_helper_is_jax_isotonic(dtype):
    """The helper above feeds ``iso_fit_plain`` exactly what JAX's XLA
    min-max table consumes: the fit of its sums is JAX's fit, bit for bit."""
    from climatemodel_tpu.ops import convection as jc
    jd, pd = {'f32': (jnp.float32, torch.float32),
              'f64': (jnp.float64, torch.float64)}[dtype]
    rng = np.random.default_rng(3)
    theta = 200 + 100 * rng.random((5, 149))
    v = rng.uniform(0.5, 2.0, 149) * np.logspace(0, -5, 149)
    want = np.asarray(jax.vmap(lambda th: jc._isotonic_increasing(
        th, jnp.asarray(v, jd)))(jnp.asarray(theta, jd)))
    got = pc.iso_fit_plain(*jax_prefix_sums(torch.tensor(theta, dtype=pd),
                                            torch.tensor(v, dtype=pd))).T
    np.testing.assert_array_equal(got.numpy(), want)


def test_first_differences_are_pi_ulps_and_prefix_sums():
    """Member 3's f32 step from JAX's carry after one step, traced to the
    isotonic fit's inputs: the Exner factor pi = (p / p_ref)^alpha of the
    port and of XLA (jitted, as inside JAX's march) differ by at most one
    ulp at some levels; the prefix sums of the port's rule and JAX's
    ``jnp.cumsum`` of the same v theta and v differ at some entries; given
    the same sums the fits are equal (the test above).  Prints the counts
    the ROADMAP records."""
    from climatemodel_tpu.constants import R_specific, c_p_dry, g
    wj = JGreyGas(nz=150, ny=1, dtype=jnp.float32, **THERMOSPHERE)
    F = np.linspace(1200.0, 1500.0, 512)[[MEMBER]]
    states, forcings, p_int, p_c = jens.grey_ensemble(wj, F)
    carry, _ = lockstep_march(states, forcings, p_int, p_c, 0.1, max_steps=1,
                              convective_adjust=True, conv_method='isotonic')
    p = torch.from_numpy(np.asarray(p_c, np.float32))
    alpha = R_specific * (g / c_p_dry) / g
    pi_xla = np.asarray(jax.jit(lambda q: (q / p_surface_earth) ** alpha)(
        jnp.asarray(p.numpy())))
    pi, w = pc.grid_factors(p)
    ulps = np.abs(pi.numpy().view(np.int32) - pi_xla.view(np.int32))
    T = torch.from_numpy(np.asarray(carry[0].T)[0, :, 0])
    theta, v = (T / pi)[None], w * pi
    sv, sw = pc.iso_prefix_sums(theta, v)
    sv_j, sw_j = jax_prefix_sums(theta, v)
    n_sv = int((sv != sv_j).sum())
    n_sw = int((sw != sw_j).sum())
    print(f'pi: {int((ulps > 0).sum())} of {len(ulps)} levels differ (max '
          f'{ulps.max()} ulp); prefix sums: {n_sv} SV and {n_sw} SW of '
          f'{len(sw)} entries differ')
    assert ulps.max() <= 1
    assert n_sv + n_sw > 0
