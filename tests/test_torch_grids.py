"""Port vs JAX: the host-side grid layer.  Both packages build their grids in
float64 NumPy from the same closed forms, so every array must be
byte-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.constants import p_surface_earth
from climatemodel_tpu.models.grey import GreyGas as JGreyGas
from climatemodel_tpu.ops import optical_depth as jod
from climatemodel_tpu.utils import grids as jgrids
from climatemodel_tpu_torch.models.grey import GreyGas as PGreyGas
from climatemodel_tpu_torch.ops import optical_depth as pod
from climatemodel_tpu_torch.utils import grids as pgrids

FAMILY_ARGS = {
    'scale_height': [0.22 * p_surface_earth, 4.0],
    'exponential': [100000, 4],
    'peak_in_atmosphere': [10000, 2000, 0.05],
    'scale_height_and_peak_in_atmosphere': [51000, 4, 100, 600, 0.1],
}

WORLDS = {
    'scale_height': dict(tau_lw_func='scale_height',
                         tau_lw_func_args=[0.22 * p_surface_earth, 4.0]),
    'exponential': dict(tau_lw_func='exponential',
                        tau_lw_func_args=[100000, 4],
                        tau_sw_func='exponential',
                        tau_sw_func_args=[80000, 0.2]),
    'thermosphere': dict(tau_lw_func='scale_height_and_peak_in_atmosphere',
                         tau_lw_func_args=[51000, 4, 100, 600, 0.1],
                         tau_sw_func='scale_height_and_peak_in_atmosphere',
                         tau_sw_func_args=[p_surface_earth, 0.12, 100, 20,
                                           0.002]),
}


def _byte_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize('name', sorted(FAMILY_ARGS))
def test_profiles_byte_equal(name):
    """tau, q and dtau/dp of every family, on a float64 pressure grid."""
    p = np.logspace(np.log10(p_surface_earth), np.log10(20.0), 500)
    pj = jod.make_profile(name, FAMILY_ARGS[name], p_surface_earth)
    pp = pod.make_profile(name, FAMILY_ARGS[name], p_surface_earth)
    assert pj.args == pp.args and pj.params == pp.params
    for fn in ('tau', 'q', 'dtau_dp'):
        _byte_equal(getattr(pp, fn)(p), getattr(pj, fn)(p))
    # the torch namespace gives the same closed forms on tensors (f64
    # rounding differences of torch's pow/exp only)
    np.testing.assert_allclose(pp.tau(torch.from_numpy(p)).numpy(),
                               pj.tau(p), rtol=1e-14, atol=1e-300)


@pytest.mark.parametrize('world', sorted(WORLDS))
@pytest.mark.parametrize('nz', ['auto', 60])
def test_grey_p_grid_byte_equal(world, nz):
    kw = WORLDS[world]
    lw_j = jod.make_profile(kw['tau_lw_func'], kw['tau_lw_func_args'],
                            p_surface_earth)
    lw_p = pod.make_profile(kw['tau_lw_func'], kw['tau_lw_func_args'],
                            p_surface_earth)
    sw_j = sw_p = None
    if 'tau_sw_func' in kw:
        sw_j = jod.make_profile(kw['tau_sw_func'], kw['tau_sw_func_args'],
                                p_surface_earth)
        sw_p = pod.make_profile(kw['tau_sw_func'], kw['tau_sw_func_args'],
                                p_surface_earth)
    pj, nzj = jgrids.grey_p_grid(lw_j, sw_j, nz, p_surface=p_surface_earth,
                                 p_toa=20.0)
    pp, nzp = pgrids.grey_p_grid(lw_p, sw_p, nz, p_surface=p_surface_earth,
                                 p_toa=20.0)
    assert nzj == nzp
    _byte_equal(pp, pj)
    _byte_equal(pgrids.cell_centre_pressure(pp), jgrids.cell_centre_pressure(pj))
    _byte_equal(pgrids.log_p_grid(nzp, p_surface_earth, 20.0),
                jgrids.log_p_grid(nzj, p_surface_earth, 20.0))


@pytest.mark.parametrize('world,ny', [('scale_height', 1),
                                      ('exponential', 1),
                                      ('thermosphere', 4)])
def test_grey_gas_host_arrays_and_initial_state_byte_equal(world, ny):
    """GreyGas host arrays, the frozen albedo_mod, and the initial T and net
    flux (both packages in float64)."""
    kw = WORLDS[world]
    wj = JGreyGas(nz=40, ny=ny, dtype=jnp.float64, **kw)
    wp = PGreyGas(nz=40, ny=ny, dtype=torch.float64, device='cpu', **kw)
    assert wj.nz == wp.nz
    for name in ('p_interface', 'p', 'tau_interface', 'tau', 'q', 'dtau',
                 'tau_sw_interface', 'tau_sw', 'q_sw', 'albedo_mod', 'F_sw0',
                 'T0', 'solar_latitude_factor'):
        _byte_equal(getattr(wp, name), getattr(wj, name))
    _byte_equal(wp.T, wj.T)
    _byte_equal(wp.net_flux, wj.net_flux)
    for name in ('up_lw_flux', 'down_lw_flux', 'up_sw_flux', 'down_sw_flux'):
        _byte_equal(getattr(wp, name), getattr(wj, name))
    fj = jax.device_get(wj.forcing)
    fp = wp.forcing
    for name in ('dtau', 'tau_sw_interface', 'albedo_mod',
                 'solar_latitude_factor', 'F_stellar'):
        _byte_equal(getattr(fp, name)[0].numpy(), getattr(fj, name))
