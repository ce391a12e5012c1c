"""Port vs JAX: the equilibrium sensitivities (``diagnostics/sensitivity.py``)
evaluated at JAX's own marched state, carried across as NumPy.

Bounds (f64): every sensitivity within 1e-8 relative of JAX's (max |diff|
over max |JAX|); the Jacobian J and the parameter derivative dF within
1e-10 of the scale of J's diagonal (dF: of its own max).  Marches are never
compared across packages (they part in the last bit, ROADMAP Queue 3), so
the port evaluates JAX's endpoint.  The exact grey oracle dT*/dF = T*/(4F)
holds to 1% as in ``tests/test_sensitivity.py:32``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.cli import grey_world_kwargs
from climatemodel_tpu.constants import F_sun
from climatemodel_tpu.diagnostics import sensitivity as js
from climatemodel_tpu.models.grey import GreyGas as JGrey
from climatemodel_tpu.models.real_gas import RealGas as JReal
from climatemodel_tpu.spectral import humidity as jhum
from climatemodel_tpu_torch.diagnostics import sensitivity as ps
from climatemodel_tpu_torch.models.grey import GreyGas as PGrey
from climatemodel_tpu_torch.models.real_gas import RealGas as PReal
from climatemodel_tpu_torch.spectral import humidity as phum

REL = 1e-8
JF_REL = 1e-10


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def grey_pair(ny, **march):
    """JAX's marched grey world and the port's world holding its state."""
    kw = dict(nz=40, ny=ny, tau_lw_func='exponential',
              tau_lw_func_args=[100000, 4])
    jw = JGrey(**kw)
    for _ in range(2):
        jw.evolve_to_equilibrium(save=False, **march)
    pw = PGrey(dtype=torch.float64, device='cpu', **kw)
    pw.T = np.asarray(jw.state.T)
    return jw, pw


@pytest.fixture(scope='module')
def grey1():
    return grey_pair(1, flux_thresh=1e-5, t_end=30.0)


@pytest.fixture(scope='module')
def grey4():
    return grey_pair(4, flux_thresh=1e-5, t_end=30.0)


@pytest.fixture(scope='module')
def grey_rce():
    """The CLI's convective thermosphere world at nz = 60, marched with the
    isotonic method as tests/test_sensitivity.py:242-245 marches it."""
    kw = dict(nz=60, ny=1, **grey_world_kwargs('thermosphere'))
    jw = JGrey(**kw)
    for _ in range(2):
        jw.evolve_to_equilibrium(flux_thresh=1e-2, save=False,
                                 convective_adjust=True,
                                 conv_method='isotonic')
    pw = PGrey(dtype=torch.float64, device='cpu', **kw)
    pw.T = np.asarray(jw.state.T)
    return jw, pw


def test_grey_sensitivity_matches_jax_and_the_oracle(grey1):
    jw, pw = grey1
    want = js.grey_equilibrium_sensitivity(jw)
    got = ps.grey_equilibrium_sensitivity(pw)
    assert got.shape == pw.T.shape == want.shape
    assert rel(got, want) <= REL
    np.testing.assert_allclose(got, pw.T / (4.0 * F_sun), rtol=1e-2)


def test_grey_sensitivity_latitude_grid(grey4):
    jw, pw = grey4
    got = ps.grey_equilibrium_sensitivity(pw)
    assert got.shape == (39, 4)
    assert rel(got, js.grey_equilibrium_sensitivity(jw)) <= REL
    np.testing.assert_allclose(got, pw.T / (4.0 * F_sun), rtol=1e-2)


def test_grey_active_mask_pins_zero(grey1):
    jw, pw = grey1
    got = ps.grey_equilibrium_sensitivity(pw, active_tau_thresh=0.03)
    want = js.grey_equilibrium_sensitivity(jw, active_tau_thresh=0.03)
    active = np.abs(pw.dtau) > 0.03
    assert not active.all() and active.any()
    assert np.all(got[~active] == 0.0)
    assert np.all(got[active] > 0.0)
    assert rel(got, want) <= REL


def test_grey_custom_direction(grey1):
    """A dforcing direction other than the insolation: d(tau_lw) across
    every cell, as a GreyForcing of the port's (one member) shapes."""
    jw, pw = grey1
    jf = jax.tree_util.tree_map(jnp.zeros_like, jw.forcing)
    jf = jf.replace(dtau=0.01 * jnp.ones_like(jw.forcing.dtau))
    pf = pw.forcing.map(torch.zeros_like)
    pf = pf.replace(dtau=0.01 * torch.ones_like(pf.dtau))
    assert rel(ps.grey_equilibrium_sensitivity(pw, pf),
               js.grey_equilibrium_sensitivity(jw, jf)) <= REL


def test_grey_J_and_dF_match_jax(grey1):
    jw, pw = grey1
    T = np.asarray(jw.state.T)[:, 0]
    p_col = np.asarray(jw.p_interface)[:, 0]
    jf = jw.forcing
    jdf = jax.tree_util.tree_map(jnp.zeros_like, jf).replace(
        F_stellar=jnp.ones_like(jf.F_stellar))
    J_j = jax.jit(jax.jacfwd(lambda x: js._grey_tendency(x, jf, p_col)))(
        jnp.asarray(T))
    _, dF_j = jax.jvp(lambda f: js._grey_tendency(jnp.asarray(T), f, p_col),
                      (jf,), (jdf,))
    pf = pw.forcing
    J_p, dF_p = ps._grey_J_dF(torch.tensor(T), torch.tensor(p_col), pf,
                              ps._unit_insolation(pf))
    diag = np.abs(np.diag(np.asarray(J_j))).max()
    assert np.abs(J_p.numpy() - np.asarray(J_j)).max() <= JF_REL * diag
    assert rel(dF_p.numpy(), dF_j) <= JF_REL
    # the Planck feedback: a strongly negative diagonal
    assert (np.diag(J_p.numpy()) < 0).all()


def test_grey_rce_sensitivity_matches_jax_and_the_oracle(grey_rce):
    jw, pw = grey_rce
    want = js.grey_rce_equilibrium_sensitivity(jw)
    got = ps.grey_rce_equilibrium_sensitivity(pw)
    assert got.shape == want.shape == (59, 1)
    assert rel(got, want) <= REL
    # the oracle survives convection, on the optically active cells: the
    # JAX suite holds its nz = 150 isotonic endpoint to 1%
    # (tests/test_sensitivity.py:248-255); this nz = 60 grid's pool edge is
    # coarser and JAX's own endpoint reads 1.6% there, so 2%
    act = np.abs(pw.dtau) > 0.03
    assert np.abs(got / (pw.T / (4.0 * F_sun)) - 1)[act].max() < 0.02


def single_line_kw(hum):
    return dict(nz=40, ny=1, molecule_names=['single_line'], T_g=260.0,
                q_funcs={'single_line': hum.co2},
                q_funcs_args={'single_line': ()}, delta_temp_change=0.1)


@pytest.fixture(scope='module')
def real_gas():
    jg = JReal(dtype=np.float64, **single_line_kw(jhum))
    jg.evolve_to_equilibrium(flux_thresh=1e-4, save=False, t_end=30.0)
    pg = PReal(dtype=torch.float64, device='cpu', **single_line_kw(phum))
    pg.T = np.asarray(jg.state.T)
    return jg, pg


def directions(jg):
    return {'F_scale': dict(d_F_scale=0.01), 'T_g': dict(d_T_g=1.0),
            'tau': dict(d_tau_interface=0.01 * np.asarray(jg.tau_interface)),
            'all': dict(d_F_scale=0.01, d_T_g=0.5,
                        d_tau_interface=0.02 * np.asarray(jg.tau_interface))}


@pytest.mark.parametrize('direction', ['F_scale', 'T_g', 'tau', 'all'])
def test_real_gas_sensitivity_matches_jax(real_gas, direction):
    jg, pg = real_gas
    kw = directions(jg)[direction]
    want = js.real_gas_equilibrium_sensitivity(jg, **kw)
    got = ps.real_gas_equilibrium_sensitivity(pg, **kw)
    assert got.shape == (39,)
    assert np.isfinite(got).all()
    assert rel(got, want) <= REL
    # no convective pools at a radiative endpoint: the RCE solve is the
    # full solve
    got_rce = ps.real_gas_rce_equilibrium_sensitivity(pg, **kw)
    assert rel(got_rce, js.real_gas_rce_equilibrium_sensitivity(jg, **kw)) \
        <= REL
    assert rel(got_rce, got) <= 1e-10


def test_real_gas_active_mask_pins_zero(real_gas):
    jg, pg = real_gas
    got = ps.real_gas_equilibrium_sensitivity(pg, d_F_scale=0.01,
                                              active_tau_thresh=1e-3)
    want = js.real_gas_equilibrium_sensitivity(jg, d_F_scale=0.01,
                                               active_tau_thresh=1e-3)
    tau = pg.tau_interface
    active = np.abs(np.diff(tau, axis=0)).max(axis=1) > 1e-3
    assert not active.all() and active.any()
    assert np.all(got[~active] == 0.0)
    assert rel(got, want) <= REL


def test_real_gas_J_and_dF_match_jax(real_gas):
    jg, pg = real_gas
    tau = 0.01 * np.asarray(jg.tau_interface)
    _, J_j, dF_j = js._real_gas_J_dF(jg, tau, 0.01, 0.5)
    _, J_p, dF_p = ps._real_gas_J_dF(pg, tau, 0.01, 0.5)
    diag = np.abs(np.diag(np.asarray(J_j))).max()
    assert np.abs(J_p.numpy() - np.asarray(J_j)).max() <= JF_REL * diag
    assert rel(dF_p.numpy(), dF_j) <= JF_REL


def test_sensitivity_keeps_the_worlds_device_and_dtype(grey1):
    """The solve runs where the world lives; the result is host NumPy."""
    _, pw = grey1
    assert pw.device.type == 'cpu'
    assert ps.grey_equilibrium_sensitivity(pw).dtype == np.float64
    f = pw.forcing
    names = [x.name for x in dataclasses.fields(f)]
    assert all(getattr(f, k).dtype == torch.float64 for k in names)
