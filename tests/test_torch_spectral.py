"""Port vs JAX: the real-gas model's host spectroscopy — the Planck
functions, the q and T profiles, the wavenumber bands, the HITRAN line
pipeline and the earth-table build (``ops/planck.py``, ``spectral/``).

Host NumPy float64 throughout, so everything is held bit-equal: the
port's line accumulation with ``backend='numpy'`` to the JAX package's
``backend='numpy'``, and the port's default (its own build of the same C++
accumulator) to the JAX package's default.  The other backends are held in
``tests/test_torch_native.py``.  The table-folder rules (look up, build at
first use, never write into the JAX package's data folder) and the
earth-table stamp rules (tests/test_earth_tables.py:55-96 for JAX) run in
temporary folders.
"""
import os

import numpy as np
import pytest
import torch

from climatemodel_tpu.ops import planck as jpl
from climatemodel_tpu.spectral import bands as jbands
from climatemodel_tpu.spectral import earth_tables as jet
from climatemodel_tpu.spectral import hitran as jh
from climatemodel_tpu.spectral import humidity as jhum
from climatemodel_tpu.spectral import temperature_profiles as jtp
from climatemodel_tpu_torch.ops import planck as ppl
from climatemodel_tpu_torch.spectral import bands as pbands
from climatemodel_tpu_torch.spectral import earth_tables as pet
from climatemodel_tpu_torch.spectral import hitran as ph
from climatemodel_tpu_torch.spectral import humidity as phum
from climatemodel_tpu_torch.spectral import temperature_profiles as ptp

P = np.logspace(np.log10(1.0132e5), -1, 300)
EARTH = ('CO2', 'CH4', 'H2O', 'O3')


def test_planck_numpy_bit_equal_and_torch_close():
    """B_wavenumber and B_freq on NumPy input give JAX's host values bit for
    bit (overflowing deep-Wien bins included, B = 0); on f64 tensors within
    1e-14 relative (torch's expm1), on the tensor's device and dtype; f32
    tensors stay finite."""
    nu = np.linspace(10.0, 1e5, 2001)
    for T in (150.0, 288.0, 5778.0):
        np.testing.assert_array_equal(ppl.B_wavenumber(nu, T),
                                      jpl.B_wavenumber(nu, T))
        f = nu * 3e10
        np.testing.assert_array_equal(ppl.B_freq(f, T), jpl.B_freq(f, T))
        bt = ppl.B_wavenumber(torch.tensor(nu), torch.tensor(T))
        assert bt.dtype == torch.float64 and bt.device.type == 'cpu'
        want = jpl.B_wavenumber(nu, T)
        assert np.abs(bt.numpy() - want).max() <= 1e-14 * want.max()
        b32 = ppl.B_wavenumber(torch.tensor(nu, dtype=torch.float32), T)
        assert b32.dtype == torch.float32 and bool(torch.isfinite(b32).all())


@pytest.mark.parametrize('name', ['co2', 'ch4', 'h2o', 'o3'])
def test_humidity_profiles_bit_equal(name):
    cases = ((), (0,), (740, 60000)) if name == 'co2' else ((), (0,), (2,))
    for args in cases:
        np.testing.assert_array_equal(getattr(phum, name)(P, *args),
                                      getattr(jhum, name)(P, *args))


def test_humidity_helpers_and_registry_bit_equal():
    np.testing.assert_array_equal(phum.p_altitude_convert(p=P),
                                  jhum.p_altitude_convert(p=P))
    h = np.linspace(0, 1.3e5, 200)
    np.testing.assert_array_equal(phum.p_altitude_convert(altitude=h),
                                  jhum.p_altitude_convert(altitude=h))
    np.testing.assert_array_equal(phum.constant_q(P, 400, 'co2'),
                                  jhum.constant_q(P, 400, 'co2'))
    np.testing.assert_array_equal(phum.gradient_q(P, 400, 100, 50000),
                                  jhum.gradient_q(P, 400, 100, 50000))
    np.testing.assert_array_equal(
        phum.constant_rh(P, ptp.earth_temp, h_upper=15000),
        jhum.constant_rh(P, jtp.earth_temp, h_upper=15000))
    for m in jhum.molecules:
        assert phum.molecules[m]['hitran_id'] == jhum.molecules[m]['hitran_id']
        assert phum.molecules[m]['M'] == jhum.molecules[m]['M']
        assert phum.molecules[m]['q_args'] == jhum.molecules[m]['q_args']
        assert phum.molecules[m]['q'].__name__ == \
            jhum.molecules[m]['q'].__name__
    q = jhum.h2o(P)
    np.testing.assert_array_equal(phum.ppmv_from_humidity(q, 'H2O'),
                                  jhum.ppmv_from_humidity(q, 'H2O'))


@pytest.mark.parametrize('name', ['earth_temp', 'fixed_tropopause_temp',
                                  'two_lapse_temp'])
def test_temperature_profiles_bit_equal(name):
    np.testing.assert_array_equal(getattr(ptp, name)(P),
                                  getattr(jtp, name)(P))


@pytest.mark.parametrize('T_g,n_bands', [(260.0, 30), (265.19, 200),
                                         (288.0, 40)])
def test_bands_bit_equal(T_g, n_bands):
    """get_wavenumber_array and get_wavenumber_bands (with get_equal_bands)
    at the toy column's 30 bands, the earth column's 200 and the default
    40."""
    a = pbands.get_wavenumber_array(T_g, 5778.0, 10.0)
    b = jbands.get_wavenumber_array(T_g, 5778.0, 10.0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    pb = pbands.get_wavenumber_bands(n_bands, T_g, 5778.0, *a[1:])
    jb = jbands.get_wavenumber_bands(n_bands, T_g, 5778.0, *b[1:])
    for k in ('centre', 'delta', 'sw'):
        np.testing.assert_array_equal(pb[k], jb[k])
    assert len(pb['range']) == len(jb['range']) == n_bands
    for x, y in zip(pb['range'], jb['range']):
        np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------------------
# the HITRAN line pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize('name', EARTH)
def test_line_data_bit_equal(name):
    """load_molecule_data (the shipped fixture, read by path), the
    histogram wavenumber range and the range cut, as JAX gives them."""
    pd = ph.load_molecule_data(name)
    jd = jh.load_molecule_data(name)
    assert set(pd) == set(jd)
    for k in jd:
        np.testing.assert_array_equal(pd[k], jd[k], k)
    nu = ph.get_wavenumber_array(pd)
    np.testing.assert_array_equal(nu, jh.get_wavenumber_array(jd))
    cut_p = ph.update_molecule_data(pd, nu[:len(nu) // 2])
    cut_j = jh.update_molecule_data(jd, nu[:len(nu) // 2])
    for k in jd:
        np.testing.assert_array_equal(cut_p[k], cut_j[k], k)


def test_line_physics_bit_equal():
    p = np.logspace(5, 2, 20)
    T = np.linspace(250, 320, 20)
    np.testing.assert_array_equal(ph.gamma_extrapolate(p, T, 0.08, 0.7),
                                  jh.gamma_extrapolate(p, T, 0.08, 0.7))
    # JAX's s_extrapolate takes XLA's exp, the port's (like JAX's NumPy
    # accumulator) NumPy's: within an ulp
    np.testing.assert_allclose(
        ph.s_extrapolate(T, 3.5, 667.0, 0.7),
        np.asarray(jh.s_extrapolate(T, 3.5, 667.0, 0.7)), rtol=1e-15)
    nu = np.linspace(600, 700, 50)
    np.testing.assert_allclose(ph.lorentzian_profile(nu, 667.0, 0.1),
                               np.asarray(jh.lorentzian_profile(nu, 667.0,
                                                                0.1)),
                               rtol=1e-15)
    np.testing.assert_array_equal(ph.s_conversion(1e-19, 44.0),
                                  jh.s_conversion(1e-19, 44.0))


@pytest.mark.parametrize('name', EARTH)
def test_absorption_coefficient_reduced_grid(name):
    """get_absorption_coefficient on a reduced grid (20 pressures, two
    temperatures, the gas's own wavenumbers): ``backend='numpy'`` bit-equal
    to JAX's ``backend='numpy'``; the default (the C++ accumulator where
    ``g++`` builds it) bit-equal to JAX's default, and within 1e-14
    relative of the NumPy chunks (measured below 5e-16)."""
    lines = jh.update_molecule_data(jh.load_molecule_data(name),
                                    jh.get_wavenumber_array(
                                        jh.load_molecule_data(name)))
    nu = jh.get_wavenumber_array(jh.load_molecule_data(name))
    p = np.logspace(np.log10(1.0132e5), np.log10(20.0), 20)
    for T in (250.0, 330.0):
        Tc = np.full(p.size, T)
        got = ph.get_absorption_coefficient(p, Tc, nu, lines,
                                            backend='numpy')
        want = jh.get_absorption_coefficient(p, Tc, nu, lines,
                                             backend='numpy')
        np.testing.assert_array_equal(got, want)
        dflt = ph.get_absorption_coefficient(p, Tc, nu, lines)
        np.testing.assert_array_equal(
            dflt, jh.get_absorption_coefficient(p, Tc, nu, lines))
        assert np.abs(got - dflt).max() <= 1e-14 * np.abs(dflt).max()


def _forcing_numpy(mod):
    """``mod.get_absorption_coefficient`` with ``backend='numpy'`` whatever
    backend its caller passes: the JAX package's table builders take no
    ``backend`` (the port's do)."""
    fn = mod.get_absorption_coefficient
    return lambda *a, **k: fn(*a, **{**k, 'backend': 'numpy'})


def test_cross_sections_and_toy_tables_bit_equal(tmp_path):
    """The .xsc loader (O3 with its symmetric extension, CFC12), and the
    single_line / gray generators: with the default line accumulation
    bit-equal to the JAX package's generators, and with ``backend='numpy'``
    (the backend the shipped tables were built with) bit-equal to the
    shipped tables."""
    wn = np.arange(0.0, 1405.0, 10.0)
    p = ph.table_p_values[:5]
    T = ph.table_T_values[:2]
    for mol, w in (('O3', wn), ('CFC12', np.arange(0.0, 805.0, 10.0))):
        a = ph.load_from_cross_section_xsc(w, p, T, molecule=mol)
        b = jh.load_from_cross_section_xsc(w, p, T, molecule=mol)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    out = str(tmp_path)
    for make, jmake, name in (
            (ph.make_single_line_table, jh.make_single_line_table,
             'single_line'),
            (ph.make_gray_table, jh.make_gray_table, 'gray')):
        tab = make(output_folder=out)
        jtab = jmake(output_folder=str(tmp_path / 'jax'))
        for k in ('p', 'T', 'nu', 'absorption_coef'):
            np.testing.assert_array_equal(tab[k], jtab[k], (name, k))
        assert os.path.isfile(os.path.join(out, name + '.npy'))
        numpy_kw = {'backend': 'numpy'} if name == 'single_line' else {}
        tab = make(output_folder=str(tmp_path / 'numpy'), **numpy_kw)
        ship = np.load(os.path.join(ph.SHIPPED_TABLE_DIR, name + '.npy'),
                       allow_pickle=True).item()
        for k in ('p', 'T', 'nu', 'absorption_coef'):
            np.testing.assert_array_equal(tab[k], ship[k], (name, k))
    with pytest.raises(ValueError, match='already exists'):
        ph.make_single_line_table(output_folder=out, overwrite=False)


def test_table_folders(tmp_path, monkeypatch):
    """The shipped toy tables are read from the JAX package's data folder by
    path; the port's writable folder comes first and takes
    $CLIMATEMODEL_TPU_TORCH_LUT_DIR; a missing earth table is built there
    at first use; nothing is written into the shipped folder."""
    monkeypatch.setenv(ph.LUT_ENV, str(tmp_path))
    shipped = sorted(os.listdir(ph.SHIPPED_TABLE_DIR))
    assert ph.find_table('single_line') == os.path.join(
        ph.SHIPPED_TABLE_DIR, 'single_line.npy')
    assert ph.find_table('CO2') is None
    with pytest.raises(FileNotFoundError):
        ph.load_table('not_a_gas')
    co2 = ph.load_table('CO2')                  # builds all four, here
    assert co2['absorption_coef'].shape == (200, 6, 281)
    assert {f'{g}.npy' for g in EARTH} <= set(os.listdir(tmp_path))
    ph.make_gray_table(k=2.0)
    assert ph.load_table('gray')['absorption_coef'].max() == 2.0
    assert sorted(os.listdir(ph.SHIPPED_TABLE_DIR)) == shipped
    assert ph.lookup_table_folder() == str(tmp_path)
    monkeypatch.delenv(ph.LUT_ENV)
    assert ph.lookup_table_folder() == ph.BUILD_TABLE_DIR


# --------------------------------------------------------------------------
# the earth tables
# --------------------------------------------------------------------------

def test_earth_tables_bit_equal_to_jax_numpy_backend(tmp_path, monkeypatch):
    """ensure_earth_tables builds the four [200, 6, n_nu] tables from the
    shipped fixtures: with ``backend='numpy'`` bit-equal to the JAX
    package's build with ``backend='numpy'``, and with the default backend
    bit-equal to the JAX package's default build; the fixture lines and
    digest match JAX's."""
    out, built = pet.ensure_earth_tables(str(tmp_path / 'port'))
    assert set(built) == set(EARTH)
    jet.ensure_earth_tables(str(tmp_path / 'jax'))
    for backend in ('numpy', 'default'):
        if backend == 'numpy':
            out = str(tmp_path / 'port_numpy')
            pet.ensure_earth_tables(out, backend='numpy')
            monkeypatch.setattr(jh, 'get_absorption_coefficient',
                                _forcing_numpy(jh))
            jet.ensure_earth_tables(str(tmp_path / 'jax_numpy'))
            jax_out = str(tmp_path / 'jax_numpy')
            monkeypatch.undo()
        else:
            out, jax_out = str(tmp_path / 'port'), str(tmp_path / 'jax')
        for name in EARTH:
            a = ph.load_table(name, out)
            b = jh.load_table(name, jax_out)
            assert a['absorption_coef'].shape[:2] == (200, 6)
            for k in ('p', 'T', 'nu', 'absorption_coef'):
                np.testing.assert_array_equal(a[k], b[k], (backend, name, k))
        fp = pet.fabricate_molecule_lines(name)
        fj = jet.fabricate_molecule_lines(name)
        for k in fj:
            np.testing.assert_array_equal(fp[k], fj[k])
    assert pet._fixture_digest() == jet._fixture_digest()
    assert pet.fixture_folder() == ph.DEFAULT_LINE_DATA_DIR


def test_fixture_writers_reproduce_the_shipped_fixtures(tmp_path):
    """The fixture writers, pointed at an empty folder, write the shipped
    files byte for byte (same digest)."""
    pet.write_line_fixtures(str(tmp_path))
    pet.write_uv_fixtures(str(tmp_path))
    assert pet._fixture_digest(str(tmp_path)) == pet._fixture_digest()


def test_earth_table_stamp_rules(tmp_path, monkeypatch):
    """The stamp rules of tests/test_earth_tables.py:55-96: a second call
    builds nothing; a fixture change rebuilds; a user-dropped table (crc no
    longer the stamp's) survives a fixture change; a schema-incomplete
    stamp keeps every table, with a warning."""
    out = str(tmp_path)
    _, built = pet.ensure_earth_tables(out)
    assert set(built) == set(EARTH)
    assert pet.ensure_earth_tables(out)[1] == []
    monkeypatch.setattr(pet, '_fixture_digest', lambda folder=None: 'dead')
    assert set(pet.ensure_earth_tables(out)[1]) == set(EARTH)
    co2_path = ph.table_path('CO2', out)
    with open(co2_path, 'wb') as f:
        f.write(b'USER SUPPLIED REAL SPECTROSCOPY')
    monkeypatch.setattr(pet, '_fixture_digest', lambda folder=None: 'beef')
    assert set(pet.ensure_earth_tables(out)[1]) == {'CH4', 'H2O', 'O3'}
    with open(co2_path, 'rb') as f:
        assert f.read() == b'USER SUPPLIED REAL SPECTROSCOPY'
    with open(os.path.join(out, '_earth_fixture_stamp.json'), 'w') as f:
        f.write('{}')
    with pytest.warns(UserWarning, match='predate the fixture stamp'):
        assert pet.ensure_earth_tables(out)[1] == []
