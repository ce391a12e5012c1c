"""Port vs JAX: the C++ host data plane (``climatemodel_tpu_torch/native``)
and the line-accumulation backends of ``spectral/hitran``.

* The port's library (its own copy of ``hitran_native.cpp``, built into
  ``build/native/``) is bit-equal to the JAX package's native library: the
  accumulator on the 80-line list of tests/test_hitran.py:127-148 and on
  the four earth gases at a reduced grid, the parser on the shipped line
  files and on a ragged file (tests/test_hitran.py:199).
* ``backend='torch'`` on the CPU in f64 is within 1e-12 relative of JAX's
  ``backend='jax'`` (elementwise, as tests/test_hitran.py:146 holds JAX's
  two backends).
* ``'auto'`` takes 'native' where the library builds and 'torch' where no
  compiler is found; a compiler that fails raises its own message.
* A process that uses the port's library never maps the JAX package's
  ``_hitran_native.so``.

Tests that build the library skip with a reason where ``g++`` is absent.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from climatemodel_tpu import native as jnative
from climatemodel_tpu.spectral import hitran as jh
from climatemodel_tpu_torch import native as pnative
from climatemodel_tpu_torch.ops import _cuda_build
from climatemodel_tpu_torch.spectral import hitran as ph

EARTH = ('CO2', 'CH4', 'H2O', 'O3')
HCK = 100.0 * ph.h_planck * ph.speed_of_light / ph.k_boltzmann


def _need_gxx():
    if shutil.which('g++') is None:
        pytest.skip('g++ not on PATH: the native library cannot be built')


def _eighty_lines():
    """The line list of tests/test_hitran.py:127-148."""
    rng = np.random.default_rng(9)
    L = 80
    lines = {'nu': np.sort(rng.uniform(300, 900, L)),
             'sw': 10.0 ** rng.uniform(-2, 2, L),
             'gamma_air': rng.uniform(0.02, 0.12, L),
             'n_air': rng.uniform(0.4, 0.9, L)}
    p = np.logspace(np.log10(101320), np.log10(1000), 40)
    T = np.full(40, 290.0)
    nu = np.arange(250.0, 1000.0, 10.0)
    return p, T, nu, lines


def _earth_case(name):
    """A gas's shipped line list on a reduced grid: 20 pressures, its own
    wavenumbers."""
    data = jh.load_molecule_data(name)
    nu = jh.get_wavenumber_array(data)
    lines = jh.update_molecule_data(data, nu)
    p = np.logspace(np.log10(1.0132e5), np.log10(20.0), 20)
    return p, nu, lines


def test_accumulate_lines_bit_equal_to_jax_native():
    _need_gxx()
    assert pnative.available() and jnative.available()
    p, T, nu, lines = _eighty_lines()
    got = pnative.accumulate_lines(p, T, nu, lines, 1000, ph.p_reference,
                                   ph.T_reference, HCK)
    want = jnative.accumulate_lines(p, T, nu, lines, 1000, jh.p_reference,
                                    jh.T_reference, HCK)
    assert got.shape == (40, nu.size) and got.max() > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ph.get_absorption_coefficient(p, T, nu, lines, backend='native'),
        jh.get_absorption_coefficient(p, T, nu, lines, backend='native'))


@pytest.mark.parametrize('name', EARTH)
def test_earth_gases_native_bit_equal_and_torch_close(name):
    """'native' bit-equal to JAX's 'native'; 'torch' (and its alias 'jax')
    on the CPU within 1e-12 relative of JAX's 'jax' and of 'native'."""
    _need_gxx()
    p, nu, lines = _earth_case(name)
    for T in (250.0, 330.0):
        Tc = np.full(p.size, T)
        nat = ph.get_absorption_coefficient(p, Tc, nu, lines,
                                            backend='native')
        np.testing.assert_array_equal(
            nat, jh.get_absorption_coefficient(p, Tc, nu, lines,
                                               backend='native'))
        tor = ph.get_absorption_coefficient(p, Tc, nu, lines,
                                            backend='torch', device='cpu')
        jax_ = jh.get_absorption_coefficient(p, Tc, nu, lines, backend='jax')
        np.testing.assert_allclose(tor, jax_, rtol=1e-12, atol=0)
        np.testing.assert_allclose(tor, nat, rtol=1e-12, atol=0)
        np.testing.assert_array_equal(
            ph.get_absorption_coefficient(p, Tc, nu, lines, backend='jax',
                                          device='cpu'), tor)


def test_torch_backend_close_to_jax_backend():
    """The 80-line list through several chunks (chunk=16: five chunks, the
    last padded) and the default chunk: within 1e-12 relative of JAX's
    'jax' with the same chunk; float64 numpy out."""
    p, T, nu, lines = _eighty_lines()
    for chunk in (16, 512):
        got = ph.get_absorption_coefficient(p, T, nu, lines, chunk=chunk,
                                            backend='torch', device='cpu')
        want = jh.get_absorption_coefficient(p, T, nu, lines, chunk=chunk,
                                             backend='jax')
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    empty = {k: v[:0] for k, v in lines.items()}
    assert not ph.get_absorption_coefficient(p, T, nu, empty,
                                             backend='torch',
                                             device='cpu').any()


def test_parse_numeric_table_bit_equal_to_jax(tmp_path):
    """The shipped line files, a ragged file and load_molecule_data's
    native route: bit-equal to the JAX package's native parser."""
    _need_gxx()
    for name in EARTH:
        path = os.path.join(ph.DEFAULT_LINE_DATA_DIR, name + '.txt')
        got = pnative.parse_numeric_table(path)
        assert got.shape[1] == 7 and got.shape[0] > 50
        np.testing.assert_array_equal(got, jnative.parse_numeric_table(path))
        pd, jd = ph.load_molecule_data(name), jh.load_molecule_data(name)
        for k in jd:
            np.testing.assert_array_equal(pd[k], jd[k], (name, k))
    path = tmp_path / 'tab.txt'
    path.write_text('a b c\n1 2 3\n4 5 6 99\n7 8\n10 11 12\n')
    body = pnative.parse_numeric_table(str(path))
    np.testing.assert_array_equal(body, [[1, 2, 3], [10, 11, 12]])
    np.testing.assert_array_equal(body,
                                  jnative.parse_numeric_table(str(path)))
    with pytest.raises(OSError):
        pnative.parse_numeric_table(str(tmp_path / 'absent.txt'))


def test_auto_backend_resolves_as_stated(monkeypatch):
    """'auto' is 'native' where the library is available, else 'torch' in
    float64 on ``device``; an unknown backend raises."""
    _need_gxx()
    p, T, nu, lines = _eighty_lines()
    nat = ph.get_absorption_coefficient(p, T, nu, lines, backend='native')
    np.testing.assert_array_equal(
        ph.get_absorption_coefficient(p, T, nu, lines), nat)
    tor = ph.get_absorption_coefficient(p, T, nu, lines, backend='torch',
                                        device='cpu')
    monkeypatch.setattr(pnative, 'available', lambda: False)
    np.testing.assert_array_equal(
        ph.get_absorption_coefficient(p, T, nu, lines, device='cpu'), tor)
    with pytest.raises(ValueError, match='unknown backend'):
        ph.get_absorption_coefficient(p, T, nu, lines, backend='cuda')


def test_build_rules(tmp_path, monkeypatch):
    """The build goes into BUILD_DIR under a name hashed from source and
    flags; the OpenMP build and the build without it give the same bits;
    with no g++ on PATH (and nothing cached) the library is unavailable;
    a g++ that fails raises its message, never a stale library."""
    _need_gxx()
    p, T, nu, lines = _eighty_lines()
    want = pnative.accumulate_lines(p, T, nu, lines, 1000, ph.p_reference,
                                    ph.T_reference, HCK)
    assert str(pnative.build()).startswith(str(pnative.BUILD_DIR))
    monkeypatch.setattr(pnative, 'BUILD_DIR', tmp_path / 'b')
    monkeypatch.setattr(pnative, '_lib', None)
    for flags in pnative.FLAG_SETS:
        out = pnative._target(flags)
        assert _cuda_build.compile_to(['g++', *flags, str(pnative.SRC)],
                                      out).returncode == 0
        lib = pnative._bind(out)
        monkeypatch.setattr(pnative, '_lib', lib)
        np.testing.assert_array_equal(
            pnative.accumulate_lines(p, T, nu, lines, 1000, ph.p_reference,
                                     ph.T_reference, HCK), want)
    assert len({pnative._target(f) for f in pnative.FLAG_SETS}) == 2

    monkeypatch.setattr(pnative, '_lib', None)
    monkeypatch.setattr(pnative, 'BUILD_DIR', tmp_path / 'empty')
    monkeypatch.setattr(pnative.shutil, 'which', lambda name: None)
    assert not pnative.available()
    with pytest.raises(RuntimeError, match='unavailable'):
        pnative.accumulate_lines(p, T, nu, lines, 1000, ph.p_reference,
                                 ph.T_reference, HCK)
    monkeypatch.undo()

    broken = tmp_path / 'broken.cpp'
    broken.write_text('int f( {\n')
    monkeypatch.setattr(pnative, 'SRC', broken)
    monkeypatch.setattr(pnative, 'BUILD_DIR', tmp_path / 'c')
    monkeypatch.setattr(pnative, '_lib', None)
    with pytest.raises(RuntimeError, match='broken.cpp'):
        pnative.available()
    assert not list((tmp_path / 'c').glob('*.so'))


def test_port_never_maps_the_jax_library():
    """A fresh process that builds and uses the port's native library (the
    parser, the accumulator and the default table path) has the port's
    library mapped and the JAX package's ``_hitran_native.so`` not."""
    _need_gxx()
    if not os.path.exists('/proc/self/maps'):
        pytest.skip('no /proc/self/maps on this system')
    code = (
        'import numpy as np\n'
        'from climatemodel_tpu_torch.spectral import hitran\n'
        'd = hitran.load_molecule_data("CH4")\n'
        'nu = hitran.get_wavenumber_array(d)\n'
        'd = hitran.update_molecule_data(d, nu)\n'
        'k = hitran.get_absorption_coefficient(np.array([1e5]),'
        ' np.array([280.0]), nu, d)\n'
        'assert k.max() > 0\n'
        'maps = open("/proc/self/maps").read()\n'
        'assert "libhitran_native_" in maps, maps\n'
        'assert "_hitran_native.so" not in maps\n'
        'assert "climatemodel_tpu/native" not in maps\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
