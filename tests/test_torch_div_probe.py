"""Port vs JAX: the division probe (K7, ``tools/probe_mosaic_div.py``).

The plain version ``ops/convection.div_probe_plain`` is held bit for bit to
the JAX package's own probe on its inputs (the Pallas ``_kernel`` in
interpret mode and ``via_xla``), and to numpy's f32 arithmetic on the
probe's edge operands (signed zeros, subnormals, the ends of the range,
infinities, NaN; NaN payloads aside).  ``div_probe_warp_paths`` counts the
warps of the ``div_probe`` kernel that take each division form; the card
check is the ``div_probe`` phase of ``chip_smoke.py``, which builds its
inputs with the same functions."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
from climatemodel_tpu_torch.ops import convection as pc

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope='module')
def probe():
    """``tools/probe_mosaic_div.py``, imported by its path."""
    spec = importlib.util.spec_from_file_location(
        'probe_mosaic_div', ROOT / 'tools' / 'probe_mosaic_div.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain(a, b):
    return [x.numpy() for x in pc.div_probe(torch.from_numpy(a),
                                            torch.from_numpy(b))]


def test_probe_inputs_are_the_tools():
    """chip_smoke's probe inputs are the tool's (seed 11, [256, 128])."""
    rng = np.random.default_rng(11)
    a = np.float32(10.0 ** rng.uniform(-6, 4, (256, 128))
                   * rng.choice([-1, 1], (256, 128)))
    b = np.float32(10.0 ** rng.uniform(-4, 5, (256, 128))
                   * rng.choice([-1, 1], (256, 128)))
    got_a, got_b = chip_smoke.probe_inputs()
    np.testing.assert_array_equal(got_a, a)
    np.testing.assert_array_equal(got_b, b)


@pytest.mark.parametrize('jax_route', ['pallas_interpret', 'via_xla'])
def test_plain_bit_equal_to_jax_probe(probe, jax_route):
    """div_probe_plain against the JAX package's K7 on the probe's inputs:
    the Pallas ``_kernel`` run in interpret mode, and ``via_xla``; all three
    quotients bit for bit."""
    a, b = chip_smoke.probe_inputs()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if jax_route == 'via_xla':
        want = probe.via_xla(ja, jb)
    else:
        want = pl.pallas_call(
            probe._kernel,
            out_shape=[jax.ShapeDtypeStruct(a.shape, jnp.float32)] * 3,
            interpret=True)(ja, jb)
    for got, w in zip(_plain(a, b), jax.device_get(want)):
        assert w.dtype == np.float32
        assert chip_smoke.same_bits(got, np.asarray(w))


@pytest.mark.parametrize('case', ['in_range', 'ends'])
def test_plain_bit_equal_to_numpy_on_cases(case):
    """The plain version on chip_smoke's two further cases bit-equal to
    numpy's f32 division (the sign of zero included, NaN payloads aside);
    the 'ends' case holds every special operand."""
    a, b = chip_smoke.div_probe_cases()[case]
    assert a.shape == b.shape == (256, 128)
    assert a.dtype == b.dtype == np.float32
    if case == 'ends':
        for x in (a, b):
            for s in chip_smoke.DIV_PROBE_SPECIALS:
                s = np.float32(s)
                hit = (np.isnan(x) if np.isnan(s) else
                       x.view(np.uint32) == s.view(np.uint32))
                assert hit.any(), s
    C = np.float32(pc.DIV_PROBE_C)
    outs = _plain(a, b)
    for got, want in zip(outs, chip_smoke.div_probe_numpy(a, b, C)):
        assert got.dtype == np.float32
        assert chip_smoke.same_bits(got, want)
    if case == 'ends':
        assert np.isnan(outs[0]).any() and np.isinf(outs[0]).any()
        zeros = outs[0][outs[0] == 0]
        assert np.signbit(zeros).any() and not np.signbit(zeros).all()
        tiny = np.abs(outs[0]) < np.finfo(np.float32).tiny
        assert (tiny & (outs[0] != 0)).any()        # subnormal quotients


def test_same_bits_tells_signed_zeros_and_nans_apart():
    x = np.float32([0.0, 1.0, np.nan])
    assert chip_smoke.same_bits(x, np.float32([0.0, 1.0, -np.nan]))
    assert not chip_smoke.same_bits(x, np.float32([-0.0, 1.0, np.nan]))
    assert not chip_smoke.same_bits(x, np.float32([0.0, np.nan, np.nan]))


def test_warp_paths_on_the_cases():
    """Both forms on the probe's inputs (|C a| falls below 2^-20 in every
    warp, |a| and |b| never leave the range); every warp fast on
    'in_range'; on 'ends' the special rows take `/` and the range-end rows
    the fast form, +0 over a negative denominator aside."""
    a, b = (torch.from_numpy(x) for x in chip_smoke.probe_inputs())
    paths = pc.div_probe_warp_paths(a, b)
    assert paths == {'a_div_b': {'fast': 256, 'div_rn': 0},
                     'c_mul_a_div_b': {'fast': 0, 'div_rn': 256},
                     'a_div_abs_b': {'fast': 256, 'div_rn': 0}}
    cases = chip_smoke.div_probe_cases()
    paths = pc.div_probe_warp_paths(
        *(torch.from_numpy(x) for x in cases['in_range']))
    assert all(p == {'fast': 256, 'div_rn': 0} for p in paths.values())
    paths = pc.div_probe_warp_paths(
        *(torch.from_numpy(x) for x in cases['ends']))
    # rows 0-127 specials: `/`; 128-191 +-2^-20, +-2^40: a/b and a/|b| fast
    # (C a of 2^-20 is out of range); 192-223 +0 numerators over signed
    # denominators: a/|b| fast only; 224-255 +0 over positive: all fast
    assert paths == {'a_div_b': {'fast': 96, 'div_rn': 160},
                     'c_mul_a_div_b': {'fast': 32, 'div_rn': 224},
                     'a_div_abs_b': {'fast': 128, 'div_rn': 128}}


def _one_pair(x, y):
    """The paths of a single element x / y, in one (padded) warp."""
    return pc.div_probe_warp_paths(torch.tensor([x], dtype=torch.float32),
                                   torch.tensor([y], dtype=torch.float32))


@pytest.mark.parametrize('x, fast', [
    (2.0 ** -20, True), (2.0 ** 40, True), (-(2.0 ** 40), True),
    (float(np.nextafter(np.float32(2.0 ** -20), np.float32(0))), False),
    (float(np.nextafter(np.float32(2.0 ** 40), np.float32(np.inf))), False),
    (0.0, True), (-0.0, False), (float('nan'), False), (float('inf'), False)])
def test_warp_paths_range_ends(x, fast):
    """in_fast_range's ends: 2^-20 and 2^40 are in, the next f32 outward
    is not; +0 passes as a numerator (over a positive denominator), -0
    does not; as a denominator only the range counts."""
    form = 'fast' if fast else 'div_rn'
    other = 'div_rn' if fast else 'fast'
    got = _one_pair(x, 3.0)['a_div_b']
    assert got[form] == 1 and got[other] == 0
    if x != 0:
        got = _one_pair(1.0, x)['a_div_b']
        assert got[form] == 1 and got[other] == 0


def test_warp_paths_positive_zero_over_negative():
    """div_rn_in_range returns +0 for +0 over a negative denominator, where
    div.rn returns -0: such a pair takes `/`, except in a / |b|."""
    got = _one_pair(0.0, -3.0)
    assert got['a_div_b'] == {'fast': 0, 'div_rn': 1}
    assert got['c_mul_a_div_b'] == {'fast': 0, 'div_rn': 1}
    assert got['a_div_abs_b'] == {'fast': 1, 'div_rn': 0}


def test_warp_paths_chunks():
    """A warp holds 128 consecutive elements of the flattened inputs; the
    last one is padded with in-range operands."""
    a = torch.ones(300)
    b = torch.ones(300)
    a[130] = 0.5 ** 30                          # second warp, out of range
    paths = pc.div_probe_warp_paths(a.reshape(3, 100), b.reshape(3, 100))
    assert paths['a_div_b'] == {'fast': 2, 'div_rn': 1}
    assert pc.div_probe_warp_paths(a[:0], b[:0])['a_div_b'] == \
        {'fast': 0, 'div_rn': 0}
