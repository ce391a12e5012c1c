"""Port vs JAX: band optical depth, packed bands, flux-integral weights and
the transmission functions (``ops/transmission.py``), and the
TransmissionCache folded from them (``models/real_gas.precompute_
transmission``) in both layouts.

Host parts (tau, the lookups, PackedBands, the weights) are NumPy float64
and bit-equal.  The device parts run in f64 on the CPU from JAX's own tau:
within 1e-12 relative of the quantity's scale.  One field needs its scale
stated: ``toa_down`` is W x (Tr[1, j] - Tr[0, j]) / dp of two transmissions
that are both ~1 at the TOA, so it carries the rounding of Tr (1e-16 of 1)
amplified by the cancellation; it is held within 1e-12 of the scale of the
terms it is the difference of.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.models import real_gas as jrg
from climatemodel_tpu.ops import transmission as jtr
from climatemodel_tpu.spectral import humidity as jhum
from climatemodel_tpu_torch.models import real_gas as prg
from climatemodel_tpu_torch.ops import transmission as ptr
from climatemodel_tpu_torch.spectral import earth_tables as pet
from climatemodel_tpu_torch.spectral import hitran as ph
from climatemodel_tpu_torch.spectral import humidity as phum
from climatemodel_tpu_torch.utils import interop

EARTH = ['CO2', 'CH4', 'H2O', 'O3']


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    """(JAX, port) f64 worlds: the single-line column (nz = 30, 30 bands)
    and the earth column (nz = 40, 40 bands), on the same tables."""
    folder = str(tmp_path_factory.mktemp('lut'))
    pet.ensure_earth_tables(folder)
    out = {}
    for name, kw in (
            ('single_line', lambda h: dict(
                nz=30, ny=1, molecule_names=['single_line'], T_g=260.0,
                q_funcs={'single_line': h.co2},
                q_funcs_args={'single_line': ()}, n_nu_bands=30)),
            ('earth', lambda h: dict(
                nz=40, ny=1, molecule_names=EARTH, T_g=265.19, p_toa=0.1,
                table_folder=folder))):
        out[name] = (jrg.RealGas(dtype=jnp.float64, **kw(jhum)),
                     prg.RealGas(dtype=torch.float64, device='cpu',
                                 **kw(phum)))
    return out


def _np(x):
    return {k: (None if v is None else np.asarray(v)) for k, v in
            dataclasses.asdict(jax.device_get(x)).items()}


def test_host_parts_bit_equal(worlds):
    """optical_depth (through the molecules' lookups), nearest_lookup,
    crop_lookup, _trapz_weights, PackedBands and flux_integral_weights."""
    for jw, pw in worlds.values():
        p = pw.p_interface[:, 0]
        T = np.linspace(250.0, 300.0, p.size)
        tau_p = ptr.optical_depth(p, T, pw.nu, pw.molecule_names, pw.q_funcs,
                                  pw.q_funcs_args, pw._absorption_lookup, 9.8)
        tau_j = jtr.optical_depth(p, T, jw.nu, jw.molecule_names, jw.q_funcs,
                                  jw.q_funcs_args, jw._absorption_lookup, 9.8)
        np.testing.assert_array_equal(tau_p, tau_j)
        for name in pw.molecule_names:
            table = pw._tables[name]
            np.testing.assert_array_equal(
                ptr.nearest_lookup(p, T, pw.nu[::7], table),
                jtr.nearest_lookup(p, T, jw.nu[::7], table))
            np.testing.assert_array_equal(
                ptr.crop_lookup(p, T, pw.nu, table),
                jtr.crop_lookup(p, T, jw.nu, table))
        pk_p = ptr.PackedBands(pw.nu_bands, pw.nu)
        pk_j = jtr.PackedBands(jw.nu_bands, jw.nu)
        for k in ('idx', 'w', 'delta', 'centre', 'sw', 'lw_list', 'lw_idx',
                  'lw_w', 'lw_delta', 'lw_centre'):
            np.testing.assert_array_equal(getattr(pk_p, k), getattr(pk_j, k))
        for a, b in zip(ptr.flux_integral_weights(p, pw.p[:, 0]),
                        jtr.flux_integral_weights(p, jw.p[:, 0])):
            np.testing.assert_array_equal(a, b)
    xs = np.sort(np.random.default_rng(3).uniform(0, 10, 17))
    np.testing.assert_array_equal(ptr._trapz_weights(xs),
                                  jtr._trapz_weights(xs))


@pytest.mark.parametrize('name', ['single_line', 'earth'])
def test_attenuation_and_transmission_match_jax(worlds, name):
    """band_attenuation (both reference levels) and band_transmission_
    matrices from JAX's tau, f64: within 1e-12 relative; the transmission
    matrices are the same whatever the chunk of bands (bit-equal with one
    band a chunk); f32 within 1e-6 relative."""
    jw, pw = worlds[name]
    ba = jw.band_arrays
    bp = interop.band_arrays_from_numpy(_np(ba), 'cpu', torch.float64)
    tau = torch.tensor(np.asarray(jw.tau_device))
    for ref in (0, jw.nz - 1):
        a = ptr.band_attenuation(tau, bp.idx, bp.w, bp.delta, ref)
        b = np.asarray(jtr.band_attenuation(jw.tau_device, ba.idx, ba.w,
                                            ba.delta, ref))
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()
    Tr = ptr.band_transmission_matrices(tau, bp.lw_idx, bp.lw_w, bp.lw_delta)
    want = np.asarray(jtr.band_transmission_matrices(
        jw.tau_device, ba.lw_idx, ba.lw_w, ba.lw_delta))
    assert Tr.shape == want.shape
    assert np.abs(Tr.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    one = ptr.band_transmission_matrices(tau, bp.lw_idx, bp.lw_w,
                                         bp.lw_delta, chunk_bytes=1)
    assert torch.equal(one, Tr)
    b32 = interop.band_arrays_from_numpy(_np(ba), 'cpu', torch.float32)
    Tr32 = ptr.band_transmission_matrices(tau.float(), b32.lw_idx, b32.lw_w,
                                          b32.lw_delta)
    assert np.abs(Tr32.double().numpy() - want).max() <= 1e-6


@pytest.mark.parametrize('name', ['single_line', 'earth'])
@pytest.mark.parametrize('layout', ['full', 'bf16'])
def test_precompute_transmission_matches_jax(worlds, name, layout):
    """Every TransmissionCache field from JAX's tau and band arrays.  Full
    layout: f64 within 1e-12 relative of the field's scale (toa_down of the
    scale of its terms, see the module docstring).  bf16 layout: the
    full-precision fields as above, the bf16 operators within one bf16
    rounding (2^-8 relative) of JAX's — the two round the same f64 values
    that differ in their last bits."""
    jw, pw = worlds[name]
    cd_j, cd_p = (None, None) if layout == 'full' else (jnp.bfloat16,
                                                        torch.bfloat16)
    cj = _np(jrg.precompute_transmission(jw.tau_device, jw.band_arrays, cd_j))
    bp = interop.band_arrays_from_numpy(_np(jw.band_arrays), 'cpu',
                                        torch.float64)
    cp = prg.precompute_transmission(torch.tensor(np.asarray(jw.tau_device)),
                                     bp, cd_p)
    W0 = np.abs(np.asarray(jw._W_down)[:, 0]).max()
    toa_scale = W0 / np.diff(jw.p_interface[:, 0])[0]
    for f in dataclasses.fields(prg.TransmissionCache):
        a, b = getattr(cp, f.name), cj[f.name]
        assert (a is None) == (b is None), f.name
        if a is None:
            continue
        if a.dtype == torch.bfloat16:
            assert b.dtype.name == 'bfloat16', f.name
            a, b = a.double().numpy(), b.astype(np.float64)
            assert np.abs(a - b).max() <= 2.0 ** -8 * np.abs(b).max(), f.name
            continue
        a = a.numpy()
        scale = toa_scale if f.name == 'toa_down' else np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-12 * scale, f.name
    # the cache of a world is folded once and kept
    assert pw.transmission() is pw.transmission()


def test_dtransmission_dq_matches_jax():
    rng = np.random.default_rng(4)
    tau_band = rng.uniform(0, 3, (2, 12))
    w = rng.uniform(0, 1, 12)
    k = rng.uniform(0, 5, 12)
    want = float(jtr.dtransmission_dq(2e4, 5e4, tau_band, w, 1.7, k, 9.8))
    got_np = ptr.dtransmission_dq(2e4, 5e4, tau_band, w, 1.7, k, 9.8)
    got_t = ptr.dtransmission_dq(2e4, 5e4, torch.tensor(tau_band),
                                 torch.tensor(w), 1.7, torch.tensor(k), 9.8)
    assert got_np == want
    assert abs(float(got_t) - want) <= 1e-15 * abs(want)
    assert ph.table_dnu == 10.0
