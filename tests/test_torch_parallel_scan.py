"""Port vs JAX: the mesh helpers (``parallel/mesh.py``), the collectives
(``parallel/collectives.py``) and the level-sharded flux scan
(``parallel/level_scan.py``), on the 8 virtual CPU devices against the
port's ``[cpu] * 8`` mesh.  float64, inputs from ``np.random.default_rng``;
the scans at rtol 1e-12 (exp and the block reassociation are the only
differences)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.ops import two_stream as jts
from climatemodel_tpu.parallel import level_scan as jls
from climatemodel_tpu.parallel import mesh as jmesh
from climatemodel_tpu_torch.ops import two_stream as pts
from climatemodel_tpu_torch.parallel import collectives as col
from climatemodel_tpu_torch.parallel import level_scan as pls
from climatemodel_tpu_torch.parallel import mesh as pmesh

CPU = torch.device('cpu')


def meshes(names=('lev',), shape=None):
    return (jmesh.make_mesh(names, shape=shape, devices=jax.devices()[:8]),
            pmesh.make_mesh(names, shape=shape, devices=[CPU] * 8))


def test_factor_devices_matches_jax():
    for n in range(1, 17):
        assert pmesh.factor_devices(n) == jmesh.factor_devices(n), n


def test_make_mesh():
    m = pmesh.make_mesh(('data', 'x'), shape=(2, 4), devices=[CPU] * 8)
    assert m.shape == {'data': 2, 'x': 4} and m.size == 8
    assert pmesh.make_mesh(('x', 'y'), devices=[CPU] * 4).shape == \
        {'x': 4, 'y': 1}
    with pytest.raises(ValueError, match='does not use all'):
        pmesh.make_mesh(('x', 'y'), shape=(3, 2), devices=[CPU] * 4)


def test_default_mesh_is_every_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pmesh.make_mesh()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    assert pmesh.make_mesh().flat_devices == [torch.device('cuda', 0),
                                              torch.device('cuda', 1)]


def test_collectives_on_a_repeated_device():
    """ppermute returns copies (never the sender's storage on a repeated
    device) and zeros where nothing arrives; psum adds in index order
    within each line of the named axis; pmax is the elementwise max."""
    m = pmesh.make_mesh(('a', 'b'), shape=(2, 4), devices=[CPU] * 8)
    xs = [torch.tensor([float(k), -float(k)]) for k in range(8)]
    assert col.axis_index(m, 'b') == [0, 1, 2, 3] * 2
    assert col.axis_index(m, 'a') == [0] * 4 + [1] * 4
    got = col.ppermute(m, 'b', xs, [(0, 1), (1, 2)])
    assert [g.tolist() for g in got] == [[0, 0], [0, -0.0], [1, -1], [0, 0],
                                         [0, 0], [4, -4], [5, -5], [0, 0]]
    got[1].add_(100.0)
    assert xs[0].tolist() == [0.0, -0.0]
    out = [torch.full((2,), -1.0) for _ in range(8)]
    col.ppermute(m, 'a', xs, [(0, 1)], out=out)
    assert [o.tolist() for o in out[4:]] == [x.tolist() for x in xs[:4]]
    assert out[0].tolist() == [-1.0, -1.0]
    assert [s.tolist() for s in col.psum(m, 'a', xs)][:2] == [[4, -4],
                                                              [6, -6]]
    assert [s.tolist() for s in col.pmax(m, 'b', xs)] == \
        [[3, 0]] * 4 + [[7, -4]] * 4
    # the order: ((1e16 + 1) + 1) - 1e16 is 0 in f64, never 2
    ys = [torch.tensor(v, dtype=torch.float64) for v in (1e16, 1.0, 1.0,
                                                         -1e16)]
    m4 = pmesh.make_mesh(('x',), devices=[CPU] * 4)
    assert float(col.psum(m4, 'x', ys)[3]) == 0.0


@pytest.mark.parametrize('reverse', [False, True])
def test_sharded_affine_scan_matches_jax(reverse):
    rng = np.random.default_rng(0)
    n, trail = 64, 3
    a = rng.uniform(0.5, 1.5, (n, trail))
    b = rng.normal(size=(n, trail))
    x0 = rng.normal(size=(trail,))
    jm, pm = meshes()
    want = jls.sharded_affine_scan(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(x0), jm, 'lev', reverse=reverse)
    got = pls.sharded_affine_scan(torch.tensor(a), torch.tensor(b),
                                  torch.tensor(x0), pm, 'lev', reverse=reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    # and the port's own one-device scan
    np.testing.assert_allclose(got.numpy(), pts.affine_scan(
        torch.tensor(a), torch.tensor(b), torch.tensor(x0),
        reverse=reverse).numpy(), rtol=1e-12, atol=1e-12)


def test_sharded_affine_scan_one_axis_batchless():
    """[n] coefficients (no batch axis) and a scalar x0."""
    rng = np.random.default_rng(4)
    a, b = rng.uniform(0.5, 1.5, 32), rng.normal(size=32)
    jm, pm = meshes()
    want = jls.sharded_affine_scan(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(0.3), jm, 'lev')
    got = pls.sharded_affine_scan(torch.tensor(a), torch.tensor(b),
                                  torch.tensor(0.3, dtype=torch.float64),
                                  pm, 'lev')
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def flux_inputs(seed, n_lev, n_col, shared_dtau=False):
    rng = np.random.default_rng(seed)
    T = 200.0 + 100.0 * rng.random((n_lev, n_col))
    dtau = 0.2 * rng.random((n_lev,) if shared_dtau else (n_lev, n_col))
    toa = rng.uniform(200.0, 300.0, (n_col,))
    return T, dtau, toa


@pytest.mark.parametrize('surface_first', [True, False])
@pytest.mark.parametrize('shared_dtau', [False, True])
def test_lw_flux_level_sharded_matches_jax(shared_dtau, surface_first):
    T, dtau, toa = flux_inputs(1, 48, 2, shared_dtau)
    jm, pm = meshes()
    want = jls.lw_flux_level_sharded(jnp.asarray(T), jnp.asarray(dtau),
                                     jnp.asarray(toa), jm, 'lev',
                                     surface_first=surface_first)
    got = pls.lw_flux_level_sharded(torch.tensor(T), torch.tensor(dtau),
                                    torch.tensor(toa), pm, 'lev',
                                    surface_first=surface_first)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    if surface_first:
        # the unsharded JAX walk, at test_sharded.py's bound
        for g, w in zip(got, jts.lw_flux(jnp.asarray(T), jnp.asarray(dtau),
                                         jnp.asarray(toa))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-11,
                                       atol=1e-9)


def test_lw_flux_composed_dp_x_pp_matches_jax():
    """Members on 'data', levels on 'lev': each data shard of members runs
    its own carry pipeline."""
    T, dtau, toa = flux_inputs(3, 48, 6)
    jm, pm = meshes(('data', 'lev'), (2, 4))
    want = jls.lw_flux_level_sharded(jnp.asarray(T), jnp.asarray(dtau),
                                     jnp.asarray(toa), jm, 'lev',
                                     batch_axis_name='data')
    got = pls.lw_flux_level_sharded(torch.tensor(T), torch.tensor(dtau),
                                    torch.tensor(toa), pm, 'lev',
                                    batch_axis_name='data')
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    with pytest.raises(ValueError, match='not divisible'):
        pls.lw_flux_level_sharded(torch.tensor(T[:, :5]),
                                  torch.tensor(dtau[:, :5]),
                                  torch.tensor(toa[:5]), pm, 'lev',
                                  batch_axis_name='data')


def test_level_scan_rejects_bad_shapes():
    _jm, pm = meshes()
    a = torch.ones((10, 1))
    with pytest.raises(ValueError, match='not divisible'):
        pls.sharded_affine_scan(a, a, torch.ones((1,)), pm, 'lev')
    pm2 = pmesh.make_mesh(('data', 'lev'), shape=(2, 4), devices=[CPU] * 8)
    with pytest.raises(ValueError, match='batch axis'):
        pls.sharded_affine_scan(torch.ones(8), torch.ones(8),
                                torch.ones(()), pm2, 'lev',
                                batch_axis_name='data')


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_level_sharded_close_to_plain_scan_and_walk(dtype):
    """The port against itself on chip_smoke's level_scan world (bench_grey's
    column at nz=61) cut to 256 members: the 4-shard scan against the
    unsharded scan (lw_flux_plain) and the sequential walk (lw_flux, K1's
    plain twin here), within the bound chip_smoke states (the largest
    |difference| over the largest |flux|)."""
    import chip_smoke
    from climatemodel_tpu_torch.constants import p_surface_earth
    from climatemodel_tpu_torch.models.grey import GreyGas
    T, dtau, toa = chip_smoke.level_scan_inputs(GreyGas, p_surface_earth,
                                                256, dtype, CPU)
    assert T.shape == (60, 256) and T.dtype == dtype
    pm = pmesh.make_mesh(('lev',), devices=[CPU] * chip_smoke.SHARDS)
    got = pls.lw_flux_level_sharded(T, dtau, toa, pm, 'lev')
    bound = chip_smoke.LEVEL_SCAN_REL_BOUND[str(dtype)]
    for ref in (pts.lw_flux_plain(T, dtau, toa), pts.lw_flux(T, dtau, toa)):
        for g, r in zip(got, ref):
            err = float((g.double() - r.double()).abs().max()
                        / r.double().abs().max())
            assert err <= bound, err
