"""Port vs JAX: the log-depth affine scan (``ops/two_stream.affine_scan``),
the differentiable lw walk ``lw_flux_plain`` in both orientations, and the
TOA-first ``lw_flux(surface_first=False)``.

Bounds: the port's scan recurses in ``lax.associative_scan``'s order, so in
f64 it is held within 1e-12 relative of JAX (bit-equal where the
coefficients are given; the lw walks differ only by the libraries'
exponentials, ~1e-16).  In f32, within 8 ulp of the flux's scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.ops import two_stream as jts
from climatemodel_tpu_torch.ops import two_stream as pts

F64_REL = 1e-12
F32_ULPS = 8

# compiled once per shape: the JAX functions run op by op otherwise
j_affine_scan = jax.jit(jts.affine_scan, static_argnames='reverse')
j_walk = {fn: jax.jit(getattr(jts, fn), static_argnames='surface_first')
          for fn in ('lw_flux_plain', 'lw_flux')}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize('n,batch', [(1, (5,)), (2, ()), (3, (2, 3)),
                                     (7, (5,)), (8, ()), (33, (2, 3)),
                                     (64, (5,))])
@pytest.mark.parametrize('reverse', [False, True])
def test_affine_scan_matches_jax(n, batch, reverse):
    rng = np.random.default_rng(n * 10 + len(batch))
    a = rng.uniform(0.5, 1.5, (n,) + batch)
    b = rng.normal(size=(n,) + batch)
    x0 = rng.normal(size=batch)
    want = np.asarray(j_affine_scan(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(x0), reverse=reverse))
    got = pts.affine_scan(torch.tensor(a), torch.tensor(b), torch.tensor(x0),
                          reverse=reverse).numpy()
    assert got.shape == (n + 1,) + batch
    assert rel(got, want) <= F64_REL
    # the recurrence it solves, step by step
    x = x0
    seq = [x]
    for k in (range(n - 1, -1, -1) if reverse else range(n)):
        x = a[k] * x + b[k]
        seq.append(x)
    seq = np.stack(seq[::-1] if reverse else seq)
    np.testing.assert_allclose(got, seq, rtol=1e-12, atol=1e-12)


def walk_inputs(seed, n, batch):
    rng = np.random.default_rng(seed)
    T = rng.uniform(200.0, 300.0, (n,) + batch)
    dtau = rng.uniform(0.0, 0.3, (n,) + batch)
    toa = rng.uniform(200.0, 250.0, batch)
    return T, dtau, toa


SHAPES = [(1, (1,)), (20, (3,)), (59, (4,)), (37, (2, 3))]


@pytest.mark.parametrize('n,batch', SHAPES)
@pytest.mark.parametrize('fn,surface_first', [('lw_flux_plain', True),
                                              ('lw_flux_plain', False),
                                              ('lw_flux', False)])
def test_lw_walks_match_jax_f64(n, batch, surface_first, fn):
    T, dtau, toa = walk_inputs(n, n, batch)
    want = j_walk[fn](jnp.asarray(T), jnp.asarray(dtau), jnp.asarray(toa),
                      surface_first=surface_first)
    got = getattr(pts, fn)(torch.tensor(T), torch.tensor(dtau),
                           torch.tensor(toa), surface_first=surface_first)
    for g, w in zip(got, want):
        assert g.shape == (n + 1,) + batch
        assert rel(g.numpy(), w) <= F64_REL


@pytest.mark.parametrize('surface_first', [True, False])
def test_lw_flux_plain_f32_and_column_shared_dtau(surface_first):
    """f32 within a few ulp of the sum's scale; a [nz-1] dtau is shared by
    every column.  The scale of each flux is the recurrence run on the
    absolute values of its terms (in f64): the TOA-first up-stream grows as
    exp(+tau) and cancels, so its result is far smaller than its terms."""
    T, dtau, toa = walk_inputs(3, 40, (6,))
    dtau = dtau[:, 0]
    want = j_walk['lw_flux_plain'](jnp.asarray(T, jnp.float32),
                                   jnp.asarray(dtau, jnp.float32),
                                   jnp.asarray(toa, jnp.float32),
                                   surface_first=surface_first)
    want = [np.asarray(w) for w in want]
    assert want[0].dtype == np.float32
    got = pts.lw_flux_plain(torch.tensor(T, dtype=torch.float32),
                            torch.tensor(dtau, dtype=torch.float32),
                            torch.tensor(toa, dtype=torch.float32),
                            surface_first=surface_first)
    src = 5.670367e-8 * T ** 4
    scales = []
    for sign in (1.0, -1.0):
        e = np.exp(sign * dtau)[:, None]
        scales.append(pts.affine_scan(
            torch.tensor(np.broadcast_to(e, T.shape)),
            torch.tensor(np.abs(src * (1.0 - e))),
            torch.tensor(toa if sign > 0 else np.zeros_like(toa)),
            reverse=surface_first).numpy())
    eps = np.finfo(np.float32).eps
    for g, w, scale in zip(got, want, scales):
        assert g.dtype == torch.float32
        err = np.abs(g.numpy().astype(np.float64) - w)
        assert (err <= F32_ULPS * eps * scale).all()


def test_toa_first_is_the_flipped_surface_first_walk():
    """lw_flux(surface_first=False) on a TOA-first column is the sequential
    surface-first walk (the lw_walk kernel's plain twin) of the flipped
    column."""
    T, dtau, toa = walk_inputs(4, 30, (5,))
    Tt, dt, tt = (torch.tensor(x) for x in (T, dtau, toa))
    up, down = pts.lw_flux(Tt, dt, tt, surface_first=False)
    up_s, down_s = pts.lw_flux_sequential(torch.flip(Tt, (0,)),
                                          torch.flip(dt, (0,)), tt)
    assert rel(up.numpy(), torch.flip(up_s, (0,)).numpy()) <= 1e-13
    assert rel(down.numpy(), torch.flip(down_s, (0,)).numpy()) <= 1e-13


@pytest.mark.parametrize('surface_first', [True, False])
def test_jacobian_through_the_scan_matches_jax(surface_first):
    """torch.func.jacfwd batches the scan (out-of-place ops only) and gives
    JAX's Jacobian of the net flux with respect to the temperatures."""
    T, dtau, toa = walk_inputs(5, 24, (1,))

    def jnet(T_):
        up, down = jts.lw_flux_plain(T_[:, None], jnp.asarray(dtau),
                                     jnp.asarray(toa),
                                     surface_first=surface_first)
        return (up - down)[:, 0]

    def pnet(T_):
        up, down = pts.lw_flux_plain(T_[:, None], torch.tensor(dtau),
                                     torch.tensor(toa),
                                     surface_first=surface_first)
        return (up - down)[:, 0]
    want = np.asarray(jax.jit(jax.jacfwd(jnet))(jnp.asarray(T[:, 0])))
    got = torch.func.jacfwd(pnet)(torch.tensor(T[:, 0])).numpy()
    assert got.shape == (25, 24)
    assert rel(got, want) <= 1e-12
