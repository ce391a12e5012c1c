"""Port vs JAX: the grey two-stream operators of
``climatemodel_tpu_torch/ops/two_stream.py`` against
``climatemodel_tpu/ops/two_stream.py`` and the Pallas kernels run in
interpret mode.  Same numpy-seeded inputs into both; the CUDA kernels
themselves are compared with these plain versions on the card by
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from climatemodel_tpu.ops import two_stream as jts
from climatemodel_tpu.ops.pallas_two_stream import (grey_net_stats_lanes,
                                                    lw_flux_lanes)
from climatemodel_tpu_torch.ops import two_stream as pts

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Bounds relative to the largest flux: XLA's CPU exp is not libm's (nor
# PyTorch's vectorised one), and the walk multiplies each exp's rounding by
# up to e^tau of the column.
REL_BOUND = {np.float64: 1e-12, np.float32: 1e-5}
T_DTYPE = {np.float64: torch.float64, np.float32: torch.float32}


def _walk_inputs(rng, n, b, dtype):
    T = (200 + 100 * rng.random((n, b))).astype(dtype)
    dtau = (0.2 * rng.random((n, b))).astype(dtype)
    toa = (200 + 50 * rng.random((b,))).astype(dtype)
    return T, dtau, toa


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('n,b', [(59, 7), (24, 130), (60, 1030)])
def test_lw_walk_matches_jax_sequential_and_pallas(n, b, dtype):
    """The port's plain walk (the K1/K2 twin) against JAX's
    ``lw_flux_sequential`` and, in f32, the Pallas kernel in interpret
    mode."""
    rng = np.random.default_rng(n * 1000 + b)
    T, dtau, toa = _walk_inputs(rng, n, b, dtype)
    td = T_DTYPE[dtype]
    up_p, dn_p = pts.lw_flux_sequential(torch.from_numpy(T),
                                        torch.from_numpy(dtau),
                                        torch.from_numpy(toa))
    assert up_p.dtype == td and up_p.shape == (n + 1, b)
    refs = [jts.lw_flux_sequential(jnp.asarray(T), jnp.asarray(dtau),
                                   jnp.asarray(toa))]
    if dtype == np.float32:              # the Pallas kernels are f32 only
        refs.append(lw_flux_lanes(jnp.asarray(T), jnp.asarray(dtau),
                                  jnp.asarray(toa), interpret=True))
    for up_j, dn_j in refs:
        assert _rel_err(up_p, up_j) <= REL_BOUND[dtype]
        assert _rel_err(dn_p, dn_j) <= REL_BOUND[dtype]
    # the dispatcher takes the plain walk for CPU tensors
    up_d, dn_d = pts.lw_flux(torch.from_numpy(T), torch.from_numpy(dtau),
                             torch.from_numpy(toa))
    assert torch.equal(up_d, up_p) and torch.equal(dn_d, dn_p)


# the grey single world's nz=100 (99 cells, tests/test_grey_rce.py:27) and
# the thermosphere world's 'auto' grid (598 interfaces, radiation_script.py
# :32-36 through cli.grey_world_kwargs('thermosphere')): K1's batch of one
@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('n', [99, 597])
def test_lw_flux_single_column_matches_jax(n, dtype):
    """``lw_flux`` of one column ([n] cells, batch shape [1]), the shape at
    which the single world launches K1: against JAX's ``lw_flux`` and, in
    f32, the Pallas kernel (K1) in interpret mode."""
    rng = np.random.default_rng(n)
    T, dtau, toa = _walk_inputs(rng, n, 1, dtype)
    up_p, dn_p = pts.lw_flux(torch.from_numpy(T), torch.from_numpy(dtau[:, 0]),
                             torch.from_numpy(toa))
    assert up_p.shape == (n + 1, 1) and up_p.dtype == T_DTYPE[dtype]
    refs = [jts.lw_flux(jnp.asarray(T), jnp.asarray(dtau[:, 0]),
                        jnp.asarray(toa))]
    if dtype == np.float32:
        refs.append(lw_flux_lanes(jnp.asarray(T), jnp.asarray(dtau),
                                  jnp.asarray(toa), interpret=True))
    for up_j, dn_j in refs:
        assert _rel_err(up_p, up_j) <= REL_BOUND[dtype]
        assert _rel_err(dn_p, dn_j) <= REL_BOUND[dtype]
    # the column-shared dtau broadcasts like a per-member one
    up_b, dn_b = pts.lw_flux_sequential(torch.from_numpy(T),
                                        torch.from_numpy(dtau),
                                        torch.from_numpy(toa))
    assert torch.equal(up_b, up_p) and torch.equal(dn_b, dn_p)


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('surface_first', [True, False])
def test_lw_flux_sequential_orientations_match_jax(surface_first, dtype):
    """``lw_flux_sequential(..., surface_first=)`` against JAX's in both
    orientations; the TOA-first walk is the surface-first one on the
    flipped column, and the default stays surface-first."""
    rng = np.random.default_rng(41 + surface_first)
    T, dtau, toa = _walk_inputs(rng, 37, 6, dtype)
    up_p, dn_p = pts.lw_flux_sequential(
        torch.from_numpy(T), torch.from_numpy(dtau), torch.from_numpy(toa),
        surface_first=surface_first)
    assert up_p.shape == (38, 6) and up_p.dtype == T_DTYPE[dtype]
    up_j, dn_j = jts.lw_flux_sequential(jnp.asarray(T), jnp.asarray(dtau),
                                        jnp.asarray(toa),
                                        surface_first=surface_first)
    assert _rel_err(up_p, up_j) <= REL_BOUND[dtype]
    assert _rel_err(dn_p, dn_j) <= REL_BOUND[dtype]
    # the boundary values sit at the TOA end of the given orientation
    toa_row = -1 if surface_first else 0
    assert torch.equal(up_p[toa_row], torch.from_numpy(toa))
    assert not dn_p[toa_row].any()
    flipped = pts.lw_flux_sequential(
        torch.from_numpy(T[::-1].copy()), torch.from_numpy(dtau[::-1].copy()),
        torch.from_numpy(toa), surface_first=not surface_first)
    assert torch.equal(flipped[0].flip(0), up_p)
    assert torch.equal(flipped[1].flip(0), dn_p)
    if surface_first:
        default = pts.lw_flux_sequential(torch.from_numpy(T),
                                         torch.from_numpy(dtau),
                                         torch.from_numpy(toa))
        assert torch.equal(default[0], up_p) and torch.equal(default[1], dn_p)


def _stats_inputs(rng, n, b, dtype=np.float32):
    T, dtau, toa = _walk_inputs(rng, n, b, dtype)
    usw = (100 * rng.random((n + 1, b))).astype(dtype)
    dsw = (300 * rng.random((n + 1, b))).astype(dtype)
    prev = (300 * rng.random((n + 1, b)) - 150).astype(dtype)
    return T, dtau, usw, dsw, toa, prev


@pytest.mark.parametrize('n,b,pct', [(59, 130, 95), (149, 16, 95), (5, 9, 50)])
def test_net_stats_matches_pallas_interpret(n, b, pct):
    """The port's plain net-stats (the K3 twin) against
    ``grey_net_stats_lanes`` in interpret mode, f32.  net to the walk's
    bound; the order statistics are selections of |net - prev|, so they
    agree to the same bound relative to the largest |net - prev|."""
    rng = np.random.default_rng(7 * n + b)
    args = _stats_inputs(rng, n, b)
    L = pts.topk_depth(n + 1, pct)
    m, _ = jts.percentile_topk_params(n + 1, pct)
    assert L == max(m, 2)
    out_j = grey_net_stats_lanes(*(jnp.asarray(a) for a in args), L,
                                 interpret=True)
    out_p = pts.net_stats_sequential(*(torch.from_numpy(a) for a in args), L)
    net_j, net_p = np.asarray(out_j[0]), out_p[0].numpy()
    assert _rel_err(net_p, net_j) <= 1e-5
    scale = np.abs(net_j - args[5]).max()
    for sj, sp in zip(out_j[1:], out_p[1:]):
        assert np.abs(sp.numpy() - np.asarray(sj)).max() <= 1e-5 * scale


def test_net_stats_nan_sentinel():
    """A NaN anywhere in a member's |net - prev| makes that member's top_1
    NaN and no other's; max|net| stays finite (as
    test_two_stream.py::test_pallas_net_stats_kernel_nan_sentinel).  The
    Pallas kernel's sorted insertion then holds NaN in every slot, and so
    does the port's twin: top_{L-1} and top_L are NaN for that member in
    both."""
    rng = np.random.default_rng(34)
    n, b = 12, 16
    T, dtau, toa = _walk_inputs(rng, n, b, np.float32)
    zeros = np.zeros((n + 1, b), np.float32)
    prev = zeros.copy()
    prev[4, 3] = np.nan
    args = (T, dtau, zeros, zeros, toa, prev)
    _, top1_j, hi_j, lo_j, amax_j = grey_net_stats_lanes(
        *(jnp.asarray(a) for a in args), 3, interpret=True)
    _, top1_p, hi_p, lo_p, amax_p = pts.net_stats_sequential(
        *(torch.from_numpy(a) for a in args), 3)
    np.testing.assert_array_equal(torch.isnan(top1_p).numpy(),
                                  np.isnan(np.asarray(top1_j)))
    assert bool(torch.isnan(top1_p[3])) and int(torch.isnan(top1_p).sum()) == 1
    assert not bool(torch.isnan(amax_p).any())
    for p_, j_ in ((hi_p, hi_j), (lo_p, lo_j)):
        np.testing.assert_array_equal(torch.isnan(p_).numpy(),
                                      np.isnan(np.asarray(j_)))
        assert bool(torch.isnan(p_[3])) and int(torch.isnan(p_).sum()) == 1


def _insertion_top(x, L):
    """The Pallas kernel's sorted insertion (pallas_two_stream.py:92-95)
    over one member's values, with NaN-propagating max and min: (top_1,
    top_{L-1}, top_L)."""
    regs = [-np.inf] * L
    for v in x:
        for r in range(L):
            hi = regs[r] if (np.isnan(regs[r]) or regs[r] > v) else v
            v = regs[r] if (np.isnan(regs[r]) or regs[r] < v) else v
            regs[r] = hi
    return regs[0], regs[L - 2], regs[L - 1]


@pytest.mark.parametrize('case', ['finite', 'ties', 'nan_prev', 'nan_temp'])
@pytest.mark.parametrize('L', [2, 4, 9, 32])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_net_stats_rows_route_bit_equal_to_sequential(dtype, L, case):
    """The [b, r] route of K3 (``net_stats_rows_plain``, what the CUDA
    kernel is held to on the card) equals ``net_stats_sequential`` on
    [n, b] copies bit for bit, and its order statistics are the Pallas
    kernel's sorted insertion, bit for bit: tied values keep their
    multiplicity, and a NaN in prev_net or in T (which carries down the
    walk into net) makes all three statistics NaN for that member only."""
    rng = np.random.default_rng(100 * L + len(case))
    n, b = 40, 6
    T, dtau, usw, dsw, toa, prev = _stats_inputs(rng, n, b, dtype)
    if case == 'ties':
        usw[:] = 0
        dsw[:] = 0
        prev[2] = np.round(prev[2] / 100) * 100
    rows = [np.ascontiguousarray(a.T) for a in (T, dtau, usw, dsw)]
    rows.insert(4, toa)
    rows.append(np.ascontiguousarray(prev.T))
    if case == 'nan_prev':
        rows[5][1, 7] = np.nan
    if case == 'nan_temp':
        rows[0][4, 20] = np.nan
    out_r = pts.net_stats_rows_plain(*(torch.from_numpy(a) for a in rows), L)
    cols = [np.ascontiguousarray(a.T) if a.ndim == 2 else a for a in rows]
    out_c = pts.net_stats_sequential(*(torch.from_numpy(a) for a in cols), L)
    assert out_r[0].shape == (b, n + 1)
    np.testing.assert_array_equal(out_r[0].numpy(), out_c[0].numpy().T)
    for a_r, a_c in zip(out_r[1:], out_c[1:]):
        np.testing.assert_array_equal(a_r.numpy(), a_c.numpy())
    d = np.abs(out_r[0].numpy() - rows[5])
    want = np.array([_insertion_top(d[m], L) for m in range(b)]).T
    got = np.stack([x.numpy() for x in out_r[1:4]])
    np.testing.assert_array_equal(got, want.astype(dtype))
    nan_member = {'nan_prev': 1, 'nan_temp': 4}.get(case)
    assert np.isnan(got).any(axis=0).tolist() == [m == nan_member
                                                  for m in range(b)]
    assert bool(torch.isnan(out_r[4][4])) == (case == 'nan_temp')


@pytest.mark.parametrize('ny', [1, 3])
def test_grey_net_with_stats_matches_jax_split_path(ny):
    """The member-batched dispatcher against JAX's vmapped
    ``grey_net_with_stats`` in f64 (ny == 1 takes the fused twin, ny > 1 the
    lw walk + top-k, as in JAX); bound 1e-12 relative, as the walk."""
    import jax
    rng = np.random.default_rng(35 + ny)
    B, n = 6, 30
    T = 220 + 60 * rng.random((B, n, ny))
    dtau = 0.15 * rng.random((B, n, ny))
    toa = 200 + 40 * rng.random((B, ny))
    usw = 50 * rng.random((B, n + 1, ny))
    dsw = 340 * rng.random((B, n + 1, ny))
    prev = 200 * rng.random((B, n + 1, ny)) - 100
    args = (T, dtau, toa, usw, dsw, prev)
    out_j = jax.vmap(lambda *a: jts.grey_net_with_stats(*a, pct=95))(
        *(jnp.asarray(a) for a in args))
    out_p = pts.grey_net_with_stats(*(torch.from_numpy(a) for a in args),
                                    pct=95)
    assert out_p[0].shape == (B, n + 1, ny)
    for a_j, a_p in zip(out_j, out_p):
        a_j = np.asarray(a_j)
        assert np.abs(a_p.numpy() - a_j).max() <= 1e-12 * np.abs(a_j).max()


def test_sw_flux_and_percentile_params_equal():
    """sw_flux is the same Beer law (torch's and XLA's exp may differ by an
    ulp: bound 4 ulp of f64); percentile_topk_params is identical."""
    tau = np.linspace(0.5, 0.0, 11)[:, None] * np.ones((1, 2))
    albedo_mod = np.array([0.3, 0.2])
    sol = np.array([1.0, 1.1])
    for iso in (False, True):
        up_j, dn_j = jts.sw_flux(jnp.asarray(tau), jnp.asarray(albedo_mod),
                                 jnp.asarray(sol), 1367.0, isothermal=iso)
        up_p, dn_p = pts.sw_flux(torch.from_numpy(tau),
                                 torch.from_numpy(albedo_mod),
                                 torch.from_numpy(sol), 1367.0, isothermal=iso)
        np.testing.assert_allclose(up_p.numpy(), np.asarray(up_j),
                                   rtol=4 * np.finfo(np.float64).eps)
        np.testing.assert_allclose(dn_p.numpy(), np.asarray(dn_j),
                                   rtol=4 * np.finfo(np.float64).eps)
    for n in (2, 6, 21, 60, 150, 600):
        for pct in (50, 90, 95, 99):
            assert pts.percentile_topk_params(n, pct) == \
                jts.percentile_topk_params(n, pct)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never compute on the CPU: a CPU tensor raises
    before anything is built or launched."""
    from climatemodel_tpu_torch.ops import cuda_two_stream as cts
    T = torch.ones((4, 3))
    with pytest.raises(ValueError, match='CUDA tensor'):
        cts.lw_walk(T, T, torch.ones(3))
    with pytest.raises(ValueError, match='CUDA tensor'):
        cts.net_stats_walk(T, T, torch.ones(4, 4), torch.ones(4, 4),
                           torch.ones(4), torch.ones(4, 4), 2)
    assert cts.launch_counts == {'lw_walk': 0, 'net_stats_walk': 0}


def test_top_k_orders_like_lax_on_cpu():
    """torch.topk / torch.argmax against lax.top_k / jnp.argmax on NaN
    ordering, first-index ties and signed zeros (CPU)."""
    x = np.array([[1.0, 3.0, np.nan, 3.0, -0.0, 0.0],
                  [2.0, 2.0, 1.0, 0.5, 2.0, -1.0]])
    vj = np.asarray(lax.top_k(jnp.asarray(x), 4)[0])
    vp = torch.topk(torch.from_numpy(x), 4, dim=1).values.numpy()
    np.testing.assert_array_equal(vp, vj)
    y = np.where(np.isnan(x), 0.0, x)
    np.testing.assert_array_equal(
        torch.argmax(torch.from_numpy(y), dim=1).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(y), axis=1)))
