"""Port vs JAX: the shallow-water schemes (``ops/stencils.py``), the
ghost-cell boundary conditions, and the plain versions of the fused
Richtmyer kernel (K5 ``richtmyer_step_interior``, K6 ``richtmyer_step_bc``)
against the Pallas kernels run in interpret mode, as
tests/test_pallas_stencils.py runs them.

Inputs are made with NumPy from a seed and given to both packages in
float64.  The port's plain versions take the kernel's operations in the
kernel's order, one IEEE rounding each; XLA on the CPU may contract a
product and a sum into one fused multiply-add, so the two agree to a few
ulp (``ULP``), not bit for bit.  Boundary conditions are copies and agree
bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.models import shallow_water as jsw
from climatemodel_tpu.ops import stencils as jst
from climatemodel_tpu.ops.pallas_stencils import (_fused_update,
                                                  frame_supports, pad_frame,
                                                  richtmyer_step_frame,
                                                  richtmyer_step_interior,
                                                  supports, unpad_frame)
from climatemodel_tpu_torch.models import shallow_water as psw
from climatemodel_tpu_torch.ops import stencils as pst


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's parallel loops over fields above its grain size (~33k cells,
    the 150 x 75 world) then spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a few ulp of f64 on fields of size ~1e3 (h) and ~1 (u, v): FMA
# contraction by XLA on the CPU moves a result by at most an ulp per
# contracted pair, and the step chains ~10 of them
ULP = dict(rtol=1e-13, atol=1e-13)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               **(tol or ULP))


def _fields(nx, ny, seed):
    """h ~ 1000 m with 2% relief, O(1) velocities, f ~ 1e-4 with noise,
    50 m random orography, damping ~ 1e-6."""
    rng = np.random.default_rng(seed)
    return dict(h=1000 + 20 * rng.standard_normal((nx, ny)),
                u=rng.standard_normal((nx, ny)),
                v=rng.standard_normal((nx, ny)),
                f=1e-4 + 1e-6 * rng.standard_normal((nx, ny)),
                h_base=50 * rng.standard_normal((nx, ny)),
                r=1e-6 * rng.random((nx, ny)))


# --------------------------------------------------------------------------
# the four schemes
# --------------------------------------------------------------------------

@pytest.mark.parametrize('linear', [False, True])
@pytest.mark.parametrize('solver', ['lax_friedrichs', 'richtmyer',
                                    'maccormack', 'lax_wendroff'])
def test_schemes_match_jax(solver, linear):
    """One step of each scheme on a ragged, non-square grid (dx != dy keeps
    maccormack's sigma_x corrector in play), nonlinear and linear, through
    the same flux, source and Jacobian closures."""
    nx, ny, dx, dy, dt, g, h_mean = 37, 29, 1e5, 0.8e5, 60.0, 9.81, 1000.0
    d = _fields(nx, ny, 7)

    def run(mod, st, arr, scal):
        U = mod.get_conservative_form(arr(d['h']), arr(d['u']), arr(d['v']),
                                      linear)
        G, H, DX, DY, DT = (scal(x) for x in (g, h_mean, dx, dy, dt))
        args = (U, mod.make_flux_x(G, H, linear), mod.make_flux_y(G, H, linear),
                mod.make_source(G, arr(d['f']), arr(d['h_base']), DX, DY,
                                linear), DT, DX, DY, [0])
        if solver == 'lax_wendroff':
            return st.lax_wendroff(*args, nx, ny, mod.make_jacobian_x(G),
                                   mod.make_jacobian_y(G))
        return st.SCHEMES[solver](*args)

    ref = run(jsw, jst, jnp.asarray, jnp.float64)
    port = run(psw, pst, _t, lambda x: torch.tensor(
        x, dtype=torch.float64))
    # lax_wendroff's 3x3 contraction may sum in another order: 1e-12
    tol = dict(rtol=1e-12, atol=1e-10) if solver == 'lax_wendroff' else ULP
    _close(port, ref, **tol)


def test_centered_differences_match_jax():
    d = _fields(12, 9, 3)
    for jf, pf in ((jst.centered_diff_x, pst.centered_diff_x),
                   (jst.centered_diff_y, pst.centered_diff_y)):
        np.testing.assert_array_equal(
            pf(_t(d['h']), torch.tensor(1e5, dtype=torch.float64)).numpy(),
            np.asarray(jf(jnp.asarray(d['h']), jnp.float64(1e5))))


# --------------------------------------------------------------------------
# boundary conditions: copies, bit-equal
# --------------------------------------------------------------------------

@pytest.mark.parametrize('bx,by', [('periodic', 'walls'), ('walls', 'walls'),
                                   ('walls', 'periodic'),
                                   ('periodic', 'periodic'),
                                   ('given', 'walls'), ('given', 'periodic')])
def test_boundary_conditions_bit_equal(bx, by):
    rng = np.random.default_rng(0)
    h, u, v = (rng.normal(size=(12, 10)) for _ in range(3))
    ref = jsw.apply_boundary_conditions(h, u, v, bx, by)
    port = pst.apply_boundary_conditions(_t(h), _t(u), _t(v), bx, by)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    # the functional form leaves its inputs alone
    np.testing.assert_array_equal(psw.apply_boundary_conditions(
        _t(h), _t(u), _t(v), bx, by)[0].numpy(), np.asarray(ref[0]))


# --------------------------------------------------------------------------
# K5: the fused interior step
# --------------------------------------------------------------------------

def _k5_inputs(nx, ny, seed, flat, dx=1e5, dy=1e5):
    d = _fields(nx, ny, seed)
    dhb = (None, None) if flat else (
        np.asarray(jst.centered_diff_x(jnp.asarray(d['h_base']), dx)),
        np.asarray(jst.centered_diff_y(jnp.asarray(d['h_base']), dy)))
    return d, dhb


def _k5_port(d, dhb, dt, ok, f, r, dx=1e5, dy=1e5, g=9.81):
    p = lambda a: None if a is None else _t(a)           # noqa: E731
    return pst.richtmyer_step_interior(
        p(d['h']), p(d['u']), p(d['v']), p(f), p(r), p(dhb[0]), p(dhb[1]),
        torch.tensor(dt, dtype=torch.float64), torch.tensor(ok),
        torch.tensor(g, dtype=torch.float64), torch.tensor(
            dx, dtype=torch.float64), torch.tensor(dy, dtype=torch.float64))


def _k5_both(d, dhb, dt, ok, f, r, dx=1e5, dy=1e5, g=9.81):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = richtmyer_step_interior(
        j(d['h']), j(d['u']), j(d['v']), j(f), j(r), j(dhb[0]), j(dhb[1]),
        jnp.float64(dt), jnp.asarray(ok), jnp.float64(g), jnp.float64(dx),
        jnp.float64(dy), interpret=True)
    return _k5_port(d, dhb, dt, ok, f, r, dx, dy, g), ref


@pytest.mark.parametrize('shape,flat', [((34, 30), True), ((34, 30), False),
                                        ((66, 130), False)])
def test_k5_plain_matches_pallas(shape, flat):
    """The plain K5 against the Pallas kernel in interpret mode: all four
    outputs within ULP, with ok True and with ok False (the freeze returns
    the pre-step interior exactly)."""
    nx, ny = shape
    d, dhb = _k5_inputs(nx, ny, 1, flat)
    f, r = d['f'][1:-1, 1:-1], d['r'][1:-1, 1:-1]
    port, ref = _k5_both(d, dhb, 60.0, True, f, r)
    for p, q in zip(port, ref):
        _close(p.numpy(), q)
    port, ref = _k5_both(d, dhb, 60.0, False, f, r)
    for p, q, pre in zip(port, ref, (d['h'], d['u'], d['v'])):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))
        np.testing.assert_array_equal(p.numpy(), pre[1:-1, 1:-1])
    _close(port[3], ref[3])


def test_k5_nan_freezes_and_propagates():
    """A NaN in u makes max2 NaN (jnp.max propagates it), which makes the
    next dt NaN and ok False: the step freezes and max2 stays NaN."""
    d, dhb = _k5_inputs(34, 30, 2, True)
    d['u'][5, 7] = np.nan
    f, r = d['f'][1:-1, 1:-1], d['r'][1:-1, 1:-1]
    port, ref = _k5_both(d, dhb, 60.0, True, f, r)
    assert np.isnan(float(port[3])) and np.isnan(float(ref[3]))
    port, ref = _k5_both(d, dhb, float('nan'), False, f, r)
    for p, q in zip(port[:3], ref[:3]):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))
    assert np.isnan(float(port[3])) and np.isnan(float(ref[3]))
    assert np.isnan(port[1].numpy()[4, 6])


# --------------------------------------------------------------------------
# K6: the fused step with every ghost cell
# --------------------------------------------------------------------------

def _k6_both(bx, by, flat, rows, seed=5, nx=34, ny=130, ok=True):
    d, dhb = _k5_inputs(nx, ny, seed, flat)
    h, u, v = (np.asarray(a) for a in jsw.apply_boundary_conditions(
        d['h'], d['u'], d['v'], 'walls' if bx == 'given' else bx, by))
    if rows:
        f, r = d['f'][1:2, 1:-1], d['r'][1:2, 1:-1]
    else:
        f, r = d['f'][1:-1, 1:-1], d['r'][1:-1, 1:-1]
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    out = richtmyer_step_frame(
        pad_frame(j(h)), pad_frame(j(u)), pad_frame(j(v)), j(f), j(r),
        j(dhb[0]), j(dhb[1]), jnp.float64(60.0), jnp.asarray(ok),
        jnp.float64(9.81), jnp.float64(1e5), jnp.float64(1e5), nx, ny,
        bx=bx, by=by, interpret=True)
    ref = [np.asarray(unpad_frame(a, nx, ny)) for a in out[:3]]
    p = lambda a: None if a is None else _t(a)  # noqa: E731
    scal = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    port = pst.richtmyer_step_bc(
        p(h), p(u), p(v), p(f), p(r), p(dhb[0]), p(dhb[1]), scal(60.0),
        torch.tensor(ok), scal(9.81), scal(1e5), scal(1e5), bx, by)
    return port, ref, float(out[3])


@pytest.mark.parametrize('bx', ['walls', 'periodic', 'given'])
@pytest.mark.parametrize('by', ['walls', 'periodic'])
def test_k6_plain_matches_pallas_frame(bx, by):
    """The plain K6 (interior step + apply_boundary_conditions) against
    ``unpad_frame(richtmyer_step_frame(pad_frame(...)))`` at 34 x 130 (the
    JAX frame needs a multiple-of-8 divisor of nx-2), mountain orography,
    full f and r.  Every cell within ULP for walls/periodic; for 'given' the
    interior and the y ghost lanes (the x ghost rows are the caller's)."""
    port, ref, max2 = _k6_both(bx, by, flat=False, rows=False)
    rows = slice(1, -1) if bx == 'given' else slice(None)
    for p, q in zip(port[:3], ref):
        _close(p.numpy()[rows], q[rows])
    _close(port[3], max2)


@pytest.mark.parametrize('bx,by', [('walls', 'walls'),
                                   ('periodic', 'periodic')])
def test_k6_row_geometry_matches_full_fields(bx, by):
    """f and r given as one broadcast row [1, ny-2] (the bench world's
    row-constant geometry): the plain K6 matches the Pallas frame kernel on
    the same rows, and equals itself on the rows broadcast to full fields."""
    port, ref, max2 = _k6_both(bx, by, flat=True, rows=True, seed=9)
    for p, q in zip(port[:3], ref):
        _close(p.numpy(), q)
    _close(port[3], max2)
    d, _ = _k5_inputs(34, 130, 9, True)
    h, u, v = (_t(a) for a in jsw.apply_boundary_conditions(
        d['h'], d['u'], d['v'], bx, by))
    scal = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    args = (scal(60.0), torch.tensor(True), scal(9.81), scal(1e5), scal(1e5),
            bx, by)
    f, r = _t(d['f'][1:2, 1:-1]), _t(d['r'][1:2, 1:-1])
    a = pst.richtmyer_step_bc(h, u, v, f, r, None, None, *args)
    b = pst.richtmyer_step_bc(h, u, v, f.expand(32, -1).contiguous(),
                              r.expand(32, -1).contiguous(), None, None, *args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# K5 and K6 at the shapes that break the CUDA kernel's strips: nx = 3 and
# ny = 3, rows not a multiple of its strip (12) or columns of its band (30),
# one strip of one band, bands over several blocks; and two shapes the
# Pallas tiling takes (nx - 2 = 8, 16)
# --------------------------------------------------------------------------

EDGE_SHAPES = [(3, 3), (3, 40), (40, 3), (12, 20), (51, 95), (20, 250),
               (10, 250), (18, 95)]
K6_MODES = [(bx, by) for bx in ('walls', 'periodic', 'given')
            for by in ('walls', 'periodic')]


def _fused_ref(h, u, v, f, r, dhb, dt, ok, g=9.81, dx=1e5, dy=1e5):
    """JAX's reference of K5 on a grid the Pallas tiling does not take: the
    Pallas kernels' body, ``_fused_update``, over the whole grid as one
    band, with sx = dt / dx as the JAX wrapper forms it."""
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    dt, g, dx, dy = (jnp.float64(x) for x in (dt, g, dx, dy))
    return _fused_update(j(h), j(u), j(v), dt, g, dt / dx, dt / dy, j(f),
                         j(dhb[0]), j(dhb[1]), j(r), jnp.asarray(ok))


@pytest.mark.parametrize('flat', [True, False])
@pytest.mark.parametrize('shape', EDGE_SHAPES)
def test_k5_plain_at_edge_shapes(shape, flat):
    """The plain K5 at the edge shapes, against the Pallas kernel in
    interpret mode where ``supports`` takes the shape and against its body
    over the whole grid elsewhere: all four outputs within ULP with ok True,
    the pre-step interior exactly with ok False."""
    nx, ny = shape
    d, dhb = _k5_inputs(nx, ny, nx * 1000 + ny, flat)
    rows = slice(1, 2) if flat else slice(1, -1)     # row f, r when flat
    f, r = d['f'][rows, 1:-1], d['r'][rows, 1:-1]
    for ok in (True, False):
        if supports(nx, ny):
            # the Pallas K5 takes full fields: the row, broadcast
            port = _k5_port(d, dhb, 60.0, ok, f, r)
            _, ref = _k5_both(d, dhb, 60.0, ok,
                              *(np.broadcast_to(x, (nx - 2, ny - 2)).copy()
                                for x in (f, r)))
        else:
            port = _k5_port(d, dhb, 60.0, ok, f, r)
            ref = _fused_ref(d['h'], d['u'], d['v'], f, r, dhb, 60.0, ok)
        for p, q in zip(port, ref):
            _close(p.numpy(), q)
        if not ok:
            for p, pre in zip(port, (d['h'], d['u'], d['v'])):
                np.testing.assert_array_equal(p.numpy(), pre[1:-1, 1:-1])


@pytest.mark.parametrize('bx,by', K6_MODES)
@pytest.mark.parametrize('shape', EDGE_SHAPES)
def test_k6_plain_at_edge_shapes(shape, bx, by):
    """The plain K6 at the edge shapes, every boundary mode, mountain
    orography and full f and r: against the Pallas frame kernel in
    interpret mode where ``frame_supports`` takes the shape, elsewhere
    against the Pallas body over the whole grid followed by JAX's
    ``apply_boundary_conditions`` (what the frame kernel computes).  Every
    cell within ULP ('given': the interior and the y ghost lanes)."""
    nx, ny = shape
    seed = nx * 1000 + ny + 7
    keep = slice(1, -1) if bx == 'given' else slice(None)
    if frame_supports(nx, ny):
        port, ref, max2 = _k6_both(bx, by, flat=False, rows=False,
                                   seed=seed, nx=nx, ny=ny)
    else:
        d, dhb = _k5_inputs(nx, ny, seed, False)
        h, u, v = (np.asarray(a) for a in jsw.apply_boundary_conditions(
            d['h'], d['u'], d['v'], 'walls' if bx == 'given' else bx, by))
        f, r = d['f'][1:-1, 1:-1], d['r'][1:-1, 1:-1]
        inner = _fused_ref(h, u, v, f, r, dhb, 60.0, True)
        full = [a.copy() for a in (h, u, v)]
        for a, x in zip(full, inner[:3]):
            a[1:-1, 1:-1] = np.asarray(x)
        ref = [np.asarray(a) for a in
               jsw.apply_boundary_conditions(*full, bx, by)]
        max2 = float(inner[3])
        p = lambda a: None if a is None else _t(a)  # noqa: E731
        scal = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
        port = pst.richtmyer_step_bc(
            p(h), p(u), p(v), p(f), p(r), p(dhb[0]), p(dhb[1]), scal(60.0),
            torch.tensor(True), scal(9.81), scal(1e5), scal(1e5), bx, by)
    for a, b in zip(port[:3], ref):
        _close(a.numpy()[keep], b[keep])
    _close(port[3], max2)


def test_k6_out_buffers_and_mode_checks():
    """``out=`` receives the result (the double-buffered run); unknown
    boundary modes raise."""
    d, _ = _k5_inputs(10, 12, 4, True)
    h, u, v = (_t(d[k]) for k in ('h', 'u', 'v'))
    f, r = _t(d['f'][1:-1, 1:-1]), _t(d['r'][1:-1, 1:-1])
    scal = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    args = (h, u, v, f, r, None, None, scal(60.0), torch.tensor(True),
            scal(9.81), scal(1e5), scal(1e5))
    bufs = tuple(torch.empty_like(h) for _ in range(3))
    res = pst.richtmyer_step_bc(*args, 'walls', 'periodic', out=bufs)
    assert all(x is b for x, b in zip(res, bufs))
    ref = pst.richtmyer_step_bc(*args, 'walls', 'periodic')
    for x, y in zip(res, ref):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match='boundary modes'):
        pst.richtmyer_step_bc(*args, 'open', 'walls')


def test_fused_step_never_falls_back():
    """Tensors on any device but the CPU go to the kernel's wrapper, which
    raises instead of computing elsewhere ('meta' stands in for a card)."""
    m = lambda *s: torch.empty(s, dtype=torch.float64, device='meta')  # noqa
    args = (m(8, 9), m(8, 9), m(8, 9), m(6, 7), m(6, 7), None, None, m(),
            torch.empty((), dtype=torch.bool, device='meta'), m(), m(), m())
    with pytest.raises(ValueError, match='CUDA tensor'):
        pst.richtmyer_step_interior(*args)
    with pytest.raises(ValueError, match='CUDA tensor'):
        pst.richtmyer_step_bc(*args, 'walls', 'walls')
