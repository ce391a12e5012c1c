"""The group-blend kernel (K8, ``cuda_convection.group_blend``) on the card.

Every test here needs an NVIDIA card and skips without one.  Run them on the
card's machine (which has no JAX; ``--noconftest`` skips the JAX setup of
``tests/conftest.py``):

    python -m pytest --noconftest -m card tests/test_torch_group_blend_card.py -q -s

The kernel is held bit for bit to its plain twin, ``group_blend_plain``
(the lock-step loop with the kernel's order of the enthalpy sums), run on
CPU copies of the inputs.  Against the lock-step loop the card ran before
(``torch.sum``'s order on the card) it is held to what the order of three
sums allows: the blend divides by H_hi - H_lo, a difference of two sums of
~2.6e7 whose rounding the division amplifies, and in f32 the next sweep's
instability test (a tolerance of 16 eps theta) reads differences of a few
ulps, so the two orders part on some columns (in f32 on most, as the CPU
tests find between the JAX and the port's f32 blends).
"""
import functools
import time
import warnings

import numpy as np
import pytest
import torch

from climatemodel_tpu_torch.cli import grey_world_kwargs
from climatemodel_tpu_torch.models import ensemble as pens
from climatemodel_tpu_torch.models.grey import GreyGas
from climatemodel_tpu_torch.ops import convection as pc
from climatemodel_tpu_torch.ops import cuda_convection as ccv
from climatemodel_tpu_torch.utils import timing

pytestmark = pytest.mark.card

DTYPES = {'f32': torch.float32, 'f64': torch.float64}
#: the bound of the JAX suite's batched blend test (atol 1e-8 K, rtol 1e-7)
F64_ATOL, F64_RTOL = 1e-8, 1e-7
#: f64 columns that may part from the lock-step loop beyond that bound
#: (0.17-0.20% on the CPU between the two sum orders, seeds 1 and 2)
F64_PARTED_SHARE = 0.01
#: the f32 enthalpy of a column, -integral(T dp), after the blend, relative
#: to before: each accepted group conserves it up to beta's rounding, ~n u
#: of H a group (149 x 6e-8), tens of groups a column (CPU: <= 2.2e-4)
F32_ENTHALPY_REL = 1e-3
#: columns that one of the two adjusts and the other leaves as they were
ADJUSTED_DIFFER_SHARE = 0.01


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run on the card machine)')
    return torch.device('cuda', 0)


@functools.lru_cache(maxsize=None)
def _profiles(nz):
    """(p [n], the radiative-convective and the radiative equilibrium T [n])
    of the thermosphere world (radiation_script.py:32-36) at nz levels, f64
    on the CPU."""
    world = GreyGas(nz=nz, ny=1, device='cpu', dtype=torch.float64,
                    **grey_world_kwargs('thermosphere'))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')      # the tau_sw = 0 closed form
        rce = world.equilibrium_sol(convective_adjust=True)[2][:, 0]
        rad = world.equilibrium_sol()[2][:, 0]
    return world.p[:, 0], rce, rad


def thermosphere_columns(nz, C, dtype, seed, rough=True):
    """C seeded thermosphere columns (T [C, n], pi, w [n], thresh [C]) on
    the CPU: the RCE profile (a quarter the radiative one) warmed by 0-3%,
    plus noise of 0.02 K (a march step) or, where ``rough``, 0, 0.3 or 3 K
    on some; thresholds median / 4 (the default), 0.05 K on the fifth
    column and every fifth after it (groups skipped)."""
    p, rce, rad = _profiles(nz)
    rng = np.random.default_rng(seed)
    n = len(rce)
    base = np.where(rng.random((C, 1)) < 0.25, rad, rce) * (
        1 + 0.03 * rng.random((C, 1)))
    amps = (0.0, 0.02, 0.3, 3.0) if rough else (0.02,)
    amp = rng.choice(amps, size=(C, 1)) * rng.random((C, 1))
    T = torch.tensor(base + amp * rng.standard_normal((C, n)), dtype=dtype)
    pi, w = pc.grid_factors(torch.tensor(p, dtype=dtype))
    thresh = pc.median_last(T) / 4
    thresh[4::5] = 0.05
    return T, pi, w, thresh


def _on(dev, *xs):
    return [x.to(dev) for x in xs]


def _same_bits(a, b):
    """Bit-equal, NaN positions included."""
    return a.shape == b.shape and torch.equal(
        torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


CASES = [
    # (name, nz, columns, seed, max_groups, max_outer)
    ('4096x149', 150, 4096, 1, None, None),
    ('4096x149_max_outer_2', 150, 4096, 2, None, 2),
    ('64x149_max_groups_1', 150, 64, 3, 1, None),
    ('1x597', 'auto', 1, 4, None, None),
]


@pytest.mark.parametrize('scratch', [False, True])
@pytest.mark.parametrize('dtype', ['f32', 'f64'])
@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_group_blend_bit_equal_to_its_plain_twin(card, case, dtype, scratch,
                                                 monkeypatch):
    """The kernel gives ``group_blend_plain``'s result on CPU copies, bit
    for bit, from shared memory and (``scratch``: no shared memory allowed)
    from its rows in device memory; one column holds a NaN."""
    name, nz, C, seed, max_groups, max_outer = case
    if scratch:
        monkeypatch.setattr(ccv, '_BLEND_SMEM_BYTES', 0)
    T, pi, w, thresh = thermosphere_columns(nz, C, DTYPES[dtype], seed)
    if C > 1:
        T[C // 2, 7] = float('nan')
    mg, mo = pc._blend_limits(T.shape[1], max_groups, max_outer)
    t0 = time.perf_counter()
    got = ccv.group_blend(*_on(card, T, pi, w, thresh), mg, mo).cpu()
    card_s = time.perf_counter() - t0
    want = pc.group_blend_plain(T, pi, w, thresh, max_groups, max_outer)
    adjusted = int(((want - T).abs() > 0).any(dim=1).sum())
    print(f'{name} {dtype} scratch={scratch}: {adjusted} of {C} columns '
          f'adjusted, first call {card_s:.3f} s')
    assert adjusted > 0
    assert _same_bits(got, want)


def test_group_blend_edges(card):
    """One level (always stable) comes back as it was; no column gives an
    empty result; the wrapper refuses a CPU grid."""
    T = torch.tensor([[300.0], [250.0]], device=card)
    one = torch.ones(1, device=card)
    assert torch.equal(ccv.group_blend(T, one, one, torch.full(
        (2,), 1e9, device=card), 1, 4), T)
    empty = torch.empty((0, 5), device=card)
    assert ccv.group_blend(empty, torch.ones(5, device=card),
                           torch.ones(5, device=card),
                           torch.empty(0, device=card), 3, 20).shape == (0, 5)
    with pytest.raises(ValueError, match='CUDA tensor'):
        ccv.group_blend(T, torch.ones(1), one, one.expand(2).contiguous(),
                        1, 4)


@pytest.mark.parametrize('dtype', ['f32', 'f64'])
def test_reference_adjust_rows_is_one_launch_and_no_sync(card, dtype):
    """On the card ``reference_adjust_rows`` is one ``group_blend`` launch
    (``launch_counts`` and the ``blend.launches`` counter), no host sync
    (CUDA's sync debug mode raises on one) and no sweep of the plain loop
    (``blend.sweeps``)."""
    T, pi, w, thresh = _on(card, *thermosphere_columns(150, 512,
                                                       DTYPES[dtype], 5))
    pc.reference_adjust_rows(T, pi, w, thresh)          # builds the kernel
    torch.cuda.synchronize()
    before = (ccv.launch_counts['group_blend'], timing.counters())
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = pc.reference_adjust_rows(T, pi, w, thresh)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    after = timing.counters()
    assert ccv.launch_counts['group_blend'] == before[0] + 1
    assert after.get('blend.launches', 0) == \
        before[1].get('blend.launches', 0) + 1
    assert after.get('blend.sweeps', 0) == before[1].get('blend.sweeps', 0)
    assert _same_bits(out.cpu(), pc.group_blend_plain(
        *(x.cpu() for x in (T, pi, w, thresh))))


def _enthalpy_rel(out, T, w):
    H = lambda x: (w.double() * x.double()).sum(dim=1)  # noqa: E731
    return ((H(out) - H(T)) / H(T)).abs()


@pytest.mark.parametrize('dtype', ['f32', 'f64'])
def test_group_blend_against_the_lockstep_loop_on_the_card(card, dtype):
    """The kernel against the loop the card ran before (``torch.sum``'s
    order, on the card) at 4096 march-like thermosphere columns (0-0.02 K
    of noise, default thresholds, 0.05 K on every fifth).  f64: all but
    F64_PARTED_SHARE of the columns within the JAX suite's bound, and
    enthalpy conserved to 1e-12 by both; f32: enthalpy conserved by both to
    F32_ENTHALPY_REL; in both, at most ADJUSTED_DIFFER_SHARE of the columns
    adjusted by one and left alone by the other.  The columns that part are
    counted and printed."""
    T, pi, w, thresh = thermosphere_columns(150, 4096, DTYPES[dtype], 6,
                                            rough=False)
    Tc, pic, wc, thc = _on(card, T, pi, w, thresh)
    mg, mo = pc._blend_limits(T.shape[1], None, None)
    got = ccv.group_blend(Tc, pic, wc, thc, mg, mo).cpu()
    loop = pc._lockstep_blend(Tc, pic, wc, thc, mg, mo,
                              pc._torch_row_sums).cpu()
    diff = (got - loop).abs()
    parted = (diff > F64_ATOL + F64_RTOL * loop.abs()).any(dim=1)
    col = diff.amax(dim=1)
    adj_k = ((got - T).abs() > 0).any(dim=1)
    adj_l = ((loop - T).abs() > 0).any(dim=1)
    e_k, e_l = _enthalpy_rel(got, T, w), _enthalpy_rel(loop, T, w)
    print(f'{dtype}: {int(adj_k.sum())} columns adjusted by the kernel, '
          f'{int(adj_l.sum())} by the loop, {int((adj_k != adj_l).sum())} '
          f'by one only; {int((col > 0).sum())} differ, {int(parted.sum())} '
          f'beyond {F64_ATOL} K + {F64_RTOL} relative; |diff| quantiles '
          f'0.5/0.9/0.99 {[float(col.quantile(q)) for q in (.5, .9, .99)]}, '
          f'max {float(col.max()):.3g} K; enthalpy change kernel '
          f'{float(e_k.max()):.3g}, loop {float(e_l.max()):.3g}')
    assert bool(torch.isfinite(got).all())
    assert int((adj_k != adj_l).sum()) <= ADJUSTED_DIFFER_SHARE * len(T)
    if dtype == 'f64':
        assert int(parted.sum()) <= F64_PARTED_SHARE * len(T)
        assert float(e_k.max()) <= 1e-12 and float(e_l.max()) <= 1e-12
    else:
        assert float(e_k.max()) <= F32_ENTHALPY_REL
        assert float(e_l.max()) <= F32_ENTHALPY_REL


def test_march_launches_the_blend_once_an_iteration(card):
    """A convective ensemble march on the card: over its top-level
    ``march`` span ``blend.launches`` rises by ``march.iterations`` (one
    launch a loop iteration) and ``blend.sweeps`` not at all."""
    world = GreyGas(nz=60, ny=1, device=card, **grey_world_kwargs(
        'thermosphere'))
    states, forcings, p_int, p_c = pens.grey_ensemble(
        world, np.linspace(1200.0, 1500.0, 64))
    since = time.time_ns()
    pens.grey_evolve_ensemble(states, forcings, p_int, p_c, 0.1,
                              convective_adjust=True, max_steps=200)
    [march] = [s for s in timing.spans(since) if s.name == 'march'
               and s.parent is None]
    its = march.counters['march.iterations']
    assert its > 0
    assert march.counters.get('blend.launches', 0) == its
    assert 'blend.sweeps' not in march.counters
