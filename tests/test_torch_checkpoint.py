"""Port vs JAX: the npz checkpoint (``utils/checkpoint.py``) and the timing
helpers (``utils/timing.py``).

A checkpoint file has the JAX package's layout (``n_leaves``, ``leaf_i`` in
JAX's flatten order), so states cross between the packages bit for bit:
every comparison here is exact.  A march resumed from a checkpoint ends
bit-equal to the march that was never interrupted.
"""
import dataclasses
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from climatemodel_tpu.constants import p_surface_earth
from climatemodel_tpu.models.grey import GreyGas as JGrey
from climatemodel_tpu.models.shallow_water import ShallowWater as JSW
from climatemodel_tpu.utils import checkpoint as jck
from climatemodel_tpu.utils import timing as jtm
from climatemodel_tpu_torch.models import column as pcol
from climatemodel_tpu_torch.models.grey import GreyGas as PGrey
from climatemodel_tpu_torch.models.shallow_water import ShallowWater as PSW
from climatemodel_tpu_torch.utils import checkpoint as pck
from climatemodel_tpu_torch.utils import timing as ptm

GREY = dict(nz=25, ny=2, tau_lw_func='scale_height',
            tau_lw_func_args=[0.22 * p_surface_earth, 3.0])
SW = dict(nx=20, ny=14, dx=1e5, dy=1e5, dt=60.0, f_0=1e-4, beta=0.0,
          initial_info={'type': 'height_gaussian', 'min_h_surface': 9750.0,
                        'max_h_surface': 9850.0, 'x0': 0.0, 'y0': 0.0,
                        'x_std': 3e5, 'y_std': 3e5, 'add_noise': False})
DTYPES = {'f64': torch.float64, 'f32': torch.float32}


def leaves(tree):
    return pck.tree_flatten(tree)[0]


def assert_same_tree(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


def stepped_grey(dtype, n=2):
    w = PGrey(dtype=dtype, device='cpu', **GREY)
    t = 0.0
    for _ in range(n):
        t, _ = w.take_time_step(t)
    return w


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
def test_npz_round_trip(tmp_path, dtype):
    w = stepped_grey(DTYPES[dtype])
    tree = {'state': w.state, 'pair': (w.state.T, [w.state.t]),
            'none': None}
    pck.save_pytree(tmp_path / 'grey', tree)
    assert os.path.isfile(tmp_path / 'grey.npz')
    template = {'state': PGrey(dtype=DTYPES[dtype], device='cpu',
                               **GREY).state,
                'pair': (torch.zeros_like(w.state.T),
                         [torch.zeros_like(w.state.t)]), 'none': None}
    back = pck.load_pytree(tmp_path / 'grey', template)
    assert back['none'] is None
    assert isinstance(back['pair'], tuple) and isinstance(back['pair'][1], list)
    assert_same_tree(back, tree)


def test_file_layout_is_the_jax_flatten_order(tmp_path):
    """Dataclass fields in declaration order, depth first: ColumnState is
    T, net_flux, t, then the ten TimeStepInfo fields."""
    w = stepped_grey(torch.float64)
    pck.save_pytree(tmp_path / 'grey.npz', w.state)
    with np.load(tmp_path / 'grey.npz') as data:
        assert int(data['n_leaves']) == 13
        np.testing.assert_array_equal(data['leaf_0'], w.state.T.numpy())
        np.testing.assert_array_equal(data['leaf_2'], w.state.t.numpy())
        np.testing.assert_array_equal(data['leaf_12'],
                                      w.state.tsi.convective.numpy())
    names = [f.name for f in dataclasses.fields(pcol.TimeStepInfo)]
    assert names[0] == 'delta_t' and names[-1] == 'convective'


def test_template_mismatch_raises(tmp_path):
    w = stepped_grey(torch.float64)
    pck.save_pytree(tmp_path / 'grey', w.state)
    with pytest.raises(ValueError, match='leaves'):
        pck.load_pytree(tmp_path / 'grey', (w.state, w.state.t))
    other = PGrey(dtype=torch.float64, device='cpu',
                  **dict(GREY, nz=30)).state
    with pytest.raises(ValueError, match='does not fit'):
        pck.load_pytree(tmp_path / 'grey', other)


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
def test_jax_single_world_column_state_into_the_port(tmp_path, dtype):
    """A JAX GreyGas.state (unbatched) loads into the port's batched
    template: each leaf gains the batch axis of one, bit for bit."""
    jdt = {'f64': np.float64, 'f32': np.float32}[dtype]
    jw = JGrey(dtype=jdt, **GREY)
    jw.take_time_step(0.0)
    jw.take_time_step(float(jw.state.t))
    jck.save_pytree(tmp_path / 'j', jw.state)
    template = PGrey(dtype=DTYPES[dtype], device='cpu', **GREY).state
    st = pck.load_pytree(tmp_path / 'j', template)
    for got, want, tmpl in zip(leaves(st),
                               jax.tree_util.tree_leaves(jw.state),
                               leaves(template)):
        want = np.asarray(want)
        assert got.shape == (1,) + want.shape == tmpl.shape
        assert got.dtype == tmpl.dtype
        np.testing.assert_array_equal(got[0].numpy(), want)
    # and the port's file back into a port template of the same shapes
    pck.save_pytree(tmp_path / 'p', st)
    assert_same_tree(pck.load_pytree(tmp_path / 'p', template), st)


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
def test_sw_state_crosses_both_ways(tmp_path, dtype):
    jdt = {'f64': np.float64, 'f32': np.float32}[dtype]
    jw = JSW(dtype=jdt, **SW)
    jw.run(nt=10, snapshots=False)
    pw = PSW(dtype=DTYPES[dtype], device='cpu', **SW)
    pw.run(nt=7, snapshots=False)
    # JAX -> port
    jck.save_pytree(tmp_path / 'j', jw.state)
    st = pck.load_pytree(tmp_path / 'j', pw.state)
    for got, want in zip(leaves(st), jax.tree_util.tree_leaves(jw.state)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    # port -> JAX
    pck.save_pytree(tmp_path / 'p', pw.state)
    back = jck.load_pytree(tmp_path / 'p', jw.state)
    for got, want in zip(jax.tree_util.tree_leaves(back), leaves(pw.state)):
        got = np.asarray(got)
        assert got.dtype == want.numpy().dtype
        np.testing.assert_array_equal(got, want.numpy())


def grey_march(world, state, ft, **kw):
    net_fn, p_int, p_c = world._march_inputs(world.forcing)
    return pcol.evolve_to_equilibrium(state, net_fn, p_int, p_c,
                                      flux_thresh=ft, **kw)


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
def test_resumed_march_is_bit_equal(tmp_path, dtype):
    """Checkpoint the march at step 200 with its step count and tightened
    threshold, restore into a fresh world's template, march on: the end is
    the uninterrupted march's, bit for bit."""
    kw = dict(nz=40, ny=1, tau_lw_func='scale_height',
              tau_lw_func_args=[0.22 * p_surface_earth, 4.0])
    w = PGrey(dtype=DTYPES[dtype], device='cpu', **kw)
    full, info = grey_march(w, w.state, 1e-3)
    assert bool(info.equilibrium[0]) and int(info.steps[0]) > 300
    half, info1 = grey_march(w, w.state, 1e-3, max_steps=200,
                             final_reset=False)
    assert int(info1.steps[0]) == 200
    pck.save_pytree(tmp_path / 'ck', (half, info1.steps, info1.flux_thresh))
    w2 = PGrey(dtype=DTYPES[dtype], device='cpu', **kw)
    st, i0, ft = pck.load_pytree(
        tmp_path / 'ck', (w2.state, torch.zeros_like(info1.steps),
                          torch.zeros_like(info1.flux_thresh)))
    end, info2 = grey_march(w2, st, ft, i0=i0)
    assert_same_tree(end, full)
    for a, b in zip(info2, info):
        assert torch.equal(a, b)


def test_orbax_backend_warns_and_writes_npz(tmp_path):
    w = stepped_grey(torch.float64)
    with pytest.warns(UserWarning, match='falling back to npz'):
        pck.save_pytree(tmp_path / 'o', w.state, backend='orbax',
                        async_save=True)
    assert os.path.isfile(tmp_path / 'o.npz')
    with pytest.warns(UserWarning, match='falling back to npz'):
        back = pck.load_pytree(tmp_path / 'o', w.state, backend='orbax')
    assert_same_tree(back, w.state)


def test_timing_helpers(tmp_path):
    assert ptm.model_days_per_second(86400.0 * 3, 2.0) == \
        jtm.model_days_per_second(86400.0 * 3, 2.0) == 1.5
    assert ptm.cell_updates_per_second(100, 40, 2.0) == \
        jtm.cell_updates_per_second(100, 40, 2.0) == 2000.0
    meter = ptm.Throughput()
    assert meter.rate == 0.0
    with meter.measure(work=10):
        torch.ones(4).sum()
    with meter.measure(work=30):
        pass
    assert meter.n_measurements == 2 and meter.total_work == 40
    assert meter.rate == 40 / meter.total_seconds
    calls = []

    def fn(x, k=1):
        calls.append(k)
        return {'y': x * k, 'n': None}
    best, out = ptm.time_fn(fn, torch.ones(3), repeats=4, k=2)
    assert len(calls) == 5 and best >= 0.0
    assert torch.equal(out['y'], torch.full((3,), 2.0))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with ptm.device_trace(tmp_path / 'trace') as prof:
            with ptm.span('probe'):
                torch.ones(8).sum()
    assert prof is not None
    files = sorted(os.listdir(tmp_path / 'trace'))
    assert len(files) == 2
    assert files[0].endswith('.pt.trace.json')
    assert files[1] == files[0].replace('.pt.trace.json', '.spans.json')
    trace, spans = (json.loads((tmp_path / 'trace' / f).read_text())
                    for f in files)
    assert spans['baseTimeNanoseconds'] == trace['baseTimeNanoseconds']
    [probe] = [e for e in spans['traceEvents'] if e['name'] == 'probe']
    ops = [e for e in trace['traceEvents'] if e.get('name') == 'aten::sum']
    # one clock and one time base: the span holds the op it timed
    assert ops and all(probe['ts'] <= op['ts'] <= op['ts'] + op['dur'] <=
                       probe['ts'] + probe['dur'] for op in ops)
