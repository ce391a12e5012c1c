"""Wrappers of the grey two-stream CUDA kernels (``csrc/two_stream.cu``).

Port of ``climatemodel_tpu/ops/pallas_two_stream.py``:

* :func:`lw_walk` replaces ``lw_flux_lanes`` (the K1 row kernel and the K2
  packed kernel, one kernel on Hopper);
* :func:`net_stats_walk` replaces ``grey_net_stats_lanes`` (K3).

:func:`lw_walk` takes the batch on the LAST axis ([n, b], member index
contiguous), as the Pallas kernels do; :func:`net_stats_walk` takes the
march's own rows ([b, n], a member's column contiguous), so the march hands
its carries over without a copy.  Each wrapper checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream, raises if the launch failed, and adds one to its entry of
:data:`launch_counts` and to its device's of :data:`device_launch_counts`.
They never compute on the CPU: the plain twins live in
``ops/two_stream.py`` and the dispatchers there pick by device.

The kernels have no backward: an output of ``torch.empty`` carries no graph.
So each wrapper refuses an input that requires grad while grad mode is on
(:func:`_refuse_grad`), naming the plain route to differentiate instead,
rather than return a tensor that silently cuts the gradient.  JAX's kernel
dispatchers have no reverse mode either
(``tests/test_differentiability.py:58-60``).
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _cuda_build

#: launches of each kernel since the last :func:`reset_launch_counts`
launch_counts = {'lw_walk': 0, 'net_stats_walk': 0}
#: launches of each (kernel, device) pair since the last reset, e.g.
#: ``('net_stats_walk', 'cuda:1')``
device_launch_counts = collections.Counter()

_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}
_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0
    device_launch_counts.clear()


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use) with its argtypes."""
    lib, _res = _cuda_build.load('two_stream')
    for s in _SUFFIX.values():
        fn = getattr(lib, f'lw_walk_{s}')
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P]
        fn.restype = _I
        fn = getattr(lib, f'net_stats_walk_{s}')
        fn.argtypes = [_P] * 8 + [_I, _I, _I, _P]
        fn.restype = _I
    lib.two_stream_max_topk.argtypes = []
    lib.two_stream_max_topk.restype = _I
    return lib


def max_topk() -> int:
    """Largest top-k depth L the net-stats kernel is instantiated for."""
    return int(library().two_stream_max_topk())


def _check(name, x, shape, ref):
    if not x.is_cuda:
        raise ValueError(f'{name}: the CUDA kernel needs a CUDA tensor, got '
                         f'one on {x.device}')
    if x.device != ref.device or x.dtype != ref.dtype:
        raise ValueError(f'{name}: expected {ref.dtype} on {ref.device}, got '
                         f'{x.dtype} on {x.device}')
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, got '
                         f'{tuple(x.shape)}')
    if not x.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')


def _refuse_grad(kernel, plain, *tensors):
    """Raise if grad mode is on and an input of ``kernel`` requires grad:
    the kernel has no backward, so its outputs would carry no graph."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in tensors):
        raise RuntimeError(
            f'{kernel}: the CUDA kernel has no backward and an input '
            f'requires grad; differentiate through {plain} instead (or '
            f'detach the inputs, or run under torch.no_grad())')


def _raise_on(err, kernel):
    if err != 0:
        raise RuntimeError(f'{kernel} launch failed: CUDA error {err}')


def lw_walk(T, dtau, up_flux_toa):
    """Surface-first lw fluxes with the batch on the LAST axis (K1/K2).

    :param T, dtau: [n, b] cell values (index 0 = surface), f32 or f64.
    :param up_flux_toa: [b] TOA upward boundary condition.
    :return: (up, down) [n+1, b] interface fluxes; the same arithmetic in
        the same order as ``two_stream.lw_flux_sequential``.
    """
    _refuse_grad('lw_walk', 'two_stream.lw_flux_plain', T, dtau, up_flux_toa)
    if T.dtype not in _SUFFIX:
        raise ValueError(f'lw_walk: unsupported dtype {T.dtype}')
    n, b = T.shape
    _check('T', T, (n, b), T)
    _check('dtau', dtau, (n, b), T)
    _check('up_flux_toa', up_flux_toa, (b,), T)
    up = torch.empty((n + 1, b), dtype=T.dtype, device=T.device)
    down = torch.empty_like(up)
    if b == 0:
        return up, down
    lib = library()
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        err = getattr(lib, f'lw_walk_{_SUFFIX[T.dtype]}')(
            T.data_ptr(), dtau.data_ptr(), up_flux_toa.data_ptr(),
            up.data_ptr(), down.data_ptr(), n, b, stream)
    _raise_on(err, 'lw_walk')
    launch_counts['lw_walk'] += 1
    device_launch_counts[('lw_walk', str(T.device))] += 1
    return up, down


def net_stats_walk(T, dtau, up_sw, down_sw, up_toa, prev_net, L):
    """Fused net flux + exit statistics, one member per ROW (K3).

    :param T, dtau: [b, n] cell values (index 0 = surface), f32 or f64.
    :param up_sw, down_sw, prev_net: [b, n+1] interface values.
    :param up_toa: [b] TOA upward lw boundary condition.
    :param L: top-k depth, 2 <= L <= min(:func:`max_topk`, n+1).
    :return: (net [b, n+1], top1 [b], top_hi [b], top_lo [b], absmax [b]) —
        as ``two_stream.net_stats_rows_plain``.
    """
    _refuse_grad('net_stats_walk', 'two_stream.lw_flux_plain', T, dtau,
                 up_sw, down_sw, up_toa, prev_net)
    if T.dtype not in _SUFFIX:
        raise ValueError(f'net_stats_walk: unsupported dtype {T.dtype}')
    b, n = T.shape
    _check('T', T, (b, n), T)
    _check('dtau', dtau, (b, n), T)
    for name, x in (('up_sw', up_sw), ('down_sw', down_sw),
                    ('prev_net', prev_net)):
        _check(name, x, (b, n + 1), T)
    _check('up_toa', up_toa, (b,), T)
    lib = library()
    if not 2 <= L <= min(max_topk(), n + 1):
        raise ValueError(f'net_stats_walk: top-k depth {L} outside '
                         f'2..{min(max_topk(), n + 1)}')
    net = torch.empty((b, n + 1), dtype=T.dtype, device=T.device)
    stats = torch.empty((4, b), dtype=T.dtype, device=T.device)
    if b > 0:
        with torch.cuda.device(T.device):
            stream = torch.cuda.current_stream(T.device).cuda_stream
            err = getattr(lib, f'net_stats_walk_{_SUFFIX[T.dtype]}')(
                T.data_ptr(), dtau.data_ptr(), up_sw.data_ptr(),
                down_sw.data_ptr(), up_toa.data_ptr(), prev_net.data_ptr(),
                net.data_ptr(), stats.data_ptr(), n, b, int(L), stream)
        _raise_on(err, 'net_stats_walk')
        launch_counts['net_stats_walk'] += 1
        device_launch_counts[('net_stats_walk', str(T.device))] += 1
    return net, stats[0], stats[1], stats[2], stats[3]
