"""Wrapper of the fused Richtmyer step CUDA kernel (``csrc/stencils.cu``).

:func:`richtmyer_step` replaces both Pallas kernels of
``climatemodel_tpu/ops/pallas_stencils.py``: with ``bx=None`` it is
``richtmyer_step_interior`` (K5: the interior only), with a boundary mode it
is ``richtmyer_step_frame`` (K6: every ghost cell of
``apply_boundary_conditions`` too), on unpadded [nx, ny] fields.

The wrapper checks device, dtype, shape and strides, allocates its outputs
with ``torch.empty`` (or writes into ``out``), launches on the current
stream, raises if the launch failed, and adds one to its mode's entry of
:data:`launch_counts`.  It never computes on the CPU: the plain versions and
the dispatchers are in ``ops/stencils.py``.

The step is one launch: the kernel reduces max2 itself, through an
accumulator and a block ticket that the wrapper allocates once per device
and stream (:func:`_max2_scratch`, zeros) and that every launch leaves at
zero.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda_build
from .cuda_two_stream import _check, _raise_on

#: launches of each mode since the last :func:`reset_launch_counts`:
#: ``richtmyer_step_interior`` (K5, bx=None), ``richtmyer_step_bc`` (K6)
launch_counts = {'richtmyer_step_interior': 0, 'richtmyer_step_bc': 0}

_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}
_BX = {None: 0, 'walls': 1, 'periodic': 2, 'given': 3}
_BY = {None: 0, 'walls': 1, 'periodic': 2}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# (device index, stream) -> int64 [3]: the f64 max2 accumulator, the f32 one
# (the low half of the second word) and the block ticket
_SCRATCH = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use) with its argtypes."""
    lib, _res = _cuda_build.load('stencils')
    for s in _SUFFIX.values():
        fn = getattr(lib, f'richtmyer_step_{s}')
        fn.argtypes = ([_P, _P, _P, _P, _L, _P, _L, _P, _L, _P, _L]
                       + [_P] * 11 + [_I] * 4 + [_P])
        fn.restype = _I
    return lib


def _max2_scratch(device, stream):
    """The max2 accumulators and block ticket of one device and stream:
    allocated once as zeros; every launch leaves them at zero."""
    key = (device.index, stream)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.zeros(3, dtype=torch.int64, device=device)
    return _SCRATCH[key]


def _interior(name, x, nxi, nyi, ref, row_ok):
    """(tensor, row stride) of an interior field: [nxi, nyi] with a unit
    last stride (views such as ``f[1:-1, 1:-1]`` included), or, where
    ``row_ok``, one broadcast row [1, nyi] (row stride 0)."""
    if not x.is_cuda:
        raise ValueError(f'{name}: the CUDA kernel needs a CUDA tensor, got '
                         f'one on {x.device}')
    if x.device != ref.device or x.dtype != ref.dtype:
        raise ValueError(f'{name}: expected {ref.dtype} on {ref.device}, got '
                         f'{x.dtype} on {x.device}')
    rows = (nxi, 1) if row_ok else (nxi,)
    if x.ndim != 2 or x.shape[0] not in rows or x.shape[1] != nyi:
        raise ValueError(f'{name}: expected shape ({nxi}, {nyi})'
                         + (f' or (1, {nyi})' if row_ok else '')
                         + f', got {tuple(x.shape)}')
    if x.stride(1) != 1 and nyi > 1:
        raise ValueError(f'{name}: the last axis must have stride 1')
    return x, (0 if x.shape[0] == 1 and nxi > 1 else x.stride(0))


def _scalar(name, x, ref, dtype):
    if not isinstance(x, torch.Tensor) or x.numel() != 1:
        raise ValueError(f'{name}: expected a one-element tensor on '
                         f'{ref.device}, got {x!r}')
    if x.device != ref.device or x.dtype != dtype:
        raise ValueError(f'{name}: expected {dtype} on {ref.device}, got '
                         f'{x.dtype} on {x.device}')
    return x.contiguous()


def richtmyer_step(h, u, v, f_cor, r_damp, dhb_dx, dhb_dy, dt, ok, g, dx, dy,
                   bx=None, by=None, out=None):
    """One fused nonlinear Richtmyer step on the card.

    :param h, u, v: [nx, ny] contiguous fields with ghost cells, f32 or f64.
    :param f_cor, r_damp: interior [nx-2, ny-2] fields or one row [1, ny-2].
    :param dhb_dx, dhb_dy: [nx-2, ny-2] orography gradients, or both None.
    :param dt, g, dx, dy: one-element tensors of h's dtype on its device;
        ``ok`` a one-element bool tensor there.
    :param bx, by: None for K5 (interior outputs [nx-2, ny-2]); else
        bx in walls/periodic/given and by in walls/periodic (K6, outputs
        [nx, ny] with ghosts; x ghost rows not written for 'given').
    :param out: optional (h, u, v) output tensors of the output shape, not
        sharing memory with h, u, v.
    :return: (h, u, v, max2), max2 a 0-d tensor.
    """
    if h.dtype not in _SUFFIX:
        raise ValueError(f'richtmyer_step: unsupported dtype {h.dtype}')
    if h.ndim != 2 or h.shape[0] < 3 or h.shape[1] < 3:
        raise ValueError(f'richtmyer_step: h must be [nx, ny] with nx, ny >= '
                         f'3, got {tuple(h.shape)}')
    if bx not in _BX or by not in _BY or (bx is None) != (by is None):
        raise ValueError(f'richtmyer_step: invalid boundary modes ({bx!r}, '
                         f'{by!r})')
    nx, ny = h.shape
    nxi, nyi = nx - 2, ny - 2
    for name, x in (('h', h), ('u', u), ('v', v)):
        _check(name, x, (nx, ny), h)
    f_cor, f_stride = _interior('f_cor', f_cor, nxi, nyi, h, True)
    r_damp, r_stride = _interior('r_damp', r_damp, nxi, nyi, h, True)
    if (dhb_dx is None) != (dhb_dy is None):
        raise ValueError('richtmyer_step: pass both orography gradients or '
                         'neither')
    grads = []
    for name, x in (('dhb_dx', dhb_dx), ('dhb_dy', dhb_dy)):
        if x is None:
            grads += [None, 0]
        else:
            grads += list(_interior(name, x, nxi, nyi, h, False))
    scal = [_scalar(name, x, h, h.dtype)
            for name, x in (('dt', dt), ('g', g), ('dx', dx), ('dy', dy))]
    ok = _scalar('ok', ok, h, torch.bool)
    shape = (nxi, nyi) if bx is None else (nx, ny)
    if out is None:
        out = tuple(torch.empty(shape, dtype=h.dtype, device=h.device)
                    for _ in range(3))
    else:
        ins = {x.untyped_storage().data_ptr() for x in (h, u, v)}
        for name, o in zip(('h_out', 'u_out', 'v_out'), out):
            _check(name, o, shape, h)
            if o.untyped_storage().data_ptr() in ins:
                raise ValueError(f'richtmyer_step: {name} shares memory with '
                                 f'an input')
    lib = library()
    max2 = torch.empty((), dtype=h.dtype, device=h.device)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        scratch = _max2_scratch(h.device, stream).data_ptr()
        acc = scratch if h.dtype == torch.float64 else scratch + 8
        err = getattr(lib, f'richtmyer_step_{_SUFFIX[h.dtype]}')(
            h.data_ptr(), u.data_ptr(), v.data_ptr(),
            f_cor.data_ptr(), f_stride, r_damp.data_ptr(), r_stride,
            ptr(grads[0]), grads[1], ptr(grads[2]), grads[3],
            *(x.data_ptr() for x in scal), ok.data_ptr(),
            *(o.data_ptr() for o in out), max2.data_ptr(), acc, scratch + 16,
            nx, ny, _BX[bx], _BY[by], stream)
    _raise_on(err, 'richtmyer_step')
    launch_counts['richtmyer_step_interior' if bx is None
                  else 'richtmyer_step_bc'] += 1
    return (*out, max2)
