"""Wrappers of the convective-adjustment CUDA kernels
(``csrc/convection.cu``).

* :func:`iso_fit` replaces ``isotonic_increasing_lanes`` /
  ``_iso_kernel`` (climatemodel_tpu/ops/pallas_isotonic.py, K4): the whole
  isotonic fit of [C, n] rows, the prefix sums that the Pallas wrapper
  forms outside ``pallas_call`` included (by the CPU's rule, see
  ``convection.iso_prefix_sums``).
* :func:`div_probe` replaces ``via_pallas`` (tools/probe_mosaic_div.py, K7).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises if the
launch failed, and adds one to its entry of :data:`launch_counts`.  They
never compute on the CPU: the plain versions are in ``ops/convection.py``,
whose dispatchers pick by device.  The kernels have no backward, so each
wrapper refuses an input that requires grad while grad mode is on, naming
the plain version to differentiate instead (``cuda_two_stream._refuse_grad``;
JAX's kernel dispatchers have no reverse mode either).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda_build
from .cuda_two_stream import _check, _raise_on, _refuse_grad

#: launches of each kernel since the last :func:`reset_launch_counts`
launch_counts = {'iso_fit': 0, 'div_probe': 0}

_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}
_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use) with its argtypes."""
    lib, _res = _cuda_build.load('convection')
    for s in _SUFFIX.values():
        fn = getattr(lib, f'iso_fit_{s}')
        fn.argtypes = [_P, _P, _P, _I, _I, _P]
        fn.restype = _I
    lib.div_probe_f32.argtypes = [_P] * 5 + [_I, _P]
    lib.div_probe_f32.restype = _I
    lib.iso_fit_max_levels.argtypes = []
    lib.iso_fit_max_levels.restype = _I
    return lib


def max_levels() -> int:
    """Largest n the iso_fit kernel takes (one thread per level)."""
    return int(library().iso_fit_max_levels())


def iso_fit(theta, v):
    """The weighted non-decreasing isotonic fit of every row (K4).

    :param theta: [C, n] rows (a member's levels contiguous), f32 or f64.
    :param v: [n] shared positive weights.
    :return: [C, n] fits, as ``convection.iso_rows_plain`` gives them on
        the CPU, bit for bit.
    """
    _refuse_grad('iso_fit', 'convection.iso_rows_plain', theta, v)
    if theta.dtype not in _SUFFIX:
        raise ValueError(f'iso_fit: unsupported dtype {theta.dtype}')
    if theta.ndim != 2 or theta.shape[1] < 1:
        raise ValueError(f'iso_fit: theta must be [C, n] with n >= 1, got '
                         f'{tuple(theta.shape)}')
    C, n = theta.shape
    _check('theta', theta, (C, n), theta)
    _check('v', v, (n,), theta)
    lib = library()
    if n > max_levels():
        raise ValueError(f'iso_fit: n={n} levels exceed the kernel\'s limit '
                         f'of {max_levels()} levels')
    out = torch.empty((C, n), dtype=theta.dtype, device=theta.device)
    if C == 0:
        return out
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = getattr(lib, f'iso_fit_{_SUFFIX[theta.dtype]}')(
            theta.data_ptr(), v.data_ptr(), out.data_ptr(), n, C, stream)
    _raise_on(err, 'iso_fit')
    launch_counts['iso_fit'] += 1
    return out


def div_probe(a, b):
    """K7: (a / b, (C * a) / b, a / |b|) of two f32 tensors of one shape."""
    _refuse_grad('div_probe', 'convection.div_probe_plain', a, b)
    if a.dtype != torch.float32:
        raise ValueError(f'div_probe: needs float32, got {a.dtype}')
    _check('a', a, a.shape, a)
    _check('b', b, a.shape, a)
    outs = tuple(torch.empty_like(a) for _ in range(3))
    if a.numel() == 0:
        return outs
    lib = library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.div_probe_f32(a.data_ptr(), b.data_ptr(),
                                *(o.data_ptr() for o in outs), a.numel(),
                                stream)
    _raise_on(err, 'div_probe')
    launch_counts['div_probe'] += 1
    return outs
