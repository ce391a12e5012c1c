"""The C++ host data plane of the HITRAN pipeline, bound through ctypes
(port of ``climatemodel_tpu/native``).

``hitran_native.cpp`` beside this file (the port's own copy of the JAX
package's source) holds a whitespace-table parser and the OpenMP windowed
Lorentzian line accumulator.  ``g++ -O3 -shared -fPIC -fopenmp`` compiles
it at first use, never at import, retried without ``-fopenmp`` where the
toolchain has no OpenMP; both builds give the same bits, because each row
sums its lines in order.  The library lands in ``build/native/`` at the
repository root (git-ignored), named by a hash of the source and the flags
(``ops/_cuda_build.cached_path`` and ``compile_to``, the kernels' rule), so
an edited source rebuilds and an unchanged one is loaded as it is.
Nothing is written into the package, and the JAX package's library is
never loaded.

Without ``g++`` on ``PATH`` (and no cached build) :func:`available` is
False and ``spectral.hitran``'s ``backend='auto'`` takes the PyTorch
accumulation.  Where the compiler is present and the build fails, the
compiler's message is raised: a stale or foreign library never stands in.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path

import numpy as np

from ..ops import _cuda_build

SRC = Path(__file__).resolve().parent / 'hitran_native.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'
#: the OpenMP build, then the build without it
FLAG_SETS = (('-O3', '-shared', '-fPIC', '-fopenmp'),
             ('-O3', '-shared', '-fPIC'))

_lock = threading.Lock()
_lib = None


def _target(flags):
    return _cuda_build.cached_path(BUILD_DIR, 'hitran_native',
                                   SRC.read_bytes(), flags)


def build(force=False):
    """Compile ``hitran_native.cpp`` into ``build/native/`` unless the
    library for this exact source and flags is there already; returns its
    path.  Tries the OpenMP flags first, then the flags without it.

    :raises FileNotFoundError: no ``g++`` on ``PATH`` and no cached build.
    :raises RuntimeError: ``g++`` failed with both flag sets (its message).
    """
    if not force:
        for flags in FLAG_SETS:
            if _target(flags).exists():
                return _target(flags)
    if shutil.which('g++') is None:
        raise FileNotFoundError('g++ not found: the native HITRAN library '
                                'needs a C++ compiler to build')
    errors = []
    for flags in FLAG_SETS:
        proc = _cuda_build.compile_to(['g++', *flags, str(SRC)],
                                      _target(flags))
        if proc.returncode == 0:
            return _target(flags)
        errors.append(f'g++ {" ".join(flags)} (exit {proc.returncode}):\n'
                      f'{proc.stderr}')
    raise RuntimeError(f'building {SRC.name} failed:\n' + '\n'.join(errors))


def _bind(path):
    lib = ctypes.CDLL(str(path))
    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_long_p = ctypes.POINTER(ctypes.c_long)
    lib.table_dims.argtypes = [ctypes.c_char_p, ctypes.c_long, c_long_p,
                               c_long_p]
    lib.table_dims.restype = ctypes.c_int
    lib.parse_table.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                ctypes.c_long, ctypes.c_long, c_double_p]
    lib.parse_table.restype = ctypes.c_long
    lib.accumulate_lines.argtypes = [
        c_double_p, c_double_p, ctypes.c_long,          # p, T, np
        c_double_p, ctypes.c_long, ctypes.c_double,     # nu, nnu, dnu
        c_double_p, c_double_p, c_double_p, c_double_p,  # line arrays
        ctypes.c_long, ctypes.c_double,                 # nlines, n_widths
        ctypes.c_double, ctypes.c_double, ctypes.c_double,  # refs, hck
        c_double_p]                                     # out
    lib.accumulate_lines.restype = None
    return lib


def _load():
    """The bound library, built on first use; None when no compiler is on
    ``PATH`` and nothing is cached."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                path = build()
            except FileNotFoundError:
                return None
            _lib = _bind(path)
        return _lib


def available() -> bool:
    """True iff the library is built (or now builds) and loads.  A failed
    build with a compiler present raises instead of returning False."""
    return _load() is not None


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError('native library unavailable: no g++ on PATH')
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def parse_numeric_table(path, skip_lines=1):
    """Parse the numeric body of a whitespace-delimited table (a native
    np.genfromtxt; the header is the caller's).  Rows with another number
    of tokens than the first data row are skipped.

    :return: [rows, cols] float64 array.
    """
    lib = _library()
    path = os.fspath(path)
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    rc = lib.table_dims(path.encode(), skip_lines, ctypes.byref(rows),
                        ctypes.byref(cols))
    if rc != 0:
        raise OSError(f'cannot read {path}')
    out = np.empty((rows.value, cols.value), dtype=np.float64)
    got = lib.parse_table(path.encode(), skip_lines, rows.value, cols.value,
                          _ptr(out))
    if got != rows.value:
        raise ValueError(f'parsed {got} of {rows.value} rows from {path}')
    return out


def accumulate_lines(p, T, nu_grid, lines, n_line_widths, p_reference,
                     T_reference, hck):
    """Windowed Lorentzian accumulation in C++ (see hitran_native.cpp).

    :param lines: dict with 'nu', 'sw', 'gamma_air', 'n_air' float64 arrays.
    :return: [np, n_nu] float64 absorption-coefficient grid.
    """
    lib = _library()
    p = np.ascontiguousarray(p, dtype=np.float64)
    T = np.ascontiguousarray(T, dtype=np.float64)
    nu_grid = np.ascontiguousarray(nu_grid, dtype=np.float64)
    lnu = np.ascontiguousarray(lines['nu'], dtype=np.float64)
    lsw = np.ascontiguousarray(lines['sw'], dtype=np.float64)
    lg = np.ascontiguousarray(lines['gamma_air'], dtype=np.float64)
    ln = np.ascontiguousarray(lines['n_air'], dtype=np.float64)
    out = np.zeros((p.size, nu_grid.size), dtype=np.float64)
    dnu = float(nu_grid[1] - nu_grid[0]) if nu_grid.size > 1 else 1.0
    lib.accumulate_lines(_ptr(p), _ptr(T), p.size, _ptr(nu_grid), nu_grid.size,
                         dnu, _ptr(lnu), _ptr(lsw), _ptr(lg), _ptr(ln),
                         lnu.size, float(n_line_widths), float(p_reference),
                         float(T_reference), float(hck), _ptr(out))
    return out
