"""Build and load the port's CUDA kernels.

``nvcc`` compiles each source under ``ops/csrc/`` into a shared library with
a plain C interface, loaded with ``ctypes``.  The library lands in
``build/kernels/`` at the repository root (git-ignored), named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
is loaded as it is.  Nothing is built when the module is imported: the first
call that needs a kernel builds it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'

# -fmad=false: no multiply-add contraction, so the kernels round in the op
# order of their plain PyTorch twins.  No --use_fast_math: exp stays the
# accurate expf/exp.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3', '-std=c++17',
              '-shared', '-Xcompiler', '-fPIC', '-fmad=false', '-Xptxas', '-v')


@functools.lru_cache(maxsize=None)
def find_nvcc() -> str:
    """The CUDA compiler: on PATH, else under PyTorch's CUDA_HOME."""
    nvcc = shutil.which('nvcc')
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is not None and os.path.exists(
                os.path.join(CUDA_HOME, 'bin', 'nvcc')):
            nvcc = os.path.join(CUDA_HOME, 'bin', 'nvcc')
    if nvcc is None:
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                           'toolkit to build')
    return nvcc


class BuildResult(NamedTuple):
    """A built library: its path, the seconds the build took (0.0 when the
    cached library was loaded) and what the compiler printed (register and
    spill counts from ``-Xptxas -v``)."""
    path: Path
    seconds: float
    log: str


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless the library for this exact source,
    the headers beside it and these flags is already in ``build/kernels/``."""
    src = CSRC / f'{name}.cu'
    text = src.read_bytes() + b''.join(
        h.read_bytes() for h in sorted(CSRC.glob('*.cuh')))
    digest = hashlib.sha256(text
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f'lib{name}_{digest}.so'
    if out.exists():
        return BuildResult(out, 0.0, '')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, '-o', tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {src.name} '
                               f'(exit {proc.returncode}):\n{proc.stderr}')
        os.replace(tmp, out)           # atomic: a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildResult(out, time.perf_counter() - t0,
                       proc.stdout + proc.stderr)


def ptx(name: str) -> str:
    """The PTX that ``nvcc`` emits for ``csrc/<name>.cu`` with the build's
    code-generation flags, to read which instructions were chosen (e.g. the
    f32 division: ``div.rn.f32`` or an approximate form)."""
    src = CSRC / f'{name}.cu'
    flags = ['-arch=compute_90a'] + [
        f for f in NVCC_FLAGS if f not in (
            '-gencode', 'arch=compute_90a,code=sm_90a', '-shared',
            '-Xcompiler', '-fPIC', '-Xptxas', '-v')]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.ptx', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([find_nvcc(), *flags, '-ptx', '-o', tmp,
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc -ptx failed on {src.name} '
                               f'(exit {proc.returncode}):\n{proc.stderr}')
        return Path(tmp).read_text()
    finally:
        os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def load(name: str) -> tuple[ctypes.CDLL, BuildResult]:
    """Build (if needed) and load ``csrc/<name>.cu``; one load per process."""
    res = build(name)
    return ctypes.CDLL(str(res.path)), res
