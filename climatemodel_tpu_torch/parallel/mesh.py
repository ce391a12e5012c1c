"""Device meshes for sharded runs (port of ``climatemodel_tpu/parallel/
mesh.py``).

JAX's ``shard_map`` is single-controller: one process drives every shard.
The port keeps that model.  A :class:`Mesh` is an array of
``torch.device`` s with axis names; a device may repeat, so
``[cuda:0] * 4`` is four shards on one card and ``[cpu] * 8`` is the
tests' eight-shard mesh.  A sharded value is a list of per-shard tensors,
one on each mesh device in the mesh's row-major order, and the collectives
of ``parallel/collectives.py`` act on such lists.  Every shard's tensor
lives on its own mesh device (``collectives.check_on_mesh``), and no
shard's tensor is a view of another's.
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """Devices arranged in a named-axis grid, as ``jax.sharding.Mesh``.

    :param devices: array-like of ``torch.device`` (or device strings) of
        the mesh's shape.
    :param axis_names: one name per axis of ``devices``.
    """

    def __init__(self, devices, axis_names):
        grid = np.vectorize(torch.device, otypes=[object])(
            np.asarray(devices, dtype=object))
        if grid.ndim != len(axis_names):
            raise ValueError(f'{len(axis_names)} axis names for a mesh of '
                             f'shape {grid.shape}')
        self.devices = grid
        self.axis_names = tuple(axis_names)
        #: axis name -> its size, as ``jax.sharding.Mesh.shape``
        self.shape = dict(zip(self.axis_names, grid.shape))

    @property
    def size(self):
        return self.devices.size

    @property
    def flat_devices(self):
        """The devices of the shards in row-major order."""
        return list(self.devices.reshape(-1))

    def __repr__(self):
        return f'Mesh({self.shape}, {self.flat_devices})'


def cuda_devices():
    """Every CUDA device of this process; raises when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError('make_mesh: no CUDA device; pass devices= '
                           '(e.g. [torch.device("cpu")] * 8) to shard on '
                           'another device')
    return [torch.device('cuda', i) for i in range(n)]


def make_mesh(axis_names=('x',), shape=None, devices=None) -> Mesh:
    """Build a Mesh over the given devices (default: every CUDA device).

    :param axis_names: mesh axis names, e.g. ('x',) or ('data', 'x').
    :param shape: per-axis sizes; None -> all devices on the first axis.
    :param devices: a list of devices; one may repeat (several shards on
        one card).
    """
    if devices is None:
        devices = cuda_devices()
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f'mesh shape {shape} does not use all {n} devices')
    return Mesh(np.asarray(devices, dtype=object).reshape(shape), axis_names)


def factor_devices(n: int):
    """Factor n into a near-square 2-D mesh shape (rows, cols)."""
    best = (n, 1)
    for rows in range(1, int(np.sqrt(n)) + 1):
        if n % rows == 0:
            best = (n // rows, rows)
    return best


def on_device(x, device) -> bool:
    """Whether tensor ``x`` lives on ``device`` (a CUDA device without an
    index is the current one)."""
    d, want = x.device, torch.device(device)
    if d.type != want.type:
        return False
    if want.index is None:
        return d.type != 'cuda' or d.index == torch.cuda.current_device()
    return d.index == want.index
