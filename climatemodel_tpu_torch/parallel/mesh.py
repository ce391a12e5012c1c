"""Device meshes for sharded runs (port of ``climatemodel_tpu/parallel/
mesh.py``).

JAX's ``shard_map`` is SPMD: each device runs its own copy of the body on
its own shard.  The port has two kinds of mesh, and every sharded
composition runs unchanged under either:

* :class:`Mesh`, one controller: an array of ``torch.device`` s with axis
  names, all driven by this process; a device may repeat, so
  ``[cuda:0] * 4`` is four shards on one card and ``[cpu] * 8`` is the
  tests' eight-shard mesh.  It is the way to put several shards on one
  card (NCCL takes one rank a card).
* :class:`ProcessMesh`, one process a shard (:func:`init_process_mesh`,
  under ``torchrun`` or ``parallel/launch.run_ranks``): each rank drives
  its own shard on its own card, and the collectives go through
  ``torch.distributed`` (NCCL for CUDA tensors, gloo for CPU tensors).

A sharded value is a list of tensors, one for each of the mesh's
``local_shards`` (the flat, row-major indices of the shards this process
drives: every shard on a :class:`Mesh`, the rank's own on a
:class:`ProcessMesh`), each on its entry of ``local_devices``; the
collectives of ``parallel/collectives.py`` act on such lists.  No shard's
tensor is a view of another's.
"""
from __future__ import annotations

import datetime
import os

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

    @property
    def local_shards(self):
        """The flat indices of the shards this process drives: all."""
        return list(range(self.size))

    @property
    def local_devices(self):
        """The devices of :attr:`local_shards`."""
        return self.flat_devices

    def __repr__(self):
        return f'Mesh({self.shape}, {self.flat_devices})'


class ProcessMesh:
    """A mesh of processes, one shard each, over the default
    ``torch.distributed`` group (see :func:`init_process_mesh`): the same
    ``axis_names``, ``shape`` and row-major shard order as :class:`Mesh`,
    shard k being rank k.  The process drives its own shard only
    (``local_shards == [rank]``) on ``device``.

    Building one calls ``dist.new_group`` once for every line of every
    axis, in the same order on every rank, so every rank builds the same
    meshes in the same order.
    """

    def __init__(self, axis_names=('x',), shape=None, *, device):
        import torch.distributed as dist
        world = dist.get_world_size()
        if shape is None:
            shape = (world,) + (1,) * (len(axis_names) - 1)
        shape = tuple(int(n) for n in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f'{len(axis_names)} axis names for a mesh of '
                             f'shape {shape}')
        if int(np.prod(shape)) != world:
            raise ValueError(f'mesh shape {shape} does not use all {world} '
                             f'ranks')
        ranks = np.arange(world).reshape(shape)
        groups = {}
        for ax, name in enumerate(axis_names):
            lines = np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax])
            for line in lines.tolist():
                g = dist.new_group(line)
                if dist.get_rank() in line:
                    groups[name] = g
        self._init(tuple(axis_names), ranks, dist.get_rank(), groups, None,
                   torch.device(device))

    def _init(self, axis_names, ranks, rank, groups, span_group, device):
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, ranks.shape))
        #: global ranks of the shards, in the mesh's shape
        self.ranks = ranks
        self.rank = rank
        self.device = device
        self._groups = groups
        self._span_group = span_group     # None: the default (world) group
        flat = ranks.reshape(-1).tolist()
        self._index = flat.index(rank)
        self.coords = tuple(int(c) for c in np.unravel_index(self._index,
                                                             ranks.shape))

    @property
    def size(self):
        return self.ranks.size

    @property
    def local_shards(self):
        return [self._index]

    @property
    def local_devices(self):
        return [self.device]

    def group(self, axis_name):
        """The process group of this rank's line along ``axis_name``."""
        return self._groups[axis_name]

    @property
    def span_group(self):
        """The process group of every shard of this mesh."""
        return self._span_group

    def line_ranks(self, axis_name):
        """The global ranks of this rank's line along ``axis_name``, in
        axis order."""
        ax = self.axis_names.index(axis_name)
        idx = list(self.coords)
        idx[ax] = slice(None)
        return self.ranks[tuple(idx)].tolist()

    def line_mesh(self, axis_name):
        """This rank's line along ``axis_name`` as a 1-D process mesh (its
        group the line's)."""
        sub = object.__new__(ProcessMesh)
        sub._init((axis_name,), np.asarray(self.line_ranks(axis_name)),
                  self.rank, {axis_name: self._groups[axis_name]},
                  self._groups[axis_name], self.device)
        return sub

    def __repr__(self):
        return (f'ProcessMesh({self.shape}, rank {self.rank} of '
                f'{self.size}, {self.device})')


def _env_int(name, given):
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise ValueError(f'init_process_mesh: {name} is not set; run under '
                         f'torchrun, or pass rank= and world_size=')
    return int(os.environ[name])


def init_process_mesh(axis_names=('x',), shape=None, *, device='cuda',
                      init_method=None, rank=None, world_size=None,
                      timeout_s=120) -> ProcessMesh:
    """Join the process group and return this rank's :class:`ProcessMesh`.

    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` are read from the
    environment, as ``torchrun`` sets them, unless ``rank`` and
    ``world_size`` are given (the local rank is then the rank: one host).
    On ``cuda`` the rank takes card ``LOCAL_RANK``
    (``torch.cuda.set_device``) and joins an NCCL group bound to it; on
    ``cpu`` a gloo group.  Raises without a card, for a rank beyond the
    cards (one rank a card), and when the group does not form within
    ``timeout_s``; nothing falls back to another backend or mesh.

    :param init_method: the rendezvous (``'env://'`` by default, which
        reads ``MASTER_ADDR`` and ``MASTER_PORT``; ``run_ranks`` passes a
        ``file://`` path).
    """
    import torch.distributed as dist
    local_rank = (rank if rank is not None
                  else int(os.environ.get('LOCAL_RANK', _env_int('RANK',
                                                                 None))))
    rank = _env_int('RANK', rank)
    world_size = _env_int('WORLD_SIZE', world_size)
    device = torch.device(device)
    if device.type == 'cuda':
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError('init_process_mesh: no CUDA device; pass '
                               'device="cpu" for gloo ranks on the CPU')
        if local_rank >= n:
            raise ValueError(
                f'init_process_mesh: local rank {local_rank} but {n} CUDA '
                f'device(s): NCCL takes one rank a card.  To put several '
                f'shards on one card, use the single-controller mesh, '
                f'make_mesh(axis_names, devices=[torch.device("cuda", 0)] '
                f'* shards)')
        device = torch.device('cuda', local_rank)
        torch.cuda.set_device(device)
        backend, kw = 'nccl', dict(device_id=device)
    elif device.type == 'cpu':
        backend, kw = 'gloo', {}
    else:
        raise ValueError(f'init_process_mesh: no backend for {device}')
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f'init_process_mesh: the process group is '
                               f'{dist.get_backend()}, not {backend}')
    else:
        dist.init_process_group(
            backend, init_method=init_method or 'env://', rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return ProcessMesh(axis_names, shape, device=device)


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
