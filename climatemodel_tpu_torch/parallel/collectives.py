"""The collectives of a single-controller mesh (the port's counterparts of
``lax.ppermute``, ``lax.psum``, ``lax.pmax`` and ``lax.axis_index``).

A sharded value is a list of per-shard tensors in the mesh's row-major
order (``Mesh.flat_devices``).  Each collective acts along one named axis,
independently on every line of shards that differ only in that axis's
index, and runs in a stated order.  None reads a value back to the host:
the results stay on the shards' devices.

Aliasing: on a mesh whose devices repeat, ``x.to(device)`` returns the
sender's own storage.  :func:`ppermute` therefore returns fresh copies, or
writes into the receivers' buffers with ``copy_`` when given ``out``; the
reductions return one tensor that the shards of a line share, to be read,
never written in place.

A member axis (an ensemble's leading axis) is cut into contiguous blocks
along one mesh axis or several (:func:`shard_members`), each block a copy of
its own on its shard's device, and gathered back (:func:`gather_members`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .mesh import on_device


def axis_lines(mesh, axis_name):
    """Flat shard indices of each line of ``mesh`` along ``axis_name`` (the
    other axes' indices fixed), each line in axis order."""
    ax = mesh.axis_names.index(axis_name)
    idx = np.arange(mesh.size).reshape(mesh.devices.shape)
    return np.moveaxis(idx, ax, -1).reshape(-1, idx.shape[ax]).tolist()


def axis_index(mesh, axis_name):
    """Each shard's index along ``axis_name``, as Python ints (the shard's
    ``lax.axis_index``; static, as in a traced ``shard_map`` body)."""
    out = [0] * mesh.size
    for line in axis_lines(mesh, axis_name):
        for i, s in enumerate(line):
            out[s] = i
    return out


def ppermute(mesh, axis_name, xs, perm, out=None):
    """``lax.ppermute``: the shard at index ``dst`` along the axis receives
    the value of the shard at ``src``, for each ``(src, dst)`` in ``perm``.

    :param out: optional list of receiving tensors (e.g. ghost rows of the
        receivers' buffers): each destination is written with ``copy_``,
        the others are left as they are.  Without it, each destination gets
        a fresh copy on its device and every other shard zeros, as in JAX.
    """
    devs = mesh.flat_devices
    got = [None] * len(xs)
    for line in axis_lines(mesh, axis_name):
        for src, dst in perm:
            s, d = line[src], line[dst]
            if out is None:
                got[d] = xs[s].to(devs[d], copy=True)
            else:
                out[d].copy_(xs[s])
    if out is not None:
        return out
    return [torch.zeros_like(x, device=devs[k]) if g is None else g
            for k, (x, g) in enumerate(zip(xs, got))]


def _reduce(mesh, axis_name, xs, op):
    devs = mesh.flat_devices
    res = [None] * len(xs)
    for line in axis_lines(mesh, axis_name):
        total = xs[line[0]]
        for s in line[1:]:
            total = op(total, xs[s].to(total.device))
        for s in line:
            res[s] = total.to(devs[s])
    return res


def psum(mesh, axis_name, xs):
    """``lax.psum``: every shard of a line gets the sum of the line's
    values, added in index order (x_0 + x_1, then + x_2, ...)."""
    return _reduce(mesh, axis_name, xs, torch.add)


def pmax(mesh, axis_name, xs):
    """``lax.pmax``: every shard of a line gets the elementwise maximum of
    the line's values (exact in any order; NaN propagates)."""
    return _reduce(mesh, axis_name, xs, torch.maximum)


def tree_map(fn, tree, *others):
    """``fn`` over the tensors of a tensor, a dataclass of tensors (nested
    ones included) or a tuple (a NamedTuple stays one), with the matching
    leaves of ``others``; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *others)
    if isinstance(tree, tuple):
        out = [tree_map(fn, *xs) for xs in zip(tree, *others)]
        return type(tree)(*out) if hasattr(tree, '_fields') else tuple(out)
    return type(tree)(**{
        f.name: tree_map(fn, getattr(tree, f.name),
                         *(getattr(o, f.name) for o in others))
        for f in dataclasses.fields(tree)})


def check_on_mesh(mesh, shards, what='shard'):
    """Raise ValueError unless every tensor of ``shards[k]`` lives on the
    mesh's k-th device (row-major order)."""
    devs = mesh.flat_devices
    if len(shards) != len(devs):
        raise ValueError(f'{what}: {len(shards)} shards for a mesh of '
                         f'{len(devs)}')
    for k, (sh, dev) in enumerate(zip(shards, devs)):
        def on_its_device(x):
            if not on_device(x, dev):
                raise ValueError(f'{what} {k}: a tensor on {x.device}, not '
                                 f'on its mesh device {dev}')
        tree_map(on_its_device, sh)


def member_blocks(mesh, axis_name):
    """(each shard's member-block index, the number of blocks) of a member
    axis cut along ``axis_name``: one mesh axis, or a tuple of them taken
    row-major (JAX's ``P(('data', 'x'))``).  Shards that differ only in
    the other axes hold the same block."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    blocks = [0] * mesh.size
    for name in names:
        idx = axis_index(mesh, name)
        blocks = [b * mesh.shape[name] + i for b, i in zip(blocks, idx)]
    return blocks, math.prod(mesh.shape[n] for n in names)


def shard_members(mesh, axis_name, tree):
    """Cut the leading member axis of every tensor of ``tree`` (a tensor,
    ``ColumnState``, ``GreyForcing``, ``TimeStepInfo``, ...) into
    contiguous blocks along ``axis_name`` (see :func:`member_blocks`):
    shard k gets its block as a contiguous copy of its own on the mesh's
    k-th device.  Raises ValueError when the member count does not divide
    the blocks."""
    blocks, n = member_blocks(mesh, axis_name)
    devs = mesh.flat_devices

    def shard(k):
        def cut(x):
            if x.ndim == 0 or x.shape[0] % n:
                raise ValueError(f'member axis of shape {tuple(x.shape)} not '
                                 f'divisible by {n} shards along '
                                 f'{axis_name!r}')
            m = x.shape[0] // n
            return x[blocks[k] * m:(blocks[k] + 1) * m].to(
                devs[k], copy=True, memory_format=torch.contiguous_format)
        return tree_map(cut, tree)
    return [shard(k) for k in range(mesh.size)]


def gather_members(mesh, axis_name, shards):
    """Inverse of :func:`shard_members`: the member blocks in order (the
    first shard of each), concatenated onto the mesh's first device.
    Raises ValueError if a shard's tensor is not on its mesh device."""
    check_on_mesh(mesh, shards, 'gather_members')
    blocks, n = member_blocks(mesh, axis_name)
    first = {}
    for k, b in enumerate(blocks):
        first.setdefault(b, k)
    dev = mesh.flat_devices[0]
    return tree_map(lambda *xs: torch.cat([x.to(dev) for x in xs]),
                    *[shards[first[b]] for b in range(n)])
