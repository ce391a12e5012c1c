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
"""
from __future__ import annotations

import numpy as np
import torch


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
