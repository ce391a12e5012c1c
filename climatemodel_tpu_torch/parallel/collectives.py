"""The collectives of a mesh (the port's counterparts of ``lax.ppermute``,
``lax.psum``, ``lax.pmax`` and ``lax.axis_index``).

A sharded value is a list of tensors, one for each of the mesh's
``local_shards`` (``parallel/mesh.py``).  Each collective acts along one
named axis, independently on every line of shards that differ only in
that axis's index, and gives every shard of a line the same value, bit for
bit, under either kind of mesh.  None reads a value back to the host: the
results stay on the shards' devices.

* On a single-controller :class:`~.mesh.Mesh` the process moves the
  values itself, in a stated order: ``ppermute`` by copies, the
  reductions onto the line's first shard and back.
* On a :class:`~.mesh.ProcessMesh` the rank's one shard talks to the
  others through ``torch.distributed`` on its line's group: ``ppermute``
  is one ``batch_isend_irecv`` between line neighbours, and each reduction
  is one ``all_gather`` of the line's values followed by the same
  index-order fold on every rank.  NCCL's and gloo's own ``all_reduce``
  are not used: NCCL adds in an order of its choosing, and gloo's MAX
  drops a NaN that a later rank holds.

Aliasing: on a mesh whose devices repeat, ``x.to(device)`` returns the
sender's own storage.  :func:`ppermute` therefore returns fresh copies, or
writes into the receivers' buffers with ``copy_`` when given ``out``; the
reductions and :func:`all_gather` return one tensor that the shards of a
line share, to be read, never written in place.

A member axis (an ensemble's leading axis) is cut into contiguous blocks
along one mesh axis or several (:func:`shard_members`), each block a copy of
its own on its shard's device, and gathered back (:func:`gather_members`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .mesh import Mesh, on_device


def _ranks(mesh):
    """Whether ``mesh`` is a process mesh (one shard a rank)."""
    return not isinstance(mesh, Mesh)


def axis_lines(mesh, axis_name):
    """Flat shard indices of each line of ``mesh`` along ``axis_name`` (the
    other axes' indices fixed), each line in axis order: every line of the
    mesh, whichever shards this process drives."""
    ax = mesh.axis_names.index(axis_name)
    idx = np.arange(mesh.size).reshape(tuple(mesh.shape.values()))
    return np.moveaxis(idx, ax, -1).reshape(-1, idx.shape[ax]).tolist()


def axis_index(mesh, axis_name, shards=None):
    """The index along ``axis_name`` of each of ``shards`` (flat indices;
    default the local shards), as Python ints (the shard's
    ``lax.axis_index``; static, as in a traced ``shard_map`` body)."""
    every = [0] * mesh.size
    for line in axis_lines(mesh, axis_name):
        for i, s in enumerate(line):
            every[s] = i
    return [every[k] for k in (mesh.local_shards if shards is None
                               else shards)]


def local_lines(mesh, axis_name):
    """``(line, line_mesh, own)`` for each line along ``axis_name`` that
    holds a local shard: its flat shard indices, the 1-D mesh of its shards
    along ``axis_name``, and the positions of its local shards in the
    mesh's local lists (every line of a :class:`Mesh`; the rank's own of a
    process mesh)."""
    pos = {k: i for i, k in enumerate(mesh.local_shards)}
    out = []
    for line in axis_lines(mesh, axis_name):
        own = [pos[k] for k in line if k in pos]
        if not own:
            continue
        if _ranks(mesh):
            line_mesh = mesh.line_mesh(axis_name)
        else:
            line_mesh = Mesh([mesh.flat_devices[k] for k in line],
                             (axis_name,))
        out.append((line, line_mesh, own))
    return out


def _own(mesh, xs, what):
    """The rank's one tensor of ``xs``, on the mesh's device."""
    if len(xs) != 1:
        raise ValueError(f'{what}: {len(xs)} shards for a process mesh '
                         f'(one a rank)')
    x = xs[0]
    if not on_device(x, mesh.device):
        raise ValueError(f'{what}: a {x.device} tensor on a process mesh '
                         f'of {mesh.device}')
    return x


def ppermutes(mesh, axis_name, jobs):
    """Several :func:`ppermute` s along one axis at once: ``jobs`` a list
    of ``(xs, perm)`` or ``(xs, perm, out)``; returns their results in
    order.  On a process mesh every send and receive of every job goes in
    one ``batch_isend_irecv`` (a job's tag its position)."""
    jobs = [tuple(j) + (None,) * (3 - len(j)) for j in jobs]
    if not _ranks(mesh):
        return [_ppermute_local(mesh, axis_name, *j) for j in jobs]
    import torch.distributed as dist
    i = mesh.coords[mesh.axis_names.index(axis_name)]
    peers = mesh.line_ranks(axis_name)
    group = mesh.group(axis_name)
    ops, results, staged = [], [], []
    for tag, (xs, perm, out) in enumerate(jobs):
        x = _own(mesh, xs, 'ppermute')
        src = [s for s, d in perm if d == i]
        dst = [d for s, d in perm if s == i]
        target = None if out is None else out[0]
        got = None
        if src and src[0] == i:                    # the shard's own value
            got = x.clone() if target is None else target.copy_(x)
        elif src:
            got = (target if target is not None and target.is_contiguous()
                   else torch.empty(x.shape, dtype=x.dtype, device=x.device))
            ops.append(dist.P2POp(dist.irecv, got, peers[src[0]], group,
                                  tag))
            if target is not None and got is not target:
                staged.append((target, got))
        if dst and dst[0] != i:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), peers[dst[0]],
                                  group, tag))
        if out is not None:
            results.append(out)
        else:
            results.append([torch.zeros_like(x) if got is None else got])
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for target, buf in staged:
        target.copy_(buf)
    return results


def _ppermute_local(mesh, axis_name, xs, perm, out):
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


def ppermute(mesh, axis_name, xs, perm, out=None):
    """``lax.ppermute``: the shard at index ``dst`` along the axis receives
    the value of the shard at ``src``, for each ``(src, dst)`` in ``perm``.

    :param out: optional list of receiving tensors (e.g. ghost rows of the
        receivers' buffers): each destination is written with ``copy_``,
        the others are left as they are.  Without it, each destination gets
        a fresh copy on its device and every other shard zeros, as in JAX.
    """
    return ppermutes(mesh, axis_name, [(xs, perm, out)])[0]


def _all_gather(x, group):
    """``x`` of every rank of ``group``, in group-rank order, stacked
    [P, *x.shape] on ``x``'s device: one collective."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    flat = x.reshape(-1).contiguous()
    out = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view((n,) + tuple(x.shape))


def _reduce(mesh, axis_name, xs, op):
    if _ranks(mesh):
        x = _own(mesh, xs, 'reduce')
        if mesh.shape[axis_name] == 1:          # a line of one: no message
            return [x]
        parts = _all_gather(x, mesh.group(axis_name))
        total = parts[0]
        for p in parts[1:]:
            total = op(total, p)
        return [total]
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
    the line's values, taken in index order (NaN propagates)."""
    return _reduce(mesh, axis_name, xs, torch.maximum)


def all_gather(mesh, axis_name, xs):
    """``lax.all_gather``: every shard of a line gets the line's values
    stacked [P, ...] in index order, on its own device."""
    if _ranks(mesh):
        return [_all_gather(_own(mesh, xs, 'all_gather'),
                            mesh.group(axis_name))]
    devs = mesh.flat_devices
    res = [None] * len(xs)
    for line in axis_lines(mesh, axis_name):
        stacked = torch.stack([xs[q].to(devs[line[0]]) for q in line])
        for s in line:
            res[s] = stacked.to(devs[s])
    return res


def fetch_shards(mesh, xs, which=None):
    """The tensors of the shards ``which`` (flat indices; default every
    shard) on the first local device, in that order.  On a process mesh
    every shard's tensor travels (one ``all_gather`` over the mesh; the
    shards' tensors of one shape): every rank gets the same list."""
    which = range(mesh.size) if which is None else which
    if _ranks(mesh):
        every = _all_gather(_own(mesh, xs, 'fetch_shards'), mesh.span_group)
        return [every[k] for k in which]
    dev = mesh.local_devices[0]
    return [xs[k].to(dev) for k in which]


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
    device of the mesh's k-th local shard."""
    devs = mesh.local_devices
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
    row-major (JAX's ``P(('data', 'x'))``), for every shard in flat
    order.  Shards that differ only in the other axes hold the same
    block."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    blocks = [0] * mesh.size
    for name in names:
        idx = axis_index(mesh, name, range(mesh.size))
        blocks = [b * mesh.shape[name] + i for b, i in zip(blocks, idx)]
    return blocks, math.prod(mesh.shape[n] for n in names)


def shard_members(mesh, axis_name, tree):
    """Cut the leading member axis of every tensor of ``tree`` (a tensor,
    ``ColumnState``, ``GreyForcing``, ``TimeStepInfo``, ...) into
    contiguous blocks along ``axis_name`` (see :func:`member_blocks`):
    each local shard gets its block as a contiguous copy of its own on its
    device (on a process mesh every rank holds the whole input and cuts its
    own block).  Raises ValueError when the member count does not divide
    the blocks."""
    blocks, n = member_blocks(mesh, axis_name)

    def shard(k, dev):
        def cut(x):
            if x.ndim == 0 or x.shape[0] % n:
                raise ValueError(f'member axis of shape {tuple(x.shape)} not '
                                 f'divisible by {n} shards along '
                                 f'{axis_name!r}')
            m = x.shape[0] // n
            return x[blocks[k] * m:(blocks[k] + 1) * m].to(
                dev, copy=True, memory_format=torch.contiguous_format)
        return tree_map(cut, tree)
    return [shard(k, d) for k, d in zip(mesh.local_shards,
                                        mesh.local_devices)]


def gather_members(mesh, axis_name, shards):
    """Inverse of :func:`shard_members`: the member blocks in order (the
    first shard of each), concatenated onto the first local device (on a
    process mesh, every rank gets the whole ensemble).  Raises ValueError
    if a shard's tensor is not on its mesh device."""
    check_on_mesh(mesh, shards, 'gather_members')
    blocks, n = member_blocks(mesh, axis_name)
    first = {}
    for k, b in enumerate(blocks):
        first.setdefault(b, k)
    which = [first[b] for b in range(n)]
    if not _ranks(mesh):
        shards = [shards[k] for k in which]
        which = range(n)
    return tree_map(lambda *xs: torch.cat(fetch_shards(mesh, xs, which)),
                    *shards)
