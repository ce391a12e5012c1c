"""State checkpoint/restore (port of ``climatemodel_tpu/utils/checkpoint.py``).

A state is a tree of tensors (a dataclass such as ``ColumnState`` or
``SWState``, possibly nested, or tuples, lists and dicts of them), so a
checkpoint is exact: save the leaves, restore them into a template of the
same structure, and feed the state back into the march — a bitwise resume.

The file is the JAX package's npz layout: ``n_leaves`` and ``leaf_0`` ...
``leaf_{n-1}``, the leaves in JAX's flatten order (dataclass fields in
declaration order, depth first; dict entries by sorted key; None is no
leaf).  A file written by either package loads in the other.  The
``'orbax'`` backend is the JAX package's; here it warns and writes npz, as
the JAX package does on a machine without orbax.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch


def tree_flatten(tree):
    """(leaves, rebuild): the leaves in JAX's flatten order and a function
    that builds the same structure from a list of new leaves."""
    if tree is None:
        return [], lambda leaves: None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        parts = [tree_flatten(getattr(tree, k)) for k in names]

        def rebuild(leaves):
            return type(tree)(**dict(zip(names, _rebuild_parts(parts, leaves))))
        return [x for p in parts for x in p[0]], rebuild
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([x for p in parts for x in p[0]],
                lambda leaves: dict(zip(keys, _rebuild_parts(parts, leaves))))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(v) for v in tree]
        return ([x for p in parts for x in p[0]],
                lambda leaves: type(tree)(_rebuild_parts(parts, leaves)))
    return [tree], lambda leaves: leaves[0]


def _rebuild_parts(parts, leaves):
    out, i = [], 0
    for sub_leaves, rebuild in parts:
        n = len(sub_leaves)
        out.append(rebuild(leaves[i:i + n]))
        i += n
    return out


def _to_numpy(leaf):
    if torch.is_tensor(leaf):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:      # NumPy has no bfloat16: exact
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path, tree, backend='npz', async_save=False):
    """Save a tree of tensors (ColumnState, SWState, ...) to ``path``
    (``.npz`` is appended where missing), in one host copy per leaf.

    :param backend: 'npz'; 'orbax' warns and writes npz.
    :param async_save: orbax only in the JAX package; the npz write is
        synchronous.
    """
    del async_save
    if backend == 'orbax':
        warnings.warn('orbax-checkpoint unavailable; falling back to npz')
    leaves, _ = tree_flatten(tree)
    np.savez(path, n_leaves=len(leaves),
             **{f'leaf_{i}': _to_numpy(leaf) for i, leaf in enumerate(leaves)})


def wait_for_saves():
    """Block until every pending save has committed.  The port's npz saves
    are synchronous (``save_pytree`` returns once the file is written), so
    nothing is ever pending and this returns at once; it exists so that
    callers of the JAX package's ``wait_for_saves`` (which waits for async
    orbax saves) run unchanged."""


def _like(a, template):
    """File leaf ``a`` in the template leaf's dtype, device and shape; a
    single-world leaf (a JAX ``GreyGas.state``) gains the batch axis of one
    of the port's batched template."""
    shape = tuple(template.shape) if hasattr(template, 'shape') else ()
    if a.shape != shape:
        if shape != (1,) + a.shape:
            raise ValueError(f'leaf of shape {a.shape} does not fit the '
                             f'template leaf of shape {shape}')
        a = a[None]
    if torch.is_tensor(template):
        return torch.from_numpy(np.array(a)).to(
            device=template.device, dtype=template.dtype)
    return np.asarray(a, dtype=np.asarray(template).dtype)


def load_pytree(path, template, backend='npz'):
    """Restore a tree saved by :func:`save_pytree` (by either package) into
    the structure of ``template``, each leaf in the template leaf's dtype
    and on its device.

    :param backend: 'npz'; 'orbax' warns and reads npz.
    """
    if backend == 'orbax':
        warnings.warn('orbax-checkpoint unavailable; falling back to npz')
    path = str(path)
    if not path.endswith('.npz'):
        path += '.npz'
    t_leaves, rebuild = tree_flatten(template)
    with np.load(path) as data:
        n = int(data['n_leaves'])
        if len(t_leaves) != n:
            raise ValueError(f'template has {len(t_leaves)} leaves, file '
                             f'has {n}')
        return rebuild([_like(data[f'leaf_{i}'], t)
                        for i, t in enumerate(t_leaves)])
