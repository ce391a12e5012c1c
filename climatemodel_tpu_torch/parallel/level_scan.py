"""Level-axis (pipeline-parallel analogue) sharding of the flux recurrence
(port of ``climatemodel_tpu/parallel/level_scan.py``).

The grey long-wave flux is a first-order affine recurrence over pressure
levels (reference GreyGas.get_lw_flux, grey.py:251-275), evaluated on one
device as a log-depth scan (``ops/two_stream.affine_scan``).  Sharded, the
recurrence splits into contiguous level blocks, one per shard, and the carry
flows shard to shard (classic block-scan pipeline):

1. each shard runs the associative scan over its block (in
   ``lax.associative_scan``'s order) and reduces the block to its affine
   summary ``(A[-1], B[-1])``;
2. the carry ``x`` enters at shard 0 and passes down the shard chain, shard
   k forwarding ``A_tot * x + B_tot`` to shard k+1.  Here the summaries
   travel in one ``all_gather`` over the line and each shard folds the
   carry through the blocks before its own, in chain order: the same
   arithmetic as the JAX package's ``n_shards - 1`` sequential hops, in one
   collective;
3. each shard applies its carry to its prefix scan, ``A x + B``, and the
   blocks are gathered in level order.

The O(n_levels) scan work of steps 1 and 3 stays parallel.  The result
equals the one-device scan up to the float reassociation of the block
boundaries.  It runs on either kind of mesh (``parallel/mesh.py``).  No
kernel: the JAX package computes this with jnp too.
"""
from __future__ import annotations

import torch

from ..ops.two_stream import _associative_scan, _source
from . import collectives as col


def sharded_affine_scan(a, b, x0, mesh, axis_name, reverse=False,
                        batch_axis_name=None):
    """Solve x_{k+1} = a_k x_k + b_k with the level axis (axis 0) sharded.

    Mirrors :func:`climatemodel_tpu_torch.ops.two_stream.affine_scan` (same
    signature + mesh): returns ``[n+1, ...]`` on ``a``'s device with element
    0 (or n when ``reverse``) equal to ``x0``.  Axis 0 of ``a``/``b`` must
    divide evenly by ``mesh.shape[axis_name]``.

    ``batch_axis_name`` optionally shards axis 1 (the batch/member axis)
    over a SECOND mesh axis — the composed dp x pp layout: each data-shard
    of members runs its own carry pipeline over the level axis, and the
    hops act within the data slice.  Axis 1 must then divide by
    ``mesh.shape[batch_axis_name]``.  Shards that differ only in another
    mesh axis compute the same blocks, as replicas do under ``shard_map``.
    """
    n_dev = int(mesh.shape[axis_name])
    n = a.shape[0]
    if n % n_dev:
        raise ValueError(f'level count {n} not divisible by {n_dev} devices')
    if batch_axis_name is not None:
        if a.ndim < 2:
            raise ValueError('batch_axis_name needs a batch axis (a.ndim>=2)')
        if a.shape[1] % int(mesh.shape[batch_axis_name]):
            raise ValueError(
                f'batch {a.shape[1]} not divisible by '
                f'{mesh.shape[batch_axis_name]} devices')
    if reverse:
        a = torch.flip(a, (0,))
        b = torch.flip(b, (0,))
    x0 = torch.broadcast_to(torch.as_tensor(x0, device=a.device),
                            a.shape[1:]).to(a.dtype)
    devs = mesh.local_devices
    n_lev = n // n_dev
    levels = col.axis_index(mesh, axis_name)
    if batch_axis_name is None:
        bat = [0] * len(devs)
        bat_every = [0] * mesh.size
    else:
        bat = col.axis_index(mesh, batch_axis_name)
        bat_every = col.axis_index(mesh, batch_axis_name,
                                   range(mesh.size))
        n_bat = a.shape[1] // int(mesh.shape[batch_axis_name])

    def block(x, level, j):
        x = x[level * n_lev:(level + 1) * n_lev]
        return x if batch_axis_name is None else \
            x[:, j * n_bat:(j + 1) * n_bat]

    scans = [_associative_scan(block(a, lev, j).to(d, copy=True),
                               block(b, lev, j).to(d, copy=True))
             for lev, j, d in zip(levels, bat, devs)]
    # every block's summary (A_tot, B_tot), in level order along the line
    summaries = col.all_gather(mesh, axis_name, [
        torch.stack([A[-1], B[-1]]) for A, B in scans])
    done = []
    for (A, B), lev, j, d, summ in zip(scans, levels, bat, devs, summaries):
        x = (x0 if batch_axis_name is None else
             x0[j * n_bat:(j + 1) * n_bat]).to(d)
        for A_tot, B_tot in summ[:lev]:       # the chain's hops, in order
            x = A_tot * x + B_tot
        done.append(A * x + B)
    every = col.fetch_shards(mesh, done)
    columns = {}          # batch block -> its [n, ...] levels on a's device
    for line in col.axis_lines(mesh, axis_name):
        j = bat_every[line[0]]
        if j not in columns:
            columns[j] = torch.cat([every[s].to(a.device) for s in line], 0)
    xs = torch.cat([columns[j] for j in sorted(columns)], 1) \
        if batch_axis_name is not None else columns[0]
    out = torch.cat([x0[None], xs], 0)
    if reverse:
        out = torch.flip(out, (0,))
    return out


def lw_flux_level_sharded(T, dtau, up_flux_toa, mesh, axis_name,
                          surface_first=True, batch_axis_name=None):
    """Grey lw up/down fluxes with the LEVEL axis sharded over ``axis_name``
    (pp analogue) — mirrors :func:`ops.two_stream.lw_flux` (which cites
    grey.py:251-275).  Both streams ride one pipelined scan via a trailing
    channel axis."""
    dtau = torch.as_tensor(dtau, dtype=T.dtype, device=T.device)
    while dtau.ndim < T.ndim:                 # column-shared dtau, like lw_flux
        dtau = dtau[..., None]
    dtau = torch.broadcast_to(dtau, T.shape)
    e_plus = torch.exp(dtau)
    e_minus = torch.exp(-dtau)
    source = _source(T)
    # trailing channel axis (0 = up, 1 = down) keeps axis 0 = levels shardable
    a = torch.stack([e_plus, e_minus], -1)
    b = torch.stack([source * (1.0 - e_plus), source * (1.0 - e_minus)], -1)
    up0 = torch.broadcast_to(torch.as_tensor(up_flux_toa, dtype=T.dtype,
                                             device=T.device), T.shape[1:])
    x_toa = torch.stack([up0, torch.zeros_like(up0)], -1)
    flux = sharded_affine_scan(a, b, x_toa, mesh, axis_name,
                               reverse=surface_first,
                               batch_axis_name=batch_axis_name)
    return flux[..., 0], flux[..., 1]
