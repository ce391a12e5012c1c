"""Member- and band-sharded column ensembles on a mesh.

A JAX user spreads an ensemble over several chips by putting the member
axis of ``models/ensemble.py``'s inputs on a ``NamedSharding``; XLA then
partitions the vmapped march, its kernels included, and a sharded band axis
turns the real-gas band sum into a ``psum``.  The port runs the same
compositions on either kind of mesh (``parallel/mesh.py``): a
single-controller ``Mesh``, whose process marches every shard, or a
``ProcessMesh``, whose rank marches its own; each composition has one
implementation, over the mesh's ``local_shards``:

* dp (members on the mesh): :func:`grey_evolve_ensemble_sharded`,
  :func:`grey_evolve_ensemble_robust_sharded` and
  :func:`real_gas_evolve_ensemble_sharded` cut the member axis into one
  contiguous block per shard (``collectives.shard_members``) and march the
  blocks lock-step, one march per shard on its own device
  (``column.evolve_to_equilibrium_sharded``), each stopping on its own
  flags: the grey march launches K3 on every shard's device.  Members are
  independent, so each member's march is the unsharded one, and no
  collective runs until the gather.
* tp (bands on the mesh): :func:`shard_bands` cuts the band axis of the
  real-gas band arrays and transmission cache; each shard computes the
  partial ``(net, net_diff)`` of its own bands and ``collectives.psum``
  adds them (:func:`real_gas_net_fn_band_sharded`).  The net flux is linear
  in each band's contribution, so the partial sums add up to the one-device
  sum, reassociated.
* dp x tp: :func:`real_gas_evolve_ensemble_sharded` with ``band_axis``:
  each data row marches its members once with the net flux psum'd over
  its band shards (on a single-controller mesh on the row's first device;
  on a process mesh every rank of the row runs the row's march, as the
  replicas of a ``shard_map`` body do); the member axis never
  communicates.

The results are gathered in member order onto the first local device (on
a process mesh, every rank gets them all).  Every shard's tensors are
copies of their own on its mesh device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import column
from ..models import ensemble as ens
from ..models import real_gas as prg
from . import collectives as col


def _replicate(mesh, tree):
    """A copy of ``tree`` of its own on every local shard's device."""
    return [col.tree_map(lambda x: x.to(d, copy=True), tree)
            for d in mesh.local_devices]


def _check_members_span(mesh, axis_name):
    _, n = col.member_blocks(mesh, axis_name)
    if n != mesh.size:
        raise ValueError(
            f'members cut along {axis_name!r} make {n} blocks for a mesh of '
            f'{mesh.size} shards {mesh.shape}: name every mesh axis (a tuple '
            f'of names) or pass band_axis')


def _per_shard(mesh, axis_name, x):
    """A float stays one; a tensor with a member axis is cut per shard."""
    if isinstance(x, torch.Tensor) and x.ndim > 0:
        return col.shard_members(mesh, axis_name, x)
    return x


def _record(telemetry, **fields):
    if telemetry is not None:
        telemetry.update(fields)


def _member_offsets(mesh, axis_name, n_members):
    """Each local shard's first member in the whole ensemble (for the
    debug march's messages)."""
    blocks, n = col.member_blocks(mesh, axis_name)
    return [blocks[k] * (n_members // n) for k in mesh.local_shards]


# --------------------------------------------------------------------------
# grey ensembles, members on the mesh (dp)
# --------------------------------------------------------------------------

def grey_evolve_ensemble_sharded(mesh, states, forcings, p_interface,
                                 p_centre_col, flux_thresh, axis_name='data',
                                 fused_stats=True, net_flux_percentile=95,
                                 telemetry=None, **march_kw):
    """:func:`models.ensemble.grey_evolve_ensemble` with the member axis
    cut along ``axis_name`` (one mesh axis, or a tuple of them spanning the
    mesh): each shard marches its block on its own device, lock-step with
    the others.

    :param march_kw: the other keywords of ``grey_evolve_ensemble``
        (``convective_adjust`` with ``conv_method`` 'reference' or
        'isotonic', ``check_every``, ``max_steps``, ...).
    :param telemetry: optional dict; gets ``iterations``, the lock-step
        iterations each local shard ran (its K3 launches on the fused
        path).
    :return: (ColumnState, EquilibriumInfo) of every member in member
        order, on the first local device.
    """
    _check_members_span(mesh, axis_name)
    st_s = col.shard_members(mesh, axis_name, states)
    fo_s = col.shard_members(mesh, axis_name, forcings)
    fns = [ens.grey_march_fns(fo, st.net_flux.shape, fused_stats,
                              net_flux_percentile)
           for st, fo in zip(st_s, fo_s)]
    outs, iterations = column.evolve_to_equilibrium_sharded(
        st_s, [f[0] for f in fns], _replicate(mesh, p_interface),
        _replicate(mesh, p_centre_col), net_stats_fns=[f[1] for f in fns],
        flux_thresh=_per_shard(mesh, axis_name, flux_thresh),
        net_flux_percentile=net_flux_percentile,
        member_offsets=_member_offsets(mesh, axis_name, states.T.shape[0]),
        n_members=states.T.shape[0], **march_kw)
    _record(telemetry, iterations=iterations)
    return (col.gather_members(mesh, axis_name, [o[0] for o in outs]),
            col.gather_members(mesh, axis_name, [o[1] for o in outs]))


def grey_finish_unconverged_f64_sharded(mesh, fs, info, forcings,
                                        p_interface, p_centre_col,
                                        flux_thresh, axis_name='data',
                                        finish_repeats: int = 8,
                                        finish_max_steps: int = 1_000,
                                        telemetry=None, **march_kw):
    """:func:`models.ensemble.grey_finish_unconverged_f64` under a member
    sharding: every local shard re-marches its own timed-out members in f64
    on its own device, one shard after the other.

    :return: (states, info, finished) in member order; ``finished`` holds
        the global indices of the members the f64 pass completed.
        ``telemetry`` gets ``finished``, each local shard's count.
    """
    _check_members_span(mesh, axis_name)
    shards = zip(*(col.shard_members(mesh, axis_name, x)
                   for x in (fs, info, forcings)),
                 _replicate(mesh, p_interface), _replicate(mesh, p_centre_col))
    done, finished = [], []
    for fs_k, info_k, fo_k, p_i, p_c in shards:
        fs_k, info_k, fin = ens.grey_finish_unconverged_f64(
            fs_k, info_k, fo_k, p_i, p_c, flux_thresh,
            finish_repeats=finish_repeats, finish_max_steps=finish_max_steps,
            **march_kw)
        done.append((fs_k, info_k))
        mask = torch.zeros(fs_k.T.shape[0], dtype=torch.bool,
                           device=fs_k.T.device)
        mask[torch.as_tensor(fin, device=mask.device)] = True
        finished.append(mask)
    _record(telemetry, finished=[int(m.sum()) for m in finished])
    mask = col.gather_members(mesh, axis_name, finished)
    return (col.gather_members(mesh, axis_name, [d[0] for d in done]),
            col.gather_members(mesh, axis_name, [d[1] for d in done]),
            np.flatnonzero(mask.cpu().numpy()))


def grey_evolve_ensemble_robust_sharded(mesh, states, forcings,
                                        p_interface, p_centre_col,
                                        flux_thresh, axis_name='data',
                                        finish_repeats: int = 8,
                                        finish_max_steps: int = 1_000,
                                        telemetry=None, **march_kw):
    """:func:`models.ensemble.grey_evolve_ensemble_robust` under a member
    sharding: :func:`grey_evolve_ensemble_sharded`, then
    :func:`grey_finish_unconverged_f64_sharded`.

    :return: (states, info, finished) in member order, ``finished`` the
        global indices of the members the f64 pass completed;
        ``telemetry`` gets the march's ``iterations`` and the finish's
        ``finished``.
    """
    fs, info = grey_evolve_ensemble_sharded(
        mesh, states, forcings, p_interface, p_centre_col, flux_thresh,
        axis_name, telemetry=telemetry, **march_kw)
    return grey_finish_unconverged_f64_sharded(
        mesh, fs, info, forcings, p_interface, p_centre_col, flux_thresh,
        axis_name, finish_repeats=finish_repeats,
        finish_max_steps=finish_max_steps, telemetry=telemetry, **march_kw)


# --------------------------------------------------------------------------
# real gas: bands on the mesh (tp)
# --------------------------------------------------------------------------

def shard_bands(mesh, axis_name, ba: prg.BandArrays,
                cache: prg.TransmissionCache, F_star_factor, delta):
    """Cut the band axis of the band arrays, the transmission cache, the
    stellar factor ([..., n_bands]) and ``delta`` into contiguous slices
    along ``axis_name``; shards on other mesh axes get copies.

    The long-wave bands are a subset (``ba.lw_list`` indexes the band
    axis): each shard keeps the long-wave bands of its own slice, with
    ``lw_list`` remapped to local indices, and their rows of the cache's
    [L, ...] fields.  A shard without a long-wave band keeps none.

    :return: lists over the local shards (bas, caches, F_star_factors,
        deltas).
    """
    n = mesh.shape[axis_name]
    nb = ba.idx.shape[0]
    if nb % n:
        raise ValueError(f'{nb} bands not divisible by {n} shards along '
                         f'{axis_name!r}')
    m = nb // n
    lw = ba.lw_list
    out = ([], [], [], [])
    for i, dev in zip(col.axis_index(mesh, axis_name), mesh.local_devices):
        lo, hi = i * m, (i + 1) * m
        own = (lw >= lo) & (lw < hi)

        def bands(x, axis=0):
            return x.narrow(axis, lo, m).to(
                dev, copy=True, memory_format=torch.contiguous_format)

        def lws(x):
            return None if x is None else x[own].to(dev, copy=True)

        def rep(x):
            return x.to(dev, copy=True)
        out[0].append(prg.BandArrays(
            idx=bands(ba.idx), w=bands(ba.w), delta=bands(ba.delta),
            centre=bands(ba.centre), lw_idx=lws(ba.lw_idx),
            lw_w=lws(ba.lw_w), lw_delta=lws(ba.lw_delta),
            lw_centre=lws(ba.lw_centre), lw_list=(lw[own] - lo).to(dev),
            W_up=rep(ba.W_up), W_down=rep(ba.W_down), S=rep(ba.S),
            dp_int=rep(ba.dp_int)))
        out[1].append(prg.TransmissionCache(
            att_up=bands(cache.att_up), att_down=bands(cache.att_down),
            **{name: lws(getattr(cache, name)) for name in (
                'M_up', 'M_down', 'lo_up', 'sf_up', 'toa_down', 'hi_down',
                'M_sum', 'D_sum', 'row0_sum')}))
        out[2].append(bands(F_star_factor, F_star_factor.ndim - 1))
        out[3].append(bands(delta))
    return out


def real_gas_net_fn_band_sharded(mesh, axis_name, T_gs, caches, bas,
                                 F_star_factors, deltas):
    """The march's net flux function with the bands sharded along
    ``axis_name`` of a 1-D ``mesh`` (the band shards of one data row):
    T [B, nz-1, 1] on the first local device -> (net [B, nz, 1],
    net_diff [B, nz-1, 1]) there.  Each local shard computes its bands'
    partial ``real_gas_net_and_diff_cached`` on its own device, and
    ``psum`` adds the partials in shard order (the net and its difference
    in one collective): deterministic, but not bit-equal to the one-device
    band sum.

    :param T_gs, caches, bas, F_star_factors, deltas: lists over the local
        shards (:func:`shard_bands`, and the ground temperatures [B] on
        every shard's device).
    """
    col.check_on_mesh(mesh, list(zip(T_gs, caches, bas, F_star_factors,
                                     deltas)), 'band shard')
    devs = mesh.local_devices
    shards = list(zip(devs, T_gs, caches, bas, F_star_factors, deltas))

    def net_fn(T):
        parts = [prg.real_gas_net_and_diff_cached(T[..., 0].to(d), *rest)
                 for d, *rest in shards]
        nz = parts[0][0].shape[-1]
        both = col.psum(mesh, axis_name, [torch.cat(p, -1) for p in parts])[0]
        return both[..., :nz, None], both[..., nz:, None]
    return net_fn


# --------------------------------------------------------------------------
# real-gas ensembles: dp, and dp x tp
# --------------------------------------------------------------------------

def real_gas_evolve_ensemble_sharded(mesh, states, F_scales, T_gs,
                                     tau_interface, ba, F_star_factor, delta,
                                     p_interface, p_centre_col, flux_thresh,
                                     member_axis='data', band_axis=None,
                                     stacked_tau=False, cache_dtype=None,
                                     cache=None, telemetry=None, **march_kw):
    """:func:`models.ensemble.real_gas_evolve_ensemble` on a mesh.

    ``band_axis=None`` (dp): the members are cut along ``member_axis`` (a
    name or a tuple spanning the mesh) and every shard marches its block.
    The shared cache is folded once on ``tau_interface``'s device (or taken
    from ``cache``) and copied to every shard; with ``stacked_tau`` each
    shard folds its own members' caches.

    ``band_axis='x'`` (dp x tp) on a mesh of the two axes: each
    ``member_axis`` row marches its members once, on the row's first local
    device, with the net flux of each step summed over the row's band
    shards (:func:`real_gas_net_fn_band_sharded`); every row runs its own
    controller on that summed flux (on a process mesh, every rank of the
    row runs it, on the same values).

    :param march_kw: the other keywords of ``real_gas_evolve_ensemble``
        (``convective_adjust``, ``t_end``, ``max_steps``, ``check_every``,
        ...).
    :param telemetry: optional dict; gets ``iterations``, the lock-step
        iterations of each local march (a shard's for dp, a row's for
        dp x tp).
    :return: (states, EquilibriumInfo) in member order on the first local
        device.
    """
    march_kw = dict(march_kw, p_descending=False)
    if band_axis is None:
        _check_members_span(mesh, member_axis)
        shard = lambda x: col.shard_members(mesh, member_axis, x)  # noqa
        st_s, sc_s, tg_s = shard(states), shard(F_scales), shard(T_gs)
        ba_s = _replicate(mesh, ba)
        if stacked_tau:
            cache_s = (shard(cache) if cache is not None else [
                prg.stack_caches([prg.precompute_transmission(t, b,
                                                              cache_dtype)
                                  for t in taus])
                for taus, b in zip(shard(tau_interface), ba_s)])
        else:
            cache_s = _replicate(mesh, cache if cache is not None else
                                 prg.precompute_transmission(
                                     tau_interface, ba, cache_dtype))
        F_s = [F[None, :] * sc[:, None]
               for F, sc in zip(_replicate(mesh, F_star_factor), sc_s)]
        fns = [prg.real_gas_net_fn(tg, c, b, F, dl) for tg, c, b, F, dl in
               zip(tg_s, cache_s, ba_s, F_s, _replicate(mesh, delta))]
        outs, iterations = column.evolve_to_equilibrium_sharded(
            st_s, fns, _replicate(mesh, p_interface),
            _replicate(mesh, p_centre_col),
            flux_thresh=_per_shard(mesh, member_axis, flux_thresh),
            **march_kw)
        _record(telemetry, iterations=iterations)
        return (col.gather_members(mesh, member_axis, [o[0] for o in outs]),
                col.gather_members(mesh, member_axis, [o[1] for o in outs]))

    if stacked_tau:
        raise ValueError('stacked_tau takes the members on the mesh '
                         '(band_axis=None): a stacked cache has no shared '
                         'band axis to cut')
    if set(mesh.axis_names) != {member_axis, band_axis}:
        raise ValueError(f'dp x tp needs a mesh of the axes '
                         f'({member_axis!r}, {band_axis!r}), got '
                         f'{mesh.axis_names}')
    if cache is None:
        cache = prg.precompute_transmission(tau_interface, ba, cache_dtype)
    ba_s, cache_s, Fs_s, delta_s = shard_bands(mesh, band_axis, ba, cache,
                                               F_star_factor, delta)
    st_s = col.shard_members(mesh, member_axis, states)
    sc_s = col.shard_members(mesh, member_axis, F_scales)
    tg_s = col.shard_members(mesh, member_axis, T_gs)
    devs = mesh.local_devices
    fns, lead = [], []                   # one march a row, in member order
    for _, row_mesh, own in col.local_lines(mesh, band_axis):
        fns.append(real_gas_net_fn_band_sharded(
            row_mesh, band_axis, [tg_s[i] for i in own],
            [cache_s[i] for i in own], [ba_s[i] for i in own],
            [Fs_s[i][None, :] * sc_s[i][:, None] for i in own],
            [delta_s[i] for i in own]))
        lead.append(own[0])
    flux_thresh = _per_shard(mesh, member_axis, flux_thresh)
    outs, iterations = column.evolve_to_equilibrium_sharded(
        [st_s[i] for i in lead], fns,
        [p_interface.to(devs[i], copy=True) for i in lead],
        [p_centre_col.to(devs[i], copy=True) for i in lead],
        flux_thresh=([flux_thresh[i] for i in lead]
                     if isinstance(flux_thresh, list) else flux_thresh),
        **march_kw)
    _record(telemetry, iterations=iterations)
    # the rows' leads: the line along the member axis through the first
    # local shard
    _, lead_mesh, _ = col.local_lines(mesh, member_axis)[0]
    return (col.gather_members(lead_mesh, member_axis, [o[0] for o in outs]),
            col.gather_members(lead_mesh, member_axis, [o[1] for o in outs]))
