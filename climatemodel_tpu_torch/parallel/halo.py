"""Sharded shallow-water stepping: spatial domain decomposition over a device
mesh with ring halo exchange (port of ``climatemodel_tpu/parallel/halo.py``).

The reference's ghost-cell boundary conditions (shallow_water.py:393-444 of
the NumPy original) become a one-row halo exchange between x-neighbouring
shards (``collectives.ppermute``); the global reductions (the CFL max, the
El Nino boundary-average wind closure) become ``pmax``/``psum`` over the
mesh axis.  Each composition runs unchanged on either kind of mesh
(``parallel/mesh.py``): one process driving every shard, or one rank a
shard with the collectives through ``torch.distributed``; its loops go over
the mesh's local shards.  Every per-step scalar stays on the device (on a
process mesh every rank computes the same dt from the same ``pmax``), and a
run reads one value back, ``ok``, at its end.

Representation (plain-stencil paths): shards hold interior-x blocks
[nx_i/P, ny] (1-D) or interior blocks [nx_i/Px, ny_i/Py] (2-D), and rebuild
their ghost layers every step from the halo and the physical boundary rules.
Static geometry (Coriolis, orography) is pre-padded per shard on the host so
the ghost values match the unsharded model exactly.  Of the four schemes only
maccormack reads ghost corners: the 1-D decomposition reproduces the
reference's periodic-y corner rules (the ``f[-1,-1] = f[-2,-1]`` quirk
included) on the edge shards, the 2-D decomposition fixes the four global
corners through a y-ring exchange between the corner shards.  The El Nino
wind closure's ghost-inclusive boundary averages fold the ghost cells' mask
weights onto their source cells, corner rules included.

``numerical_solver='richtmyer_pallas'``: the 1-D decomposition runs the fused
Richtmyer kernel (K6) per shard in its ``bx='given'`` mode.  Each shard holds
its three fields with their two x ghost rows, [3, nx_i/P + 2, ny]; every step
the halo fills those rows from the ring neighbours (the wall rules at the
global edges), the kernel does the rest (y walls, damping, the abort freeze
and max(u^2+v^2)), then the wind from the psum'd masked sums.  Eligible:
nonlinear, walls-y and an interior nx divisible by the shards; anything
else takes the plain stencils with a UserWarning.

Two faults of the JAX package are not copied.  Its scans seed ``ok`` with
True and freeze a step on that step's own ``dt >= 10`` (F4): here ``ok`` is
seeded from the world's state and a step freezes on the carried flag, as
the unsharded model does, so a resumed aborted world does not step.  Its
2-D decomposition swaps ``richtmyer_pallas`` for the plain ``richtmyer``
silently (F5): here the swap warns.

Aliasing rule: on a mesh whose devices repeat, no shard's tensor is ever a
view of another's.  The halo writes the receiving rows with ``copy_``, and
every split of the world's state is a copy.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..models import shallow_water as sw
from ..ops import stencils
from . import collectives as col


def _ring_perms(n):
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    return fwd, bwd


def _pad_axis(mesh, mesh_axis, fs, boundary, array_axis, wall_value=None):
    """Reconstruct one array axis's ghost layer of every shard's block via
    ring halo exchange over a mesh axis, applying the physical boundary rule
    at the global edges.

    :param fs: per-shard blocks without that axis's ghost layer.
    :param wall_value: None -> a wall ghost copies the adjacent own row (h,
        and the tangential velocity); a float -> the ghost is that value
        (the normal velocity at walls).
    :return: per-shard blocks with the ghost layer (new tensors).
    """
    n = mesh.shape[mesh_axis]
    fwd, bwd = _ring_perms(n)
    edge = ((lambda f: f[:1], lambda f: f[-1:]) if array_axis == 0 else
            (lambda f: f[:, :1], lambda f: f[:, -1:]))

    def wall(own):
        return own if wall_value is None else torch.full_like(own, wall_value)
    from_lo, from_hi = col.ppermutes(mesh, mesh_axis, [
        ([edge[1](f) for f in fs], fwd), ([edge[0](f) for f in fs], bwd)])
    out = []
    for f, i, lo, hi in zip(fs, col.axis_index(mesh, mesh_axis), from_lo,
                            from_hi):
        if boundary == 'walls':
            if i == 0:
                lo = wall(edge[0](f))
            if i == n - 1:
                hi = wall(edge[1](f))
        elif boundary != 'periodic':
            raise ValueError(f'unknown boundary {boundary!r}')
        out.append(torch.cat([lo, f, hi], array_axis))
    return out


def _wind_stress(wind_type, t, tau0, fluct, forced):
    """Compose the wind stress from its parts (shallow_water.py:272-308 /
    el_nino_seasonal_wind); shared by the 1-D and 2-D sharded steps."""
    if wind_type == 'forced':
        return forced
    t_year = 365 * 24 * 60 ** 2
    seasonal = fluct * torch.sin(t * 2 * math.pi / t_year)
    if wind_type == 'seasonal':
        return tau0 + seasonal
    if wind_type == 'seasonal_forced':
        return forced + seasonal
    raise ValueError(f'wind type {wind_type!r} not valid')


def _fix_corners_periodic_y(mesh, axis_name, fps):
    """Reference periodic-y ghost-CORNER rules on the global-edge shards
    (shallow_water.py:428-436, applied after the x rules so they win), in
    place on the padded blocks: f[0,0]=f[1,-2], f[0,-1]=f[1,1],
    f[-1,0]=f[-2,-2], and the reference's own quirk f[-1,-1]=f[-2,-1]
    (whose value per_y already set to f[-2,1]).  Middle shards' padded rows
    are interior rows whose y-ghost cells follow the plain per_y rule — the
    halo already carries those."""
    n = mesh.shape[axis_name]
    for fp, i in zip(fps, col.axis_index(mesh, axis_name)):
        L = fp.shape[0] - 2
        if i == 0:
            fp[0, 0] = fp[1, -2]
            fp[0, -1] = fp[1, 1]
        if i == n - 1:
            fp[L + 1, 0] = fp[L, -2]
            fp[L + 1, -1] = fp[L, -1]
    return fps


def _fix_corners_periodic_y_2d(mesh, fps, fs, ax_x, ax_y):
    """Reference periodic-y ghost-corner rules at the four GLOBAL corners of a
    2-D decomposition (shallow_water.py:428-436, applied after the x rules so
    they win), in place: f[0,0]=f[1,-2], f[-1,0]=f[-2,-2], f[0,-1]=f[1,1] and
    the quirk f[-1,-1]=f[-2,-1] (whose value the y edge rule already set to
    f[-2,1]).  Every source is an interior cell of the same-x shard at the
    OPPOSITE global y edge, so the corner shards exchange one value over the
    y ring (two ppermutes per x side).  Interior seam corners need no fixing:
    padding y before x transports the diagonal neighbours' values exactly.

    :param fps: per-shard [lx+2, ly+2] padded blocks.
    :param fs: per-shard [lx, ly] interior blocks.
    """
    n_y, n_x = mesh.shape[ax_y], mesh.shape[ax_x]
    js = col.axis_index(mesh, ax_y)
    is_ = col.axis_index(mesh, ax_x)
    fwd, bwd = _ring_perms(n_y)

    def fix_side(xi, xg, edge):
        from_hi, from_lo = col.ppermutes(mesh, ax_y, [
            ([f[xi, -1] for f in fs], fwd), ([f[xi, 0] for f in fs], bwd)])
        for fp, i, j, hi, lo in zip(fps, is_, js, from_hi, from_lo):
            if i == edge and j == 0:          # j=0 <- j=n_y-1
                fp[xg, 0] = hi
            if i == edge and j == n_y - 1:    # j=n_y-1 <- j=0
                fp[xg, -1] = lo

    fix_side(0, 0, 0)                 # global x-lo ghost row
    fix_side(-1, -1, n_x - 1)         # global x-hi ghost row
    return fps


def _apply_y_bc(h, u, v, by):
    """Local y boundary conditions on the ghost cells (shallow_water.py:
    427-443), on copies.  Works on interior-x blocks: every row applies the
    same rule."""
    h, u, v = h.clone(), u.clone(), v.clone()
    if by == 'periodic':
        for f in (h, u, v):
            f[:, 0] = f[:, -2]
            f[:, -1] = f[:, 1]
        return h, u, v
    if by == 'walls':
        v[:, 0] = 0.0
        v[:, -1] = 0.0
        for f in (h, u):
            f[:, 0] = f[:, 1]
            f[:, -1] = f[:, -2]
        return h, u, v
    raise ValueError(f'unknown y boundary {by!r}')


def _scheme_step(solver, linear, hp, up, vp, f_cor_pad, h_base_pad, g,
                 h_mean, dx, dy, dt):
    """One plain scheme step on a padded block: the new conservative U."""
    U = sw.get_conservative_form(hp, up, vp, linear)
    flux_x = sw.make_flux_x(g, h_mean, linear)
    flux_y = sw.make_flux_y(g, h_mean, linear)
    source = sw.make_source(g, f_cor_pad, h_base_pad, dx, dy, linear)
    if solver == 'lax_wendroff':
        return stencils.lax_wendroff(U, flux_x, flux_y, source, dt, dx, dy,
                                     [0], hp.shape[0], hp.shape[1],
                                     sw.make_jacobian_x(g),
                                     sw.make_jacobian_y(g))
    return stencils.SCHEMES[solver](U, flux_x, flux_y, source, dt, dx, dy,
                                    [0])


def make_sharded_step(mesh, axis_name='x', solver='richtmyer',
                      linear=False, bx='periodic', by='walls', wind_type=None,
                      target_courant=0.1):
    """Build the sharded step: a function of lists over the local shards
    (the shard values) and replicated 0-d tensors on the first local
    shard's device.

    ``step(hs, us, vs, t, dt_prev, ok, dt0, f_cor_pad, h_base_pad, r_int, g,
    h_mean, dx, dy, wind_gamma, wind_tau0, wind_fluct, east_w, west_w)``
    returns ``(hs, us, vs, t + dt, dt, ok)``; ``ok`` is the carried abort
    flag and a step freezes on it.
    """
    devs = mesh.local_devices

    def step(hs, us, vs, t, dt_prev, ok, dt0, f_cor_pad, h_base_pad, r_int,
             g, h_mean, dx, dy, wind_gamma, wind_tau0, wind_fluct, east_w,
             west_w):
        # global CFL (max over all shards; ghost copies never exceed interior)
        max2 = col.pmax(mesh, axis_name,
                        [torch.max(u * u + v * v) for u, v in zip(us, vs)])
        dt, ok = sw.cfl_dt(max2[0], t, dt_prev, ok, dt0, dx, dy,
                           target_courant)

        hps = _pad_axis(mesh, axis_name, hs, bx, 0)
        ups = _pad_axis(mesh, axis_name, us, bx, 0,
                        wall_value=0.0 if bx == 'walls' else None)
        vps = _pad_axis(mesh, axis_name, vs, bx, 0)
        if by == 'periodic':
            # maccormack reads ghost corners; the reference's per_y corner
            # rules override whatever the x rules wrote there
            for fps in (hps, ups, vps):
                _fix_corners_periodic_y(mesh, axis_name, fps)
        new = []
        for k, dev in enumerate(devs):
            dt_k = dt.to(dev)
            U = _scheme_step(solver, linear, hps[k], ups[k], vps[k],
                             f_cor_pad[k], h_base_pad[k], g.to(dev),
                             h_mean.to(dev), dx.to(dev), dy.to(dev),
                             dt_k)
            h_new, u_new, v_new = sw.get_physical_values(U[:, 1:-1, :],
                                                         linear)
            u_new = u_new - r_int[k] * dt_k * us[k]
            v_new = v_new - r_int[k] * dt_k * vs[k]
            new.append([h_new, u_new, v_new])
        if wind_type not in (None, 'unforced'):
            if wind_type == 'seasonal':
                forced = None
            else:
                # BC-consistent h for the boundary averages: y ghosts
                # refreshed, x ghost contributions folded into the weights
                # the four masked sums travel as one [4] psum (each
                # element added in index order, as four psums would)
                h_bc = [_apply_y_bc(*f, by)[0] for f in new]
                sums = col.psum(mesh, axis_name, [torch.stack([
                    torch.sum(h * e), torch.sum(e), torch.sum(h * w),
                    torch.sum(w)]) for h, e, w in zip(h_bc, east_w, west_w)])
                s4 = sums[0]
                forced = wind_gamma * (s4[0] / s4[1] - s4[2] / s4[3])
            wind_dt = _wind_stress(wind_type, t, wind_tau0, wind_fluct,
                                   forced) * dt
            for f, dev in zip(new, devs):
                f[1] = f[1] + wind_dt.to(dev)
        out = ([], [], [])
        for k, dev in enumerate(devs):
            ok_k = ok.to(dev)
            for fields, n_f, old in zip(out, _apply_y_bc(*new[k], by),
                                        (hs[k], us[k], vs[k])):
                fields.append(torch.where(ok_k, n_f, old))
        return (*out, t + dt, dt, ok)

    return step


def _world_scalars(world, dev):
    """dt_0, g, h_mean, dx, dy as the world's tensors, on ``dev``."""
    return tuple(world._tensor(x).to(dev) for x in
                 (world.dt_0, world.g, world.h_mean, world.dx, world.dy))


def _commit(world, st, h, u, v, t, dt, ok):
    """Write back: the gathered [nx, ny] fields (ghost cells to be rebuilt)
    get the global BCs, and the (frozen-at-abort) state is committed BEFORE
    raising, like the unsharded run — callers inspect world.dt / resume
    after catching."""
    dev = world.device
    h, u, v = stencils.apply_boundary_conditions(
        h.to(dev), u.to(dev), v.to(dev), world.boundary_type['x'],
        world.boundary_type['y'])
    world._state = st.replace(h=h, u=u, v=v, t=t.to(dev), dt=dt.to(dev),
                              ok=st.ok & ok.to(dev))
    if not bool(world._state.ok):
        raise ValueError('time step very small')
    return world._state


class ShardedShallowWater:
    """Domain-decomposed wrapper around a ShallowWater model.

    Shards the x axis of the grid over ``mesh`` (a 1-D mesh) and runs the
    identical physics with halo exchange: bit-equal to the single-device
    model, except that the El Nino wind's masked sums are added shard by
    shard (ulp-close).  ``use_kernel``: 'auto' takes the fused kernel path
    where it can (warning when ``richtmyer_pallas`` cannot), True requires
    it, False runs the plain stencils.
    """

    def __init__(self, world: sw.ShallowWater, mesh, axis_name='x',
                 use_kernel='auto'):
        self.world = world
        self.mesh = mesh
        self.axis_name = axis_name
        n_shards = mesh.shape[axis_name]
        if mesh.size != n_shards:
            raise ValueError(f'the mesh {mesh.shape} has axes besides '
                             f'{axis_name!r}; the x decomposition takes a '
                             f'1-D mesh')
        # richtmyer_pallas shards onto the fused kernel per shard (bx='given':
        # the halo supplies the x ghost rows, the y boundary conditions stay
        # in the kernel).  Conditions: nonlinear and walls-y (the periodic-y
        # ghost-CORNER rules of the reference need values of the other x
        # edge).  Everything else takes the plain richtmyer stencils, loudly.
        kernel_ok = (world.numerical_solver == 'richtmyer_pallas'
                     and not world.linear
                     and world.boundary_type['y'] == 'walls'
                     and (world.nx - 2) % n_shards == 0)
        if use_kernel == 'auto':
            self.use_kernel = kernel_ok
            if world.numerical_solver == 'richtmyer_pallas' and not kernel_ok:
                warnings.warn(
                    'sharded shallow water: richtmyer_pallas requested but '
                    'the fused kernel path needs nonlinear + walls-y + an '
                    'interior nx divisible by the shards — falling back to '
                    'the plain richtmyer stencils', stacklevel=2)
        elif use_kernel and not kernel_ok:
            raise ValueError('use_kernel=True but this configuration cannot '
                             'run the fused kernel path (needs '
                             'richtmyer_pallas, nonlinear, walls-y, and an '
                             'interior nx divisible by the shards)')
        else:
            self.use_kernel = bool(use_kernel)
        self.solver = ('richtmyer' if world.numerical_solver
                       == 'richtmyer_pallas' else world.numerical_solver)
        nxi = world.nx - 2
        if nxi % n_shards:
            raise ValueError(f'interior nx={nxi} not divisible by '
                             f'{n_shards} shards')
        self.n_shards = n_shards
        self.local_nx = lnx = nxi // n_shards
        #: the local shards' devices, and their x blocks
        self.devices = mesh.local_devices
        self.lead = self.devices[0]
        x_idx = col.axis_index(mesh, axis_name)
        blocks = [slice(b * lnx, (b + 1) * lnx) for b in x_idx]
        self._blocks = blocks

        # El Nino boundary-average masks folded onto interior-x cells: every
        # ghost column of h is a copy of an interior column, so its mask weight
        # accumulates onto the source column (exact ghost-inclusive averages)
        if world.wind_type is not None:
            w = world.initial_info['wind']
            east_m, west_m = world._boundary_masks(w['x_average_width'],
                                                   w['y_average_width'])
            east, west = self._fold_ghost_mask(east_m), \
                self._fold_ghost_mask(west_m)
            scal = (w['gamma'], w['initial_tau_over_h'], w['seasonal_fluct'])
        else:
            east = west = np.zeros((nxi, world.ny))
            scal = (0.0, 0.0, 0.0)
        self.wind_gamma, self.wind_tau0, self.wind_fluct = (
            world._tensor(x).to(self.lead) for x in scal)

        if self.use_kernel:
            self._init_kernel(east, west)
            return
        # per-shard padded static geometry: block b covers global ghost-grid
        # rows [b*local, b*local + local + 1]
        pad = [slice(b * lnx, b * lnx + lnx + 2) for b in x_idx]
        shard = lambda a, sl: [world._tensor(a[s]).to(d)  # noqa: E731
                               for s, d in zip(sl, self.devices)]
        self.f_cor_pad = shard(world.f_coriolis, pad)
        self.h_base_pad = shard(world.h_base, pad)
        self.r_int = shard(np.asarray(world.r)[1:-1], blocks)
        self.east_w = shard(east, blocks)
        self.west_w = shard(west, blocks)

    def _init_kernel(self, east, west):
        """Per-shard inputs of the fused kernel: the unsharded run's
        boundary-condition-step constants (``shallow_water._frame_constants``,
        rows or interior fields, orography gradients of the global h_base),
        cut into x blocks; the folded masks stacked (east, west) per shard,
        and their psum'd totals, which no step changes."""
        wld = self.world
        kw = wld._step_kwargs()
        r_int, _e, _w, fcor, dhbx, dhby = sw._frame_constants(
            wld.params, kw['flat_orography'], kw['row_geometry'])

        def cut(x):
            if x is None:
                return [None] * self.n_shards
            return [(x if x.shape[0] == 1 else x[b]).to(d, copy=True)
                    for b, d in zip(self._blocks, self.devices)]
        self.k_r, self.k_fcor = cut(r_int), cut(fcor)
        self.k_dhbx, self.k_dhby = cut(dhbx), cut(dhby)
        weights = np.stack([east, west])             # [2, nxi, ny]
        self.k_weights = [wld._tensor(weights[:, b]).to(d)
                          for b, d in zip(self._blocks, self.devices)]
        self.k_weight_sums = col.psum(self.mesh, self.axis_name, [
            torch.sum(w, (1, 2)) for w in self.k_weights])[0]

    def _fold_ghost_mask(self, mask):
        """Full ghost-grid mask [nx, ny] -> interior-x weights [nx-2, ny].

        Every ghost h value is a copy of some other cell, so each ghost mask
        weight accumulates onto its source; x ghost rows fold here, y ghost
        cells stay (the step refreshes local y ghosts before averaging).
        With periodic-y the reference's corner rules (shallow_water.py:
        428-436) override the x rules, so the 4 corner weights route to THEIR
        sources (f[0,0]=f[1,-2], f[0,-1]=f[1,1], f[-1,0]=f[-2,-2], and the
        quirk f[-1,-1]=f[-2,-1] whose value is f[-2,1]) instead of the
        x-row fold; with walls-y the plain fold is already exact (the
        y-walls copy rule composes with the x rules cell-by-cell)."""
        nx, ny = self.world.nx, self.world.ny
        bx = self.world.boundary_type['x']
        by = self.world.boundary_type['y']
        m = mask.astype(np.float64).copy()
        w = m[1:-1].copy()
        if by == 'periodic':
            # interior-x index, ghost-grid y index (w keeps the y extent)
            w[0, ny - 2] += m[0, 0]
            w[0, 1] += m[0, -1]
            w[nx - 3, ny - 2] += m[-1, 0]
            w[nx - 3, 1] += m[-1, -1]
            m[0, 0] = m[0, -1] = m[-1, 0] = m[-1, -1] = 0.0
        left_src = (nx - 3) if bx == 'periodic' else 0
        right_src = 0 if bx == 'periodic' else (nx - 3)
        w[left_src] += m[0]
        w[right_src] += m[-1]
        return w

    def _split(self, f):
        """Interior-x blocks [local_nx, ny] of a full field, copied onto the
        local shards' devices."""
        return [f[1:-1][b].to(d, copy=True)
                for b, d in zip(self._blocks, self.devices)]

    def run(self, nt, target_courant=0.1):
        """Run nt steps sharded; updates the wrapped world's state in place
        and returns it.  Raises ``ValueError('time step very small')`` after
        committing a run that aborted."""
        if self.use_kernel:
            return self._run_kernel(nt, target_courant)
        wld = self.world
        st = wld.state
        dt0, g, h_mean, dx, dy = _world_scalars(wld, self.lead)
        step = make_sharded_step(self.mesh, self.axis_name, solver=self.solver,
                                 linear=wld.linear, bx=wld.boundary_type['x'],
                                 by=wld.boundary_type['y'],
                                 wind_type=wld.wind_type,
                                 target_courant=target_courant)
        hs, us, vs = (self._split(f) for f in (st.h, st.u, st.v))
        t, dt, ok = (x.to(self.lead) for x in (st.t, st.dt, st.ok))
        for _ in range(nt):
            hs, us, vs, t, dt, ok = step(
                hs, us, vs, t, dt, ok, dt0, self.f_cor_pad, self.h_base_pad,
                self.r_int, g, h_mean, dx, dy, self.wind_gamma,
                self.wind_tau0, self.wind_fluct, self.east_w, self.west_w)
        return self._gather_commit(st, hs, us, vs, t, dt, ok)

    def _set_ghosts(self, bufs):
        """Fill the two x ghost rows of every local shard's [3, lnx+2, ny]
        buffer, all ny cells of h, u and v: from the ring neighbours' edge
        rows (both directions in one exchange), or at the global walls the
        shard's own edge row (h, v) and zero (u).  The ghost rows are not
        contiguous: a process mesh receives into a staging row and copies
        it in."""
        mesh, ax, n, lnx = self.mesh, self.axis_name, self.n_shards, \
            self.local_nx
        first = [b[:, 1] for b in bufs]
        last = [b[:, lnx] for b in bufs]
        top = [b[:, 0] for b in bufs]
        bot = [b[:, lnx + 1] for b in bufs]
        if self.world.boundary_type['x'] == 'periodic':
            fwd, bwd = _ring_perms(n)
            col.ppermutes(mesh, ax, [(last, fwd, top), (first, bwd, bot)])
            return
        col.ppermutes(mesh, ax, [
            (last, [(i, i + 1) for i in range(n - 1)], top),
            (first, [(i + 1, i) for i in range(n - 1)], bot)])
        idx = col.axis_index(mesh, ax)
        for b, i in zip(bufs, idx):
            if i == 0:
                b[:, 0].copy_(b[:, 1])
                b[1, 0].zero_()
            if i == n - 1:
                b[:, lnx + 1].copy_(b[:, lnx])
                b[1, lnx + 1].zero_()

    def _run_kernel(self, nt, target_courant):
        """nt steps on the fused kernel (K6, ``bx='given'``), per local shard
        double-buffered: step k reads the buffers k mod 2 (their ghost rows
        just filled by the halo) and writes the others."""
        wld = self.world
        st = wld.state
        mesh, ax, lnx = self.mesh, self.axis_name, self.local_nx
        devs = self.devices
        wind_type = wld.wind_type
        dt0, g, _h_mean, dx, dy = _world_scalars(wld, self.lead)
        on_shards = lambda x: [x.to(d) for d in devs]  # noqa: E731
        g_s, dx_s, dy_s = on_shards(g), on_shards(dx), on_shards(dy)
        shape = (3, lnx + 2, wld.ny)
        bufs = [[torch.empty(shape, dtype=wld.dtype, device=d) for d in devs]
                for _ in range(2)]
        for b, blk in zip(bufs[0], self._blocks):
            rows = slice(blk.start, blk.stop + 2)
            for k, f in enumerate((st.h, st.u, st.v)):
                b[k].copy_(f[rows])
        max2 = [torch.max(b[1, 1:-1] * b[1, 1:-1] + b[2, 1:-1] * b[2, 1:-1])
                for b in bufs[0]]
        t, dt, ok = (x.to(self.lead) for x in (st.t, st.dt, st.ok))
        for k in range(nt):
            src, dst = bufs[k % 2], bufs[(k + 1) % 2]
            dt, ok = sw.cfl_dt(col.pmax(mesh, ax, max2)[0], t, dt, ok, dt0,
                               dx, dy, target_courant)
            self._set_ghosts(src)
            dt_s, ok_s = on_shards(dt), on_shards(ok)
            for i, (a, b) in enumerate(zip(src, dst)):
                max2[i] = stencils.richtmyer_step_bc(
                    a[0], a[1], a[2], self.k_fcor[i], self.k_r[i],
                    self.k_dhbx[i], self.k_dhby[i], dt_s[i], ok_s[i], g_s[i],
                    dx_s[i], dy_s[i], 'given', 'walls',
                    out=(b[0], b[1], b[2]))[3]
            if wind_type not in (None, 'unforced'):
                if wind_type == 'seasonal':
                    forced = None
                else:
                    # the masked sums over the shard's interior rows, y
                    # ghosts included: (east, west) at once
                    sums = col.psum(mesh, ax, [
                        torch.sum(b[0, 1:-1] * w, (1, 2))
                        for b, w in zip(dst, self.k_weights)])[0]
                    means = sums / self.k_weight_sums
                    forced = self.wind_gamma * (means[0] - means[1])
                wind = _wind_stress(wind_type, t, self.wind_tau0,
                                    self.wind_fluct, forced)
                inc = torch.where(ok, wind * dt, torch.zeros_like(dt))
                # (no x-ghost-row re-zero needed: the halo rebuilds the
                # ghost rows from the post-wind interior before the next
                # step)
                for i, (b, d) in enumerate(zip(dst, devs)):
                    b[1].add_(inc.to(d))
                    ui, vi = b[1, 1:-1, 1:-1], b[2, 1:-1, 1:-1]
                    max2[i] = torch.max(ui * ui + vi * vi)
            t = t + dt
        #: each local shard's max(u^2+v^2) over its interior after the run
        self.max2 = max2
        final = bufs[nt % 2]
        return self._gather_commit(st, *([b[k, 1:-1] for b in final]
                                         for k in range(3)), t, dt, ok)

    def _gather_commit(self, st, hs, us, vs, t, dt, ok):
        """The shards' interior-x blocks, in x order, with copies of the
        edge rows where the global x ghost rows go, committed (on a process
        mesh by every rank, the blocks gathered over the mesh)."""
        dev = self.world.device

        def gather(fs):
            f = torch.cat(col.fetch_shards(self.mesh, fs), 0).to(dev)
            return torch.cat([f[:1], f, f[-1:]], 0)
        return _commit(self.world, st, gather(hs), gather(us), gather(vs),
                       t, dt, ok)


# --------------------------------------------------------------------------
# members on 'data' x the x decomposition on 'x' (dp x sp)
# --------------------------------------------------------------------------

def make_batched_sharded_step(mesh, data_axis='data', axis_name='x',
                              solver='richtmyer', linear=False, bx='periodic',
                              by='walls', wind_type=None,
                              target_courant=0.1):
    """The batched step of an ensemble on a ``(data_axis, axis_name)`` mesh:
    each data row x-shards its own members, and each member keeps its own
    CFL dt, ``ok`` and wind sums, as the JAX package's per-shard body
    vmapped over the local members inside ``shard_map`` does.  A member
    runs the x-sharded step of its data row (:func:`make_sharded_step` on
    the row's shards), so it is bit-equal to that step.

    ``step(hs, us, vs, t, dt_prev, ok, dt0, f_cor_pad, h_base_pad, r_int,
    g, h_mean, dx, dy, wind_gamma, wind_tau0, wind_fluct, east_w, west_w)``
    returns ``(hs, us, vs, t + dt, dt, ok)``:

    * ``hs, us, vs``: lists over the local shards of [m, nx_i / n_x, ny],
      the m members of the shard's data row;
    * ``t, dt_prev, ok``: lists over the local rows (in ``data_axis``
      order) of [m] tensors on each row's first local device;
    * ``f_cor_pad`` to ``r_int``, ``east_w``, ``west_w``: lists over the
      local shards, as :func:`make_sharded_step` takes them; the rest 0-d
      tensors.
    """
    if set(mesh.axis_names) != {data_axis, axis_name} or len(
            mesh.axis_names) != 2:
        raise ValueError(f'the batched step needs a mesh of the axes '
                         f'({data_axis!r}, {axis_name!r}), got '
                         f'{mesh.axis_names}')
    devs = mesh.local_devices
    rows = col.local_lines(mesh, axis_name)
    row_steps = [make_sharded_step(line_mesh, axis_name, solver=solver,
                                   linear=linear, bx=bx, by=by,
                                   wind_type=wind_type,
                                   target_courant=target_courant)
                 for _, line_mesh, _ in rows]

    def step(hs, us, vs, t, dt_prev, ok, dt0, f_cor_pad, h_base_pad, r_int,
             g, h_mean, dx, dy, wind_gamma, wind_tau0, wind_fluct, east_w,
             west_w):
        col.check_on_mesh(mesh, list(zip(hs, us, vs)), 'batched step shard')
        out = ([None] * len(hs), [None] * len(hs), [None] * len(hs))
        carried = ([], [], [])
        for r, ((_, _, own), row_step) in enumerate(zip(rows, row_steps)):
            lead = devs[own[0]]
            sc = [x.to(lead) for x in (dt0, g, h_mean, dx, dy, wind_gamma,
                                       wind_tau0, wind_fluct)]

            def pick(xs):
                return [xs[i] for i in own]
            members = [row_step(
                [hs[i][j] for i in own], [us[i][j] for i in own],
                [vs[i][j] for i in own], t[r][j], dt_prev[r][j], ok[r][j],
                sc[0], pick(f_cor_pad), pick(h_base_pad), pick(r_int),
                *sc[1:], pick(east_w), pick(west_w))
                for j in range(hs[own[0]].shape[0])]
            for f in range(3):
                for q, i in enumerate(own):
                    out[f][i] = torch.stack([m[f][q] for m in members])
                carried[f].append(torch.stack([m[3 + f] for m in members]))
        return (*out, *carried)

    return step


class ShardedShallowWaterEnsemble:
    """An ensemble of shallow-water worlds of one geometry on a
    ``(data_axis, axis_name)`` mesh (dp x sp): the members are cut into
    contiguous blocks along ``data_axis``, and each data row x-shards its
    block with the plain stencils (a ``richtmyer_pallas`` world takes
    ``richtmyer``, as the JAX package's composition does), every member
    with its own dt, ``ok`` and wind (:func:`make_batched_sharded_step`).

    :param world: the template: grid, boundaries, wind and the starting
        t, dt and ok of every member.
    :param h, u, v: [B, nx, ny] the members' initial fields (ghost cells
        included); B divisible by the ``data_axis`` size.
    """

    def __init__(self, world: sw.ShallowWater, mesh, h, u, v,
                 data_axis='data', axis_name='x'):
        self.world, self.mesh = world, mesh
        self.data_axis, self.axis_name = data_axis, axis_name
        devs = mesh.local_devices
        self.rows = col.local_lines(mesh, axis_name)
        # one x-sharded helper a local row: its shards' geometry and wind
        # scalars
        self.helpers = [ShardedShallowWater(world, line_mesh, axis_name,
                                            use_kernel=False)
                        for _, line_mesh, _ in self.rows]
        self.solver = self.helpers[0].solver
        n_rows = mesh.shape[data_axis]
        if h.shape[0] % n_rows:
            raise ValueError(f'{h.shape[0]} members not divisible by '
                             f'{n_rows} rows along {data_axis!r}')
        self.n_members = h.shape[0]
        m = self.n_members // n_rows
        st = world.state
        self.lead = devs[0]
        self.t, self.dt, self.ok = (
            [x.to(devs[own[0]]).expand(m).clone() for _, _, own in self.rows]
            for x in (st.t, st.dt, st.ok))
        data_idx = col.axis_index(mesh, data_axis, range(mesh.size))
        self.fields = []                   # h, u, v: local-shard lists
        for f in (h, u, v):
            per = [None] * len(devs)
            for (line, _, own), hp in zip(self.rows, self.helpers):
                r = data_idx[line[0]]
                block = f[r * m:(r + 1) * m, 1:-1]
                for i, rows_x in zip(own, hp._blocks):
                    per[i] = block[:, rows_x].to(
                        devs[i], copy=True,
                        memory_format=torch.contiguous_format)
            self.fields.append(per)

    def _per_shard(self, name):
        out = [None] * len(self.mesh.local_shards)
        for (_, _, own), hp in zip(self.rows, self.helpers):
            for i, x in zip(own, getattr(hp, name)):
                out[i] = x
        return out

    def run(self, nt, target_courant=0.1):
        """Run nt steps of every member.  A member whose dt fell below 10 s
        is frozen (its ``ok`` False); nothing is raised.

        :return: (h, u, v [B, nx, ny] with the global boundary conditions,
            t, dt, ok [B]) on the first local device.
        """
        wld = self.world
        hp0 = self.helpers[0]
        step = make_batched_sharded_step(
            self.mesh, self.data_axis, self.axis_name, solver=self.solver,
            linear=wld.linear, bx=wld.boundary_type['x'],
            by=wld.boundary_type['y'], wind_type=wld.wind_type,
            target_courant=target_courant)
        dt0, g, h_mean, dx, dy = _world_scalars(wld, self.lead)
        geom = [self._per_shard(n) for n in ('f_cor_pad', 'h_base_pad',
                                              'r_int')]
        east, west = self._per_shard('east_w'), self._per_shard('west_w')
        hs, us, vs = self.fields
        t, dt, ok = self.t, self.dt, self.ok
        for _ in range(nt):
            hs, us, vs, t, dt, ok = step(
                hs, us, vs, t, dt, ok, dt0, *geom, g, h_mean, dx, dy,
                hp0.wind_gamma, hp0.wind_tau0, hp0.wind_fluct, east, west)
        self.fields, self.t, self.dt, self.ok = [hs, us, vs], t, dt, ok
        return self.gather()

    def gather(self):
        """The members' fields [B, nx, ny] (boundary conditions applied)
        and t, dt, ok [B], in member order on the first local device (on a
        process mesh, every rank gets them all)."""
        bx, by = self.world.boundary_type['x'], self.world.boundary_type['y']
        every = [col.fetch_shards(self.mesh, f) for f in self.fields]
        lines = col.axis_lines(self.mesh, self.axis_name)    # data order
        full = []
        for line in lines:
            block = [torch.cat([f[k] for k in line], 1)
                     for f in every]                      # [m, nx_i, ny]
            for j in range(block[0].shape[0]):
                h, u, v = (torch.cat([b[j, :1], b[j], b[j, -1:]], 0)
                           for b in block)
                full.append(stencils.apply_boundary_conditions(h, u, v, bx,
                                                               by))
        h, u, v = (torch.stack(x) for x in zip(*full))

        def rows(xs):
            per = [None] * len(self.mesh.local_shards)
            for (_, _, own), x in zip(self.rows, xs):
                for i in own:
                    per[i] = x
            return torch.cat(col.fetch_shards(self.mesh, per,
                                              [line[0] for line in lines]))
        return h, u, v, rows(self.t), rows(self.dt), rows(self.ok)


# --------------------------------------------------------------------------
# 2-D (x, y) domain decomposition
# --------------------------------------------------------------------------

def make_sharded_step_2d(ax_x='x', ax_y='y', solver='richtmyer',
                         linear=False, bx='periodic', by='walls',
                         wind_type=None, target_courant=0.1, *, mesh):
    """Sharded step of a 2-D spatial decomposition: shards hold interior
    blocks [nxi/Px, nyi/Py]; both ghost layers are rebuilt every step from
    the halos (y first, then x, so the x halo carries the y ghosts: corners
    from the neighbours' own ghost cells).  Same signature and carried
    ``ok`` as :func:`make_sharded_step`."""
    axes = (ax_x, ax_y)
    devs = mesh.local_devices

    def pad2(fs, wall_u_x=False, wall_v_y=False):
        fs = _pad_axis(mesh, ax_y, fs, by, 1,
                       wall_value=0.0 if (wall_v_y and by == 'walls')
                       else None)
        return _pad_axis(mesh, ax_x, fs, bx, 0,
                         wall_value=0.0 if (wall_u_x and bx == 'walls')
                         else None)

    def greduce(fn, xs):
        for ax in axes:
            xs = fn(mesh, ax, xs)
        return xs[0]

    def step(hs, us, vs, t, dt_prev, ok, dt0, f_cor_pad, h_base_pad, r_int,
             g, h_mean, dx, dy, wind_gamma, wind_tau0, wind_fluct, east_w,
             west_w):
        max2 = greduce(col.pmax, [torch.max(u * u + v * v)
                                  for u, v in zip(us, vs)])
        dt, ok = sw.cfl_dt(max2, t, dt_prev, ok, dt0, dx, dy,
                           target_courant)

        hps = pad2(hs)
        ups = pad2(us, wall_u_x=True)
        vps = pad2(vs, wall_v_y=True)
        if solver == 'maccormack' and by == 'periodic':
            # maccormack is the one scheme that reads ghost corners; the
            # global corners need the reference's periodic-y override rules
            for fps, fs in ((hps, hs), (ups, us), (vps, vs)):
                _fix_corners_periodic_y_2d(mesh, fps, fs, ax_x, ax_y)
        new = []
        for k, dev in enumerate(devs):
            dt_k = dt.to(dev)
            U = _scheme_step(solver, linear, hps[k], ups[k], vps[k],
                             f_cor_pad[k], h_base_pad[k], g.to(dev),
                             h_mean.to(dev), dx.to(dev), dy.to(dev),
                             dt_k)
            h_new, u_new, v_new = sw.get_physical_values(U[:, 1:-1, 1:-1],
                                                         linear)
            u_new = u_new - r_int[k] * dt_k * us[k]
            v_new = v_new - r_int[k] * dt_k * vs[k]
            new.append([h_new, u_new, v_new])
        if wind_type not in (None, 'unforced'):
            if wind_type == 'seasonal':
                forced = None
            else:
                # the four masked sums as one [4] psum a mesh axis
                s4 = greduce(col.psum, [torch.stack([
                    torch.sum(f[0] * e), torch.sum(e), torch.sum(f[0] * w),
                    torch.sum(w)]) for f, e, w in zip(new, east_w, west_w)])
                forced = wind_gamma * (s4[0] / s4[1] - s4[2] / s4[3])
            wind_dt = _wind_stress(wind_type, t, wind_tau0, wind_fluct,
                                   forced) * dt
            for f, dev in zip(new, devs):
                f[1] = f[1] + wind_dt.to(dev)
        out = ([], [], [])
        for k, dev in enumerate(devs):
            ok_k = ok.to(dev)
            for fields, n_f, old in zip(out, new[k], (hs[k], us[k], vs[k])):
                fields.append(torch.where(ok_k, n_f, old))
        return (*out, t + dt, dt, ok)

    return step


class ShardedShallowWater2D:
    """Full 2-D (x, y) domain decomposition of a ShallowWater model over a
    mesh with axes (ax_x, ax_y); matches the single-device model exactly.
    Runs the plain stencils: a ``richtmyer_pallas`` world takes the plain
    ``richtmyer`` scheme, with a UserWarning (the fused kernel has no halo
    mode in y)."""

    def __init__(self, world: sw.ShallowWater, mesh, ax_x='x', ax_y='y'):
        self.world = world
        self.mesh = mesh
        self.ax_x, self.ax_y = ax_x, ax_y
        if world.numerical_solver == 'richtmyer_pallas':
            warnings.warn(
                'ShardedShallowWater2D: richtmyer_pallas requested, but the '
                'fused kernel has no halo mode in y — running the plain '
                'richtmyer stencils', stacklevel=2)
        self.solver = ('richtmyer' if world.numerical_solver
                       == 'richtmyer_pallas' else world.numerical_solver)
        px, py = mesh.shape[ax_x], mesh.shape[ax_y]
        if mesh.size != px * py:
            raise ValueError(f'the mesh {mesh.shape} has axes besides '
                             f'({ax_x!r}, {ax_y!r})')
        nxi, nyi = world.nx - 2, world.ny - 2
        if nxi % px or nyi % py:
            raise ValueError(f'interior {nxi}x{nyi} not divisible by '
                             f'{px}x{py} shards')
        self.lx, self.ly = lx, ly = nxi // px, nyi // py
        self.devices = mesh.local_devices
        self.lead = self.devices[0]
        # local shard k holds x block i, y block j
        self._ij = list(zip(col.axis_index(mesh, ax_x),
                            col.axis_index(mesh, ax_y)))

        def shard(full, halo):
            return [world._tensor(full[i * lx: (i + 1) * lx + halo,
                                       j * ly: (j + 1) * ly + halo]).to(d)
                    for (i, j), d in zip(self._ij, self.devices)]
        self.f_cor_pad = shard(world.f_coriolis, 2)
        self.h_base_pad = shard(world.h_base, 2)
        self.r_int = shard(np.asarray(world.r)[1:-1, 1:-1], 0)

        if world.wind_type is not None:
            w = world.initial_info['wind']
            east_m, west_m = world._boundary_masks(w['x_average_width'],
                                                   w['y_average_width'])
            self.east_w = shard(self._fold_mask_2d(east_m), 0)
            self.west_w = shard(self._fold_mask_2d(west_m), 0)
            scal = (w['gamma'], w['initial_tau_over_h'], w['seasonal_fluct'])
        else:
            self.east_w = self.west_w = shard(np.zeros((nxi, nyi)), 0)
            scal = (0.0, 0.0, 0.0)
        self.wind_gamma, self.wind_tau0, self.wind_fluct = (
            world._tensor(x).to(self.lead) for x in scal)

    def _fold_mask_2d(self, mask):
        """Ghost-grid mask [nx, ny] -> interior weights [nx-2, ny-2]: every
        ghost h value is a copy of an interior cell, so its mask weight
        accumulates onto the source cell (exact ghost-inclusive averages).
        With periodic-y the reference's corner rules (shallow_water.py:
        428-436) override the x rules, so the 4 corner weights route straight
        to their interior sources (f[0,0]=f[1,-2] etc.); with walls-y the
        x-then-y fold is already exact cell-by-cell."""
        nx, ny = self.world.nx, self.world.ny
        bx = self.world.boundary_type['x']
        by = self.world.boundary_type['y']
        m = mask.astype(np.float64).copy()
        corner = np.zeros((nx - 2, ny - 2))
        if by == 'periodic':
            corner[0, ny - 3] += m[0, 0]          # f[0,0]   = f[1,-2]
            corner[0, 0] += m[0, -1]              # f[0,-1]  = f[1,1]
            corner[nx - 3, ny - 3] += m[-1, 0]    # f[-1,0]  = f[-2,-2]
            corner[nx - 3, 0] += m[-1, -1]        # f[-1,-1] = f[-2,1]
            m[0, 0] = m[0, -1] = m[-1, 0] = m[-1, -1] = 0.0
        # fold x ghost rows first
        w1 = m[1:-1].copy()                                # [nxi, ny]
        w1[(nx - 3) if bx == 'periodic' else 0] += m[0]
        w1[0 if bx == 'periodic' else (nx - 3)] += m[-1]
        # then y ghost cells
        w2 = w1[:, 1:-1].copy()                            # [nxi, nyi]
        w2[:, (ny - 3) if by == 'periodic' else 0] += w1[:, 0]
        w2[:, 0 if by == 'periodic' else (ny - 3)] += w1[:, -1]
        return w2 + corner

    def run(self, nt, target_courant=0.1):
        """Run nt steps sharded; updates the wrapped world's state in place
        and returns it (raises after committing a run that aborted)."""
        wld = self.world
        st = wld.state
        lx, ly, dev = self.lx, self.ly, wld.device
        dt0, g, h_mean, dx, dy = _world_scalars(wld, self.lead)
        step = make_sharded_step_2d(self.ax_x, self.ax_y,
                                    solver=self.solver, linear=wld.linear,
                                    bx=wld.boundary_type['x'],
                                    by=wld.boundary_type['y'],
                                    wind_type=wld.wind_type,
                                    target_courant=target_courant,
                                    mesh=self.mesh)
        hs, us, vs = ([f[1:-1, 1:-1][i * lx:(i + 1) * lx,
                                     j * ly:(j + 1) * ly].to(d, copy=True)
                       for (i, j), d in zip(self._ij, self.devices)]
                      for f in (st.h, st.u, st.v))
        t, dt, ok = (x.to(self.lead) for x in (st.t, st.dt, st.ok))
        for _ in range(nt):
            hs, us, vs, t, dt, ok = step(
                hs, us, vs, t, dt, ok, dt0, self.f_cor_pad, self.h_base_pad,
                self.r_int, g, h_mean, dx, dy, self.wind_gamma,
                self.wind_tau0, self.wind_fluct, self.east_w, self.west_w)
        px, py = self.mesh.shape[self.ax_x], self.mesh.shape[self.ax_y]

        every = range(self.mesh.size)
        every_ij = list(zip(col.axis_index(self.mesh, self.ax_x, every),
                            col.axis_index(self.mesh, self.ax_y, every)))

        def gather(fs):
            grid = [[None] * py for _ in range(px)]
            for (i, j), f in zip(every_ij, col.fetch_shards(self.mesh, fs)):
                grid[i][j] = f.to(dev)
            f = torch.cat([torch.cat(row, 1) for row in grid], 0)
            # edge padding; the boundary conditions below rewrite every ghost
            f = torch.cat([f[:1], f, f[-1:]], 0)
            return torch.cat([f[:, :1], f, f[:, -1:]], 1)
        return _commit(wld, st, gather(hs), gather(us), gather(vs), t, dt,
                       ok)
