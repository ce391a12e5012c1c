"""Walkthrough: ice-albedo feedback, hysteresis, and the faint young sun
(port of ``examples/walkthrough_ice_albedo.py``).

Runnable translation of the reference's Ice-Albedo Feedback notebook.

The mechanism: ice reflects sunlight better than land or sea, so the albedo
is not a constant but a step function of the surface temperature — 0.3
ice-free, 0.6 below T_ice = 263 K (ice_albedo_feedback.py:13-37).  Cooling a
planet therefore feeds back on itself: less sunlight absorbed -> colder ->
more ice -> less sunlight absorbed.  Sweeping the stellar constant DOWN from
a hot ice-free state and back UP (the warm->cold->warm ordering,
ice_albedo_feedback.py:99-108) exposes the classic hysteresis loop:

* cooling branch: the planet stays ice-free far below the flux at which the
  warming branch deglaciates, then collapses to a snowball;
* warming branch: once a snowball, the high albedo keeps it frozen until a
  much larger stellar flux melts it (the transition fluxes printed below).

The faint-young-sun paradox is the Earth-flavoured version: the young sun
was ~30% fainter, yet the Earth wasn't a snowball.  Resolution: a stronger
early greenhouse — raising tau_lw_surface from 4 to 4.6 shifts the whole
loop to lower fluxes (notebook cells 7-8), letting a faint star keep an
ice-free state available.

Each equilibrium solve inside the sweep marches all latitudes of the world
together with one shared dt (on the card the lw walk is K1); the sweep
itself stays sequential because hysteresis IS the dependence on history.
"""
import numpy as np
import torch

from ..constants import p_surface_earth
from ..models.ice_albedo import GreyAlbedoFeedback
from . import out_path, parse_args, pyplot, say_fn


def transition_fluxes(values, ice_latitude, snowball_lat=15.0):
    """The narrative numbers: where each branch flips state.

    Returns (F_snowball, F_deglaciate, min_edge): the stellar constant at
    which the cooling branch first ices over to below ``snowball_lat``
    degrees (a deep-snowball proxy — on coarse latitude grids the edge
    parks at the gridpoint nearest the equator rather than exactly 0), the
    one at which the warming branch first clears all ice (edge back at the
    pole), and the cooling branch's minimum ice-edge latitude."""
    values = np.asarray(values, float)
    ice = np.asarray(ice_latitude, float)
    cool = slice(0, values.argmin() + 1)
    warm = slice(values.argmin(), len(values))
    F_snow = next((values[cool][k] for k in range(len(ice[cool]))
                   if ice[cool][k] <= snowball_lat), None)
    F_degl = next((values[warm][k] for k in range(len(ice[warm]))
                   if ice[warm][k] >= 90), None)
    return F_snow, F_degl, float(ice[cool].min())


def run_walkthrough(nz=40, ny=16, F_lo=450.0, F_hi=2250.0, dF=150.0,
                    tau_surfaces=(4.0, 4.6), flux_thresh=1e-3,
                    save_png=True, verbose=True, out_dir=None, device='cuda',
                    dtype=torch.float32):
    """Stellar-constant hysteresis sweep at each tau_lw_surface in
    ``tau_surfaces`` (the notebook runs [4.0, 4.6] from 300 W/m^2 on the
    dense nz='auto' grid; here the sweep starts at 450 W/m^2 — on coarse
    fixed grids the deep-snowball marches below that undershoot to negative
    temperatures, the same abort the reference raises, base.py:319-320)."""
    say = say_fn(verbose)
    F_values = np.arange(F_lo, F_hi, dF)
    results = {}
    for tau_s in tau_surfaces:
        sweep = GreyAlbedoFeedback(
            tau_s, F_values, nz, ny, 'scale_height',
            [0.22 * p_surface_earth, float(tau_s)], dtype=dtype,
            device=device)
        albedo, ice_lat, T_surf = sweep.run(
            delta_albedo=0.1, delta_net_flux_thresh=flux_thresh)
        F_snow, F_degl, min_edge = transition_fluxes(
            sweep.changing_param_values, ice_lat)
        say(f'tau_lw_surface = {tau_s}:')
        say(f'  cooling branch ices over (edge {min_edge:.0f} deg) by '
            f'F = {F_snow} W/m^2')
        say(f'  warming branch deglaciates only at F = {F_degl} W/m^2')
        if F_snow is not None and F_degl is not None:
            say(f'  -> hysteresis width {F_degl - F_snow:.0f} W/m^2: '
                'in between, the state depends on history')
        results[tau_s] = dict(sweep=sweep, ice_lat=ice_lat, T_surf=T_surf,
                              F_snow=F_snow, F_degl=F_degl)

    # the faint-young-sun observation: more greenhouse (tau 4 -> 4.6) moves
    # the deglaciation point to lower stellar flux
    taus = sorted(results)
    if len(taus) == 2:
        d0, d1 = results[taus[0]]['F_degl'], results[taus[1]]['F_degl']
        if d0 is not None and d1 is not None:
            say(f'faint young sun: raising tau {taus[0]} -> {taus[1]} moves '
                f'deglaciation from {d0:.0f} to {d1:.0f} W/m^2 — a stronger '
                'early greenhouse keeps a fainter star ice-free')
            assert d1 <= d0

    if save_png:
        plt = pyplot()
        fig, axs = plt.subplots(1, len(results), figsize=(6 * len(results), 5),
                                sharey=True)
        axs = np.atleast_1d(axs)
        for ax, tau_s in zip(axs, taus):
            r = results[tau_s]
            vals = r['sweep'].changing_param_values
            ice = np.asarray(r['ice_lat'])
            cool = np.arange(vals.argmin() + 1)
            warm = np.arange(vals.argmin(), len(vals))
            ax.plot(vals[cool], ice[cool], 'o-', color='tab:blue',
                    label='cooling branch')
            ax.plot(vals[warm], ice[warm], 'o-', color='tab:red',
                    label='warming branch')
            ax.set_xlabel(r'Stellar constant $F^\odot$ (W/m$^2$)')
            ax.set_title(rf'$\tau_{{lw,surface}} = {tau_s}$')
            ax.legend()
        axs[0].set_ylabel('Ice edge latitude (deg)')
        fig.suptitle('Ice-albedo hysteresis: snowball vs hothouse depends '
                     'on history')
        fig.tight_layout()
        path = out_path(out_dir, 'walkthrough_ice_albedo.png')
        fig.savefig(path, dpi=90)
        plt.close(fig)
        say(f'saved {path}')
    return results


#: the configuration ``main()`` runs (the JAX script's)
MAIN = dict(nz=40, ny=30, dF=50.0)


def main(argv=None):
    args = parse_args(__doc__.splitlines()[0], argv)
    run_walkthrough(**MAIN, save_png=args.figures, out_dir=args.out_dir,
                    device=args.device, dtype=args.dtype)


if __name__ == '__main__':
    main()
