"""Staged time-varying-optical-depth experiment (port of
``examples/staged_tau_ramp.py``; reference radiation_script.py:54-116).

The one reference workload that exercises per-step forcing mutation
(``changing_tau=True``), ``update_grid``, data_dict-chained equilibrations and
the 3-panel tau/flux animation end-to-end:

1. ramp the longwave optical depth ``tau_lw = min(tau_0 + lw_rate * t,
   tau_final)`` one adaptive step at a time, recomputing the tau grids each
   step on the FIXED pressure grid (built once for the final, densest taus);
2. when the lw ramp tops out, equilibrate (chained into the same data dict);
3. ramp the shortwave absorber strength 0 -> sw_final the same way;
4. equilibrate, drop the sw absorber to zero, re-equilibrate;
5. animate T with the tau/flux side panels.

Every step's lw walk is K1 on the card.
"""
import numpy as np
import torch

from . import out_path, parse_args, pyplot


def run_staged_tau_ramp(nz='auto', ny=1, conv_adjust=False,
                        tau_lw_0=4.0, tau_lw_final=6.0, lw_rate=1e-8,
                        sw_final=1.2, sw_rate=1e-4,
                        t_end_years=10.0, delta_net_flux_thresh=1e-3,
                        max_ramp_steps=100_000, out_dir=None,
                        n_plot_frames=80, save_gif=True, dtype=torch.float32,
                        device='cuda'):
    """Run the staged lw->sw ramp experiment; returns (world, data_dict).

    Parameters mirror the reference's hard-coded values
    (radiation_script.py:56-116): ``lw_rate`` in tau/s of model time,
    ``sw_rate`` in strength per adaptive step.  ``max_ramp_steps`` bounds each
    host ramp loop (the reference's only bound is t_end).  The animation is
    built when ``n_plot_frames > 0`` (``0``: no animation and no matplotlib)
    and saved to ``out_dir`` (default ``build/examples/``) when ``save_gif``.
    """
    from ..models.grey import GreyGas

    tau_params_final = [100000.0, tau_lw_final]
    tau_params = [100000.0, tau_lw_0]
    tau_sw_params_final = [300000.0, 2000.0, sw_final]
    tau_sw_params = [300000.0, 2000.0, 0.0]

    # grid built for the FINAL (densest) taus, then run from the initial ones
    # on that fixed grid (radiation_script.py:65-71)
    world = GreyGas(nz=nz, ny=ny, tau_lw_func='exponential',
                    tau_lw_func_args=list(tau_params_final),
                    tau_sw_func='peak_in_atmosphere',
                    tau_sw_func_args=list(tau_sw_params_final), dtype=dtype,
                    device=device)
    world.tau_lw_func_args = tuple(tau_params)
    world.tau_sw_func_args = tuple(tau_sw_params)
    world.update_grid()

    # analytic seed: with the initial sw strength 0 the no-sw closed form is
    # exact (grey.py:443-446); fluxes/taus recorded as frame 0
    up_eqb, down_eqb, T_eqb, up_sw_eqb, down_sw_eqb, _ = \
        world.equilibrium_sol(convective_adjust=conv_adjust)
    t = 0.0
    t_end = t_end_years * 365.0 * 86400.0
    t_sw = t_end
    data = {'t': [0.0], 'T': [np.asarray(T_eqb).copy()],
            'tau': {'lw': [np.asarray(world.tau).copy()],
                    'sw': [np.asarray(world.tau_sw).copy()]},
            'flux': {'lw_up': [np.asarray(up_eqb)],
                     'lw_down': [np.asarray(down_eqb)],
                     'sw_up': [np.asarray(up_sw_eqb)],
                     'sw_down': [np.asarray(down_sw_eqb)]}}
    T_seed = np.asarray(T_eqb).copy()

    steps = 0
    dt_now = 0.0     # refreshed from each take_time_step's return
    while t < t_end and steps < max_ramp_steps:
        steps += 1
        # per-step lw ramp (radiation_script.py:88-90)
        tau_params[1] = min(tau_params[1] + lw_rate * t, tau_params_final[1])
        world.tau_lw_func_args = tuple(tau_params)
        if (tau_params[1] == tau_params_final[1]
                and tau_sw_params[2] != tau_sw_params_final[2]):
            if t_sw == t_end:
                # lw ramp finished: equilibrate, chained into the same dict
                data = world.evolve_to_equilibrium(
                    data, delta_net_flux_thresh, T_seed.copy(),
                    convective_adjust=conv_adjust)
                t = data['t'][-1]
                t_sw = t
            # sw ramp, rate per adaptive step like the reference
            # (radiation_script.py:97-99 divides by the controller's dt —
            # the PREVIOUS step's, which is what dt_now holds).  The
            # max(dt, 1) guard only covers the never-stepped state right
            # after the equilibrate (dt resets with the controller): the
            # reference divides bare because its march always leaves a
            # non-zero dt behind.
            tau_sw_params[2] = min(
                tau_sw_params[2] + sw_rate * (t - t_sw) / max(dt_now, 1.0),
                tau_sw_params_final[2])
            world.tau_sw_func_args = tuple(tau_sw_params)
        if tau_sw_params[2] == tau_sw_params_final[2]:
            # sw ramp finished: equilibrate, zero the sw absorber, equilibrate
            data = world.evolve_to_equilibrium(
                data, delta_net_flux_thresh, T_seed.copy(),
                convective_adjust=conv_adjust)
            tau_sw_params[2] = 0.0
            world.tau_sw_func_args = tuple(tau_sw_params)
            world.update_grid()
            data = world.evolve_to_equilibrium(
                data, delta_net_flux_thresh, T_seed.copy(),
                convective_adjust=conv_adjust)
            break
        else:
            t, _delta, dt_now = world.take_time_step(
                t, T_seed.copy(), changing_tau=True,
                convective_adjust=conv_adjust, return_dt=True)
            data = world.save_data(data, t)

    if n_plot_frames > 0:
        from ..diagnostics.animation import Animate
        pyplot()
        anim = Animate(world, data['T'], data['t'], tau_array=data['tau'],
                       flux_array=data['flux'], nPlotFrames=n_plot_frames)
        if save_gif:
            anim.anim.save(out_path(out_dir, 'grey_tau_ramp.gif'),
                           writer='pillow', fps=10)
    return world, data


#: the configuration ``main()`` runs: the function's defaults, the
#: reference's experiment
MAIN = {}


def main(argv=None):
    args = parse_args(__doc__.splitlines()[0], argv)
    figures = {} if args.figures else dict(save_gif=False, n_plot_frames=0)
    world, data = run_staged_tau_ramp(**MAIN, **figures,
                                      out_dir=args.out_dir,
                                      device=args.device, dtype=args.dtype)
    print(f'staged tau ramp: {len(data["t"])} frames, final '
          f'T_surface={float(np.asarray(world.T)[0, 0]):.1f} K'
          + (' (saved grey_tau_ramp.gif)' if args.figures else ''))


if __name__ == '__main__':
    main()
