"""Grey-gas radiation experiments (port of ``examples/radiation_script.py``;
the reference's radiation_script.py).

Four experiment blocks, config-as-code like the reference: the thermosphere
world marched to equilibrium and animated, its equilibrium sensitivity to
insolation, the staged lw->sw tau ramp, and the ice-albedo stellar sweep.
Every march's lw walk is K1 on the card.  :func:`run_radiation_script`
runs them with the reference's sizes by default; its parameters shrink
each block.
"""
import numpy as np
import torch

from ..constants import F_sun, p_surface_earth
from ..models.grey import GreyGas
from ..models.ice_albedo import GreyAlbedoFeedback
from . import out_path, parse_args, pyplot, say_fn
from .staged_tau_ramp import run_staged_tau_ramp

'''Analytic solution with short wave (radiation_script.py:15-22)'''
# p_width_lw = 100000
# alpha_sw = od.get_exponential_alpha(p_width_lw) / 5
# p_width_sw = od.get_exponential_p_width(alpha_sw)
# grey_world = GreyGas(nz='auto', ny=ny, tau_lw_func='exponential',
#                      tau_lw_func_args=[p_width_lw, 4],
#                      tau_sw_func='exponential',
#                      tau_sw_func_args=[p_width_sw, 0.6])


def run_radiation_script(nz='auto', ny=1, conv_adjust=False, flux_thresh=1e-1,
                         n_plot_frames=30, ramp_kwargs=None,
                         sweep_values=np.arange(600, 2250, 150.0),
                         sweep_nz=40, sweep_ny=16, save_figures=True,
                         out_dir=None, verbose=True, device='cuda',
                         dtype=torch.float32):
    """The four blocks in order; returns a dict of their results.

    :param nz: the thermosphere world's grid ('auto': the reference's).
    :param n_plot_frames: frames of the thermosphere animation (0: none).
    :param ramp_kwargs: arguments of ``run_staged_tau_ramp`` over the
        reference's (None: the reference's experiment on nz='auto').
    :param sweep_values: stellar constants of the ice-albedo sweep.
    :param save_figures: write the animations and figures to ``out_dir``
        (default ``build/examples/``); False draws nothing and needs no
        matplotlib.
    """
    say = say_fn(verbose)
    out = {}

    '''With thermosphere (radiation_script.py:33-36)'''
    grey_world = GreyGas(nz=nz, ny=ny,
                         tau_lw_func='scale_height_and_peak_in_atmosphere',
                         tau_lw_func_args=[51000, 4, 100, 600, 0.1],
                         tau_sw_func='scale_height_and_peak_in_atmosphere',
                         tau_sw_func_args=[p_surface_earth, 0.12, 100, 20,
                                           0.002],
                         dtype=dtype, device=device)

    '''Approach to equilibrium (radiation_script.py:38-52)'''
    T_eqb = None
    correct = True
    if grey_world.ny == 1:
        up_eqb, down_eqb, T_eqb, up_sw_eqb, down_sw_eqb, correct = \
            grey_world.equilibrium_sol(convective_adjust=conv_adjust)
    data = grey_world.evolve_to_equilibrium(flux_thresh=flux_thresh,
                                            convective_adjust=conv_adjust,
                                            save=True)
    if save_figures and n_plot_frames > 0:
        from ..diagnostics.animation import Animate
        pyplot()
        anim = Animate(grey_world, data['T'], data['t'], T_eqb, correct,
                       nPlotFrames=n_plot_frames).anim
        anim.save(out_path(out_dir, 'grey_equilibrium.gif'), writer='pillow',
                  fps=10)
    say(f'thermosphere world: nz={grey_world.nz}, '
        f'T surface={grey_world.T[0, 0]:.1f} K')
    out.update(world=grey_world, data=data, T_eqb=T_eqb)

    '''Equilibrium climate sensitivity WITHOUT re-marching (framework extra:
    one Jacobian + one solve at the marched equilibrium,
    diagnostics/sensitivity; the exact grey oracle dT*/dF = T*/(4F)
    cross-checks it in place)'''
    from ..diagnostics import sensitivity

    dT_dF = sensitivity.grey_equilibrium_sensitivity(grey_world)  # K/(W/m^2)
    T_now = np.asarray(grey_world.T, np.float64)
    oracle = T_now / (4.0 * F_sun)
    act = np.abs(grey_world.forcing.dtau[0].cpu().numpy()) > 0.03
    rel_err = float(np.abs(dT_dF / oracle - 1)[act].max())
    say(f'insolation sensitivity: surface {dT_dF[0, 0]:.4f} K/(W/m^2) '
        f'(exact oracle {oracle[0, 0]:.4f}; active-region max |rel err| '
        f'{rel_err:.4f}; optically-thin levels are path-dependent and '
        'excluded)')
    out.update(dT_dF=dT_dF, oracle=oracle, sensitivity_rel_err=rel_err)

    '''Evolution with tau: staged lw->sw ramp (radiation_script.py:54-116)'''
    kw = dict(nz='auto', ny=ny, conv_adjust=conv_adjust, out_dir=out_dir,
              save_gif=save_figures, n_plot_frames=80 if save_figures else 0)
    kw.update(ramp_kwargs or {})
    ramp_world, ramp_data = run_staged_tau_ramp(**kw, device=device,
                                                dtype=dtype)
    say(f'staged tau ramp: {len(ramp_data["t"])} frames, final '
        f'T_surface={float(np.asarray(ramp_world.T)[0, 0]):.1f} K')
    out.update(ramp_world=ramp_world, ramp_data=ramp_data)

    '''Ice-albedo feedback: stellar-constant sweep
    (radiation_script.py:152-166)'''
    ice_albedo = GreyAlbedoFeedback(
        4.0, np.asarray(sweep_values, float), nz=sweep_nz, ny=sweep_ny,
        tau_lw_func='scale_height',
        tau_lw_func_args=[0.22 * p_surface_earth, 4.0], dtype=dtype,
        device=device)
    albedo_array, ice_latitude, T_surface = ice_albedo.run(
        0.1, delta_net_flux_thresh=1e-3, conv_adjust=conv_adjust,
        progress=verbose)
    if save_figures:
        plt = pyplot()
        ice_albedo.plot(ice_latitude, T_surface)
        plt.gcf().savefig(out_path(out_dir, 'ice_albedo_hysteresis.png'),
                          dpi=90)
        plt.close('all')
    say(f'ice-albedo sweep done: ice edge latitudes {ice_latitude}')
    out.update(ice_albedo=ice_albedo, ice_latitude=ice_latitude,
               T_surface=T_surface)
    return out


#: the configuration ``main()`` runs: the function's defaults, the
#: reference's
MAIN = {}


def main(argv=None):
    args = parse_args(__doc__.splitlines()[0], argv)
    run_radiation_script(**MAIN, save_figures=args.figures,
                         out_dir=args.out_dir, device=args.device,
                         dtype=args.dtype)


if __name__ == '__main__':
    main()
