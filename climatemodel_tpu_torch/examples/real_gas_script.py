"""Real-gas band radiation experiments (port of
``examples/real_gas_script.py``; the reference's real_gas_script.py).

The upstream raw HITRAN line lists are not distributed; the Earth-composition
run uses the earth tables the port builds at first use from the shipped
fabricated line fixtures (``spectral/earth_tables.py``, through the
line-accumulation backends of ``spectral/hitran``) — build tables from real
line lists with ``hitran.make_table`` into ``$CLIMATEMODEL_TPU_TORCH_LUT_DIR``
to upgrade it to true spectroscopy.  The animated run uses the
``single_line`` toy gas (the reference's own fixture,
real_gas_script.py:16-25).
"""
import numpy as np
import torch

from ..models import ensemble
from ..models.real_gas import RealGas
from ..spectral import earth_tables, humidity
from . import out_path, parse_args, pyplot, say_fn

'''Making hitran absorption coef data (real_gas_script.py:15-25)'''
# from climatemodel_tpu_torch.spectral import hitran
# hitran.make_single_line_table()          # fabricated toy gas
# hitran.make_table('CO2', wavenumber_array=np.arange(0, 1505, 10.0))

'''Evolving CO2 conc - GHG ladder (real_gas_script.py:27-40): the reference
marches each concentration sequentially; the port's
ensemble.real_gas_compos_ensemble marches the whole ladder as one batch with
a per-member optical depth (stacked_tau=True)'''
# def with_co2(multiplier):              # reference pattern: full-arg dicts
#     base = dict(earth.q_funcs_args)
#     base['CO2'] = (base['CO2'][0] * multiplier, *base['CO2'][1:])
#     return RealGas(nz=50, ny=1, molecule_names=['CO2', 'CH4', 'H2O', 'O3'],
#                    T_g=265.19, temp_change=1, delta_temp_change=0.1,
#                    q_funcs_args=base)
# ladder = [with_co2(m) for m in (1.0, 50.0)]
# states, sc, T_gs, largs = ensemble.real_gas_compos_ensemble(ladder)
# fs, info = ensemble.real_gas_evolve_ensemble(
#     states, sc, T_gs, *largs, 1e-3, stacked_tau=True)
# # ... and the 'finding list of ground temp eqb' variant: every ladder rung's
# # T_g solved at once (each trial one batched march)
# Tg, _, info = ensemble.real_gas_find_Tg_ensemble(
#     states, sc, T_gs, largs, stacked_tau=True)


def run_real_gas_script(nz='auto', earth_t_end=20.0, n_members=16,
                        ensemble_bands=200, single_line_t_end=2.0,
                        n_plot_frames=70, conv_adjust=False,
                        save_figures=True, out_dir=None, verbose=True,
                        device='cuda', dtype=torch.float32):
    """The three runs in order; returns a dict of their results.

    :param nz: the earth columns' grid ('auto': the reference's).
    :param earth_t_end: model years the earth column may march.
    :param n_members: insolation-sweep members.
    :param save_figures: write the figures and the animation to ``out_dir``
        (default ``build/examples/``); False draws nothing and needs no
        matplotlib.
    """
    say = say_fn(verbose)
    out = {}

    '''Earth composition (real_gas_script.py:43-59): earth tables built on
    first run; marching the 4-gas column to equilibrium'''
    earth_tables.ensure_earth_tables()
    earth = RealGas(nz=nz, ny=1, molecule_names=['CO2', 'CH4', 'H2O', 'O3'],
                    T_g=265.19, p_toa=0.1, temp_change=1,
                    delta_temp_change=0.1, dtype=dtype, device=device)
    # t_end=20: the reference's 2-model-year cap stops ~70 steps short of
    # true convergence for this composition (delta 1.2e-2 vs the 1e-3
    # threshold)
    earth.evolve_to_equilibrium(flux_thresh=1e-3, save=False,
                                t_end=earth_t_end,
                                convective_adjust=conv_adjust)
    if save_figures:
        plt = pyplot()
        ax = earth.plot_olr()
        ax.figure.savefig(out_path(out_dir, 'real_gas_earth_olr.png'), dpi=90)
        plt.close('all')
    eq = earth._equilibrium_info
    say(f'earth column: nz={earth.nz}, '
        f'bands={len(earth.nu_bands["delta"])}, '
        f'T surface={earth.T[-1, 0]:.1f} K, '
        f'equilibrium={bool(eq.equilibrium)}')
    out.update(earth=earth, earth_info=eq)

    '''Insolation sweep as one batched ensemble (framework extra): earth
    columns sharing the transmission cache march together.  200
    Planck-equalised bands (the centa scale): at the default 40 bands the
    chunkier band fluxes drive some members into oscillatory limit cycles
    above the 1e-3 threshold.'''
    earth200 = RealGas(nz=nz, ny=1,
                       molecule_names=['CO2', 'CH4', 'H2O', 'O3'],
                       T_g=265.19, p_toa=0.1, n_nu_bands=ensemble_bands,
                       temp_change=0.5, delta_temp_change=0.1, dtype=dtype,
                       device=device)
    states, sc, T_gs, eargs = ensemble.real_gas_ensemble(
        earth200, F_scales=np.linspace(0.9, 1.1, n_members))
    fs, info = ensemble.real_gas_evolve_ensemble(
        states, sc, T_gs, *eargs, 1e-3, t_end=20.0)
    eqb_np = info.equilibrium.cpu().numpy()
    T_sfc = fs.T[:, -1, 0].cpu().numpy()
    say(f'insolation sweep: {int(eqb_np.sum())}/{n_members} converged, '
        f'surface-air T {float(T_sfc.min()):.1f}..'
        f'{float(T_sfc.max()):.1f} K')
    out.update(sweep_converged=eqb_np, sweep_T_surface=T_sfc)

    '''Single-line toy gas'''
    gas = RealGas(nz=nz, ny=1, molecule_names=['single_line'], T_g=265.19,
                  q_funcs={'single_line': humidity.co2},
                  q_funcs_args={'single_line': ()}, delta_temp_change=0.1,
                  dtype=dtype, device=device)
    flux_dict = {'lw_up': [], 'lw_down': [], 'sw_up': [], 'sw_down': []}
    data = {'t': [], 'T': [], 'flux': flux_dict}
    data = gas.save_data(data, 0)
    data = gas.evolve_to_equilibrium(data, flux_thresh=1e-3,
                                     convective_adjust=conv_adjust,
                                     t_end=single_line_t_end, save=True)
    if save_figures:
        from ..diagnostics.animation import Animate
        plt = pyplot()
        if n_plot_frames > 0:
            anim = Animate(gas, data['T'], data['t'], flux_array=data['flux'],
                           nPlotFrames=n_plot_frames).anim
            anim.save(out_path(out_dir, 'real_gas_equilibrium.gif'),
                      writer='pillow', fps=10)
        ax = gas.plot_olr()
        ax.figure.savefig(out_path(out_dir, 'real_gas_olr.png'), dpi=90)
        ax2 = gas.plot_incoming_short_wave()
        ax2.figure.savefig(out_path(out_dir, 'real_gas_sw.png'), dpi=90)
        plt.close('all')
    say(f'real gas: nz={gas.nz}, T_g={gas.T_g:.2f} K, '
        f'T surface={gas.T[-1, 0]:.1f} K')
    out.update(gas=gas, data=data)
    return out


#: the configuration ``main()`` runs: the function's defaults, the
#: JAX script's
MAIN = {}


def main(argv=None):
    args = parse_args(__doc__.splitlines()[0], argv)
    run_real_gas_script(**MAIN, save_figures=args.figures,
                        out_dir=args.out_dir, device=args.device,
                        dtype=args.dtype)


if __name__ == '__main__':
    main()
