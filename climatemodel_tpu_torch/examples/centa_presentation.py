"""Greenhouse-potential analysis (port of ``examples/centa_presentation.py``;
reference: centa_presentation/script.py).

Delta-OLR as greenhouse gas is added, at several scalings of a broadband
background absorber — the Arctic-amplification experiment
(centa_presentation/base.py:124-154): where the background absorber (H2O in
the reference) is scarce, each added unit of GHG bites harder into the OLR.
Then the greenhouse-activity spectrum (base.py:157-186).

The upstream raw HITRAN line lists are not distributed, so this demo
fabricates its background gas with the port's table generator
(``hitran.make_table`` through the line-accumulation backends): a broadband
'continuum' gas plays H2O.  The GHG is the reference's ``CO2_no_sw`` table
where the caller has it (``co2_table``); the reference does not ship it, so
by default the port's earth CO2 table (built from the shipped fabricated
line fixtures) plays it under that name.
"""
import os
import shutil
import tempfile

import numpy as np
import torch

from ..diagnostics import olr
from ..models.real_gas import RealGas
from ..spectral import earth_tables, hitran, humidity
from ..spectral.temperature_profiles import earth_temp
from . import out_path, parse_args, pyplot, say_fn


def build_tables(folder=None, co2_table=None, backend='auto', device=None):
    """The two tables in one folder: 'H2O_like', a weak broadband absorber
    (many broad overlapping lines across the long-wave window) made with
    ``hitran.make_table``, and 'CO2_no_sw', a copy of ``co2_table`` (default:
    the port's earth CO2 table)."""
    folder = folder or tempfile.mkdtemp(prefix='centa_tables_')
    lines = {'nu': np.linspace(50.0, 1450.0, 60),
             'sw': np.full(60, 40.0),
             'gamma_air': np.full(60, 2.0),
             'n_air': np.full(60, 0.7)}
    hitran.make_table(lines, wavenumber_array=np.arange(0.0, 1505.0, 10.0),
                      p_array=np.array([hitran.p_reference]),
                      T_array=np.array([hitran.T_reference]),
                      output_folder=folder, overwrite=True, backend=backend,
                      device=device)
    os.replace(hitran.table_path('custom', folder),
               hitran.table_path('H2O_like', folder))
    if co2_table is None:
        earth_folder, _ = earth_tables.ensure_earth_tables()
        co2_table = hitran.table_path('CO2', earth_folder)
    shutil.copyfile(co2_table, hitran.table_path('CO2_no_sw', folder))
    humidity.molecules.setdefault('H2O_LIKE', dict(humidity.molecules['H2O']))
    return folder


def run_centa(co2_table=None, h2o_scales=(1.0, 0.3, 0.05),
              co2_added=(0.0, 50.0, 100.0, 200.0, 400.0), nz=50,
              n_nu_bands=60, table_folder=None, save_png=True, verbose=True,
              out_dir=None, backend='auto', device='cuda',
              dtype=torch.float32):
    """Delta-OLR curves per background scaling and the activity spectrum.

    :return: dict with 'curves' {scale: Delta-OLR [len(co2_added)]},
        'co2_added', 'activity' (nu_c, activity).
    """
    say = say_fn(verbose)
    folder = build_tables(table_folder, co2_table, backend, device)

    def build(h2o_scale):
        return RealGas(nz=nz, ny=1,
                       molecule_names=['CO2_no_sw', 'H2O_like'],
                       q_funcs={'CO2_no_sw': humidity.constant_q,
                                'H2O_like': humidity.h2o},
                       q_funcs_args={'CO2_no_sw': (300.0, 'CO2'),
                                     'H2O_like': (h2o_scale,)},
                       table_folder=folder, T_func=earth_temp,
                       n_nu_bands=n_nu_bands, delta_temp_change=0.1,
                       dtype=dtype, device=device)

    co2_added = np.asarray(co2_added, float)
    curves = {}
    for scale in h2o_scales:
        tot, _ = olr.get_olr_area_add_ghg(build(scale), 'CO2_no_sw',
                                          co2_added, earth_temp)
        curves[scale] = tot - tot[0]
        say(f'background x{scale:g}: Delta-OLR at +{co2_added[-1]:g} ppmv '
            f'CO2 = {curves[scale][-1]:.3f} W/m^2')

    # greenhouse-activity spectrum (base.py:157-186)
    nu_c, act = olr.get_ghg_activity(build(1.0))

    if save_png:
        plt = pyplot()
        fig, ax = plt.subplots(1, 1, figsize=(8, 6))
        for scale in h2o_scales:
            ax.plot(co2_added, curves[scale], label=f'{scale:g}')
        ax.legend(title='background absorber\nscaling')
        ax.set_xlabel('CO2 added (ppmv)')
        ax.set_ylabel(r'$\Delta$OLR (W/m$^2$)')
        ax.set_title('GHG potency grows as the background absorber thins\n'
                     '(Arctic amplification mechanism)')
        fig.savefig(out_path(out_dir, 'arctic_amplification.png'), dpi=90)
        plt.close(fig)
        fig2, ax2 = plt.subplots(1, 1)
        ax2.plot(nu_c, act)
        ax2.set_xlabel('Wavenumber cm$^{-1}$')
        ax2.set_ylabel('GHG activity (-dT/dq per CO2-ppmv)')
        fig2.savefig(out_path(out_dir, 'ghg_activity.png'), dpi=90)
        plt.close(fig2)
        say('saved arctic_amplification.png and ghg_activity.png')
    return {'curves': curves, 'co2_added': co2_added,
            'activity': (nu_c, act)}


#: the configuration ``main()`` runs: the function's defaults, the
#: JAX script's
MAIN = {}


def main(argv=None):
    args = parse_args(__doc__.splitlines()[0], argv)
    run_centa(**MAIN, save_png=args.figures, out_dir=args.out_dir,
              device=args.device, dtype=args.dtype)


if __name__ == '__main__':
    main()
