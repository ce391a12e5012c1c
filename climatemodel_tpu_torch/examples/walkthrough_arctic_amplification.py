"""Walkthrough: Arctic amplification — GHG potency grows where H2O is scarce
(port of ``examples/walkthrough_arctic_amplification.py``).

Runnable translation of the reference's Arctic Amplification notebook
(cells 0-5).

The observation (notebook cell 0): surface warming under increased CO2/CH4 is
LARGER at high latitudes than the global mean.  The notebook's candidate
mechanism is water vapour: CO2 and CH4 are well mixed (same concentration at
every latitude) but H2O falls steeply toward the poles, and H2O absorbs over
much of the same long-wave spectrum.  Where H2O is abundant it already
blankets the bands a new GHG would block — the added gas removes little extra
OLR.  Where H2O is scarce the same added mass bites much harder.

The mechanism lives entirely in SPECTRAL OVERLAP, so this walkthrough
fabricates its own gas set with the port's table generator (the upstream
raw HITRAN line lists are not distributed): CO2 and CH4 keep their real band
positions (spectral/earth_tables.fabricate_molecule_lines) while the H2O
stand-in is a broadband absorber whose overlapping Lorentzians blanket the
whole long-wave range — the role real H2O's rotational band, continuum and
far wings play.  (The standalone earth fixtures deliberately leave a clean
atmospheric window, so on THEM the overlap term is ~zero and every curve
collapses — build tables from real line lists with ``hitran.make_table`` to
run this on genuine spectroscopy.)

The experiment (notebook cell 3, diagnostics/olr.ghg_diff_initial_h2o_plot):
impose the Earth temperature profile T(p) (no marching, pure diagnostics),
scale the H2O profile by factors standing in for latitude (1 = tropics,
0.001 = polar winter), and for each scaling compute OLR as CO2 (left panel)
or the SAME MASS of CH4 (right panel, CO2-ppmv-equivalent x-axis, the
notebook's convention) is added.  A larger |Delta OLR| at the same added
mass is a larger radiative forcing — and the forcing must ultimately be paid
back by surface warming, so dry (polar) columns warm more: arctic
amplification.

The tables come from ``hitran.make_table`` through the line-accumulation
backends (``backend``: 'auto' is the C++ library where it builds, else
PyTorch on the device).  Every per-composition flux recomputation is the
port's packed-band transmission on the model's device
(diagnostics/olr.update_flux); CO2 and CH4 use constant-ppmv profiles so the
added-mass bookkeeping is exact (olr.get_olr_area_add_ghg's contract,
reference base.py:95-121).
"""
import os
import tempfile

import numpy as np
import torch

from ..diagnostics import olr
from ..models.real_gas import RealGas
from ..spectral import earth_tables, hitran, humidity
from ..spectral.temperature_profiles import earth_temp
from . import out_path, parse_args, pyplot, say_fn

H2O_SCALES = (1.0, 0.25, 0.1, 0.001)        # notebook cell 3's h2o_scales


def build_overlap_tables(folder=None, backend='auto', device=None):
    """Fabricate CO2/CH4 at their real band positions plus a broadband
    H2O stand-in whose wide Lorentzians blanket the long-wave range (the
    centa arctic experiment's recipe, centa_presentation/base.py:124-154),
    all on one shared wavenumber grid."""
    folder = folder or tempfile.mkdtemp(prefix='arctic_tables_')
    n = 120
    # strengths on the make_table DICT pathway are POST-s_conversion
    # (cm^-1 m^2 kg^-1, hitran.py:127-135 semantics) — the fabricated
    # fixtures carry HITRAN-native values because they travel through the
    # .txt loader, which applies s_conversion itself; here we apply it
    # explicitly.  gamma_air=2 makes each H2O-like line ~20x broader than
    # the fixtures' so 120 of them blanket the range as a pseudo-continuum.
    # strength tuned so the scale-1 blanket is PARTIAL (measured: Delta-OLR
    # for +400 CO2-eq ppmv of CH4 is 3.7 W/m^2 at scale 1 vs 13.0 at 0.001 —
    # 3.5x; fully opaque or fully transparent blankets both flatten the
    # curves to equality)
    h2o_like = {'nu': np.linspace(50.0, 3350.0, n),
                'sw': np.full(n, 100.0),
                'gamma_air': np.full(n, 2.0),
                'n_air': np.full(n, 0.7)}

    def converted(name):
        lines = dict(earth_tables.fabricate_molecule_lines(name))
        lines['sw'] = hitran.s_conversion(lines['sw'],
                                          humidity.molecules[name]['M'])
        return lines

    for name, lines, nu_max in (('CO2', converted('CO2'), 2800.0),
                                ('CH4', converted('CH4'), 3400.0),
                                ('H2O', h2o_like, 3400.0)):
        if os.path.isfile(hitran.table_path(name, folder)):
            continue
        # the earth fixtures' uniform-grid recipe (earth_tables.py:236-240):
        # the narrow fabricated lines' strengths are tuned for exactly this
        # 10 cm^-1 sampling of their Lorentzian wings
        wavenumbers = np.arange(0.0, nu_max + hitran.table_dnu / 2,
                                hitran.table_dnu)
        hitran.make_table(lines, wavenumber_array=wavenumbers,
                          output_folder=folder, backend=backend,
                          device=device)
        os.replace(hitran.table_path('custom', folder),
                   hitran.table_path(name, folder))
    return folder


def run_walkthrough(nz='auto', n_nu_bands=60,
                    co2_ppmv_added=(0.0, 100.0, 200.0, 400.0),
                    table_folder=None, save_png=True, verbose=True,
                    out_dir=None, backend='auto', device='cuda',
                    dtype=torch.float32):
    say = say_fn(verbose)
    folder = build_overlap_tables(table_folder, backend, device)
    atmos = RealGas(nz=nz, ny=1, molecule_names=['CO2', 'CH4', 'H2O'],
                    q_funcs={'CO2': humidity.constant_q,
                             'CH4': humidity.constant_q,
                             'H2O': humidity.h2o},
                    q_funcs_args={'CO2': (370.0, 'CO2'),
                                  'CH4': (1.75, 'CH4'),
                                  'H2O': (1.0,)},
                    table_folder=folder, T_func=earth_temp, p_toa=0.1,
                    n_nu_bands=n_nu_bands, delta_temp_change=0.1,
                    dtype=dtype, device=device)
    co2_ppmv_added = np.asarray(co2_ppmv_added, float)
    say(f'overlap atmosphere: nz={atmos.nz}, {n_nu_bands} bands, baseline '
        f'OLR area = {olr.get_olr_area(atmos):.1f} W/m^2')

    # Delta-OLR vs added mass, per H2O scaling (the notebook's two panels)
    base_q_args = dict(atmos.q_funcs_args)
    curves = {}
    for mol in ('CO2', 'CH4'):
        for h2o_scale in H2O_SCALES:
            q_args = dict(base_q_args)
            q_args['H2O'] = (h2o_scale,)
            atmos.q_funcs_args = q_args
            tot, _ = olr.get_olr_area_add_ghg(atmos, mol, co2_ppmv_added,
                                              earth_temp)
            curves[(mol, h2o_scale)] = tot - tot[0]
        olr.update_flux(atmos, base_q_args, earth_temp)

    say('\n|Delta OLR| for the LAST added-mass point '
        f'({co2_ppmv_added[-1]:.0f} CO2-eq ppmv), by H2O scaling:')
    amp = {}
    for mol in ('CO2', 'CH4'):
        row = {s: -curves[(mol, s)][-1] for s in H2O_SCALES}
        amp[mol] = row[H2O_SCALES[-1]] / max(row[H2O_SCALES[0]], 1e-9)
        say(f'  {mol}: ' + ', '.join(f'x{s:g}: {row[s]:6.2f} W/m^2'
                                     for s in H2O_SCALES))
        say(f'       -> the driest column feels {amp[mol]:.1f}x the forcing '
            'of the moistest')
    say('\nWell-mixed GHGs force dry (polar) columns hardest; the forcing is '
        'repaid by surface warming, so the poles warm more — arctic '
        'amplification (notebook cell 4).')

    if save_png:
        plt = pyplot()
        fig, axs = plt.subplots(1, 2, figsize=(14, 5), sharex=True,
                                sharey=True)
        for ax, mol in zip(axs, ('CO2', 'CH4')):
            for s in H2O_SCALES:
                ax.plot(co2_ppmv_added, curves[(mol, s)], marker='o',
                        label=f'{s:g}')
            ax.set_xlabel(f'mass of {mol} added (CO2-equivalent ppmv)')
            ax.set_title(f'Changing {mol}')
        axs[0].set_ylabel(r'$\Delta$OLR (W/m$^2$)')
        axs[1].legend(title='multiple of\n$H_2O$ concentration', fontsize=8)
        fig.suptitle('GHG forcing grows as the background H2O thins '
                     '(fixed Earth T(p); fabricated overlap gas set)')
        fig.tight_layout()
        path = out_path(out_dir, 'walkthrough_arctic_amplification.png')
        fig.savefig(path, dpi=90)
        plt.close(fig)
        say(f'saved {path}')
    return {'curves': curves, 'amplification': amp, 'atmos': atmos}


#: the configuration ``main()`` runs (the JAX script's)
MAIN = dict(nz='auto', n_nu_bands=120)


def main(argv=None):
    args = parse_args(__doc__.splitlines()[0], argv)
    run_walkthrough(**MAIN, save_png=args.figures, out_dir=args.out_dir,
                    device=args.device, dtype=args.dtype)


if __name__ == '__main__':
    main()
