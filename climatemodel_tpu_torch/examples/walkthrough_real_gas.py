"""Walkthrough: real-gas radiation — CO2 band saturation vs CH4 potency
(port of ``examples/walkthrough_real_gas.py``).

Runnable translation of the reference's Real Gas Radiation 2 notebook
(cells 16-27), using the earth tables the port builds from the shipped
fabricated line fixtures (``spectral/earth_tables.py``; real line lists drop
in through ``spectral/hitran.make_table``).

The experiment: impose the Earth temperature profile T(p)
(``spectral/temperature_profiles.earth_temp`` — no marching, pure
diagnostics), build the 4-gas earth atmosphere, and watch the outgoing
long-wave radiation (OLR) spectrum as greenhouse gases are added:

* **CO2 is saturated.** Its main band takes a deep bite out of the OLR
  already at present concentration; DOUBLING CO2 barely moves the total OLR
  because the band centre is optically thick — only the band wings deepen
  (notebook cells 19-20).
* **CH4 is not.** Adding the SAME MASS of methane instead (the
  mass-equivalent multiplier, notebook cell 22: added_ppmv_mol =
  added_ppmv_co2 * M_CO2 / M_mol) removes more OLR per kilogram — its band
  sits in a spectral window and is far from saturation (cells 21-24).

Energy conservation is the greenhouse effect here: the OLR area must
ultimately match absorbed sunlight, so a deeper bite forces the surface to
warm until the area is restored (cell 13's interpretation).

Each per-composition flux recomputation is the port's packed-band
transmission on the model's device (``diagnostics/olr.update_flux``).
"""
import numpy as np
import torch

from ..diagnostics import olr
from ..models.real_gas import RealGas
from ..spectral import earth_tables, humidity
from ..spectral.temperature_profiles import earth_temp
from . import out_path, parse_args, pyplot, say_fn

# surface ppmv at the default compositions (notebook cell 22's table)
SURFACE_BASE_PPMV = {'CO2': 370.0, 'CH4': 1.75, 'H2O': 20000.0, 'O3': 7.9}


def mass_equivalent_multiplier(molecule, co2_multiplier):
    """Scale factor on ``molecule``'s base concentration adding the same MASS
    as scaling CO2 by ``co2_multiplier`` (notebook cell 22): if the question
    is 'y kg of molecule instead of y kg of CO2, what changes?', this is the
    multiplier to use."""
    added_ppmv_co2 = (np.asarray(co2_multiplier, float) - 1.0) \
        * SURFACE_BASE_PPMV['CO2']
    added_ppmv = added_ppmv_co2 * humidity.molecules['CO2']['M'] \
        / humidity.molecules[molecule]['M']
    return 1.0 + added_ppmv / SURFACE_BASE_PPMV[molecule]


def scaled_q_args(atmos, molecule, multiplier):
    """q_funcs_args with ``molecule``'s leading (concentration) argument
    scaled — the notebook's get_q_args_list for the default profiles, whose
    first argument is the surface ppmv (CO2) or a pure scale factor
    (CH4/H2O/O3; spectral/humidity.py)."""
    q_args = dict(atmos.q_funcs_args)
    base = q_args[molecule]
    first = (base[0] if len(base) else
             humidity.molecules[molecule]['q_args'][0])
    q_args[molecule] = (first * multiplier,) + tuple(base[1:])
    return q_args


def run_walkthrough(nz='auto', n_nu_bands=120,
                    co2_multipliers=(1.0, 2.0, 100.0), save_png=True,
                    verbose=True, out_dir=None, device='cuda',
                    dtype=torch.float32):
    say = say_fn(verbose)
    earth_tables.ensure_earth_tables()
    atmos = RealGas(nz=nz, ny=1, molecule_names=['CO2', 'CH4', 'H2O', 'O3'],
                    T_func=earth_temp, p_toa=0.1, n_nu_bands=n_nu_bands,
                    delta_temp_change=0.1, dtype=dtype, device=device)
    base_q_args = dict(atmos.q_funcs_args)
    lw = olr._lw_band_mask(atmos)
    centres = atmos.nu_bands['centre'][lw]
    base_area = olr.get_olr_area(atmos)
    say(f'earth atmosphere: nz={atmos.nz}, {n_nu_bands} bands, '
        f'baseline OLR area = {base_area:.1f} W/m^2')

    spectra = {'base': atmos.up_flux[0, lw].copy()}
    areas = {}
    # O3 rides along (notebook cells 26-27).  With REAL HITRAN data the
    # reference finds O3 the most potent of the three at equal added mass
    # (its 1042 cm^-1 band sits in the atmospheric window, unsaturated);
    # the fabricated fixture's O3 band is weaker relative to CH4, so the
    # ordering here is CH4 > O3 > CO2 — build tables from real line lists
    # to reproduce the reference's ordering.
    for mol in ('CO2', 'CH4', 'O3'):
        areas[mol] = []
        for mult in co2_multipliers:
            m = mult if mol == 'CO2' else \
                float(mass_equivalent_multiplier(mol, mult))
            olr.update_flux(atmos, scaled_q_args(atmos, mol, m), earth_temp)
            areas[mol].append(olr.get_olr_area(atmos))
            spectra[(mol, mult)] = atmos.up_flux[0, lw].copy()
        # restore the base composition for the next molecule
        olr.update_flux(atmos, base_q_args, earth_temp)

    say('\nDelta-OLR for the SAME ADDED MASS (CO2-equivalent multipliers '
        f'{list(co2_multipliers[1:])}):')
    for mol in ('CO2', 'CH4', 'O3'):
        d = [areas[mol][0] - a for a in areas[mol][1:]]
        say(f'  {mol}: ' + ', '.join(f'{x:8.3f} W/m^2' for x in d))
    dco2 = areas['CO2'][0] - areas['CO2'][1]
    dch4 = areas['CH4'][0] - areas['CH4'][1]
    say(f'\nCO2 doubling removes {dco2:.3f} W/m^2 of OLR; the same mass of '
        f'CH4 removes {dch4:.3f} W/m^2 — '
        f'{dch4 / max(dco2, 1e-9):.1f}x the bite per kilogram: the CO2 band '
        'centre is saturated, methane is not.')

    if save_png:
        plt = pyplot()
        fig, axs = plt.subplots(1, 2, figsize=(14, 5), sharey=True)
        for ax, mol in zip(axs, ('CO2', 'CH4')):
            ax.plot(centres, spectra['base'], label='present composition')
            for mult in co2_multipliers[1:]:
                lbl = (f'CO2 x {mult:g}' if mol == 'CO2' else
                       f'CH4 + same mass as CO2 x {mult:g}')
                ax.plot(centres, spectra[(mol, mult)], label=lbl)
            ax.set_xlabel(r'Wavenumber (cm$^{-1}$)')
            ax.set_xlim(0, 3000)
            ax.set_title(f'adding {mol}')
            ax.legend(fontsize=8)
        axs[0].set_ylabel(r'OLR (W m$^{-2}$ / cm$^{-1}$)')
        fig.suptitle('CO2 band saturation vs CH4 potency '
                     '(fixed Earth T(p); fabricated earth tables)')
        fig.tight_layout()
        path = out_path(out_dir, 'walkthrough_real_gas.png')
        fig.savefig(path, dpi=90)
        plt.close(fig)
        say(f'saved {path}')
    return {'areas': areas, 'base_area': base_area, 'atmos': atmos}


#: the configuration ``main()`` runs (the JAX script's)
MAIN = dict(nz='auto', n_nu_bands=200)


def main(argv=None):
    args = parse_args(__doc__.splitlines()[0], argv)
    run_walkthrough(**MAIN, save_png=args.figures, out_dir=args.out_dir,
                    device=args.device, dtype=args.dtype)


if __name__ == '__main__':
    main()
