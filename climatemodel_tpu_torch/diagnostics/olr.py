"""OLR-area / greenhouse-potential diagnostics on a RealGas atmosphere (port
of ``climatemodel_tpu/diagnostics/olr.py``; the reference presentation
analysis library, centa_presentation/base.py of the NumPy original):
fixed-temperature recomputation of tau and fluxes, OLR band areas,
CO2-mass-equivalent conversions, GHG-addition sweeps (the
Arctic-amplification experiment) and transmission-derivative "activity"
spectra.

Host NumPy on the fluxes a ``RealGas`` returns; the fluxes themselves come
from ``RealGas.get_flux`` on the model's device.
"""
from __future__ import annotations

import numpy as np

from ..constants import g
from ..ops import transmission as tr
from ..spectral import humidity

# np.trapz is gone from newer NumPy; np.trapezoid is the same rule
_trapezoid = getattr(np, 'trapezoid', None) or np.trapz


def update_tau(atmos, q_args, T_func):
    """Recompute tau_interface for a new composition at fixed T(p)
    (centa_presentation/base.py:38-50)."""
    atmos.q_funcs_args = q_args
    T_interface = np.asarray(T_func(atmos.p_interface[:, 0]))
    atmos._refresh_tau(T_interface)


def update_flux(atmos, q_args, T_func):
    """update_tau then refresh flux arrays (base.py:53-64)."""
    update_tau(atmos, q_args, T_func)
    atmos.up_flux, atmos.down_flux = atmos.get_flux()
    atmos.net_flux = (atmos.up_flux * atmos.nu_bands['delta']).sum(axis=1) - \
        (atmos.down_flux * atmos.nu_bands['delta']).sum(axis=1)


def eqv_ppmv(molecule, co2_ppmv):
    """ppmv of ``molecule`` with the same added mass as co2_ppmv of CO2
    (base.py:67-77)."""
    mass = co2_ppmv * humidity.molecules['CO2']['M']
    return mass / humidity.molecules[molecule.upper()]['M']


def _lw_band_mask(atmos):
    # the reference keys on the *second* nu of each band range (base.py:87-88)
    max_nu_band = np.array([rng[1] for rng in atmos.nu_bands['range']])
    return max_nu_band <= atmos.nu_lw.max()


def get_olr_area(atmos, flux=None):
    """Area under the OLR curve over the long-wave bands (base.py:80-92)."""
    lw = _lw_band_mask(atmos)
    if flux is None:
        flux = atmos.up_flux[0]
    return _trapezoid(flux[lw], atmos.nu_bands['centre'][lw])


def get_surface_up_flux_olr_area(atmos, olr_cont=None):
    """OLR area from attenuated surface emission only (base.py:189-206).

    The surface term is computed by the model itself
    (``get_flux(include_olr_breakdown=True)``, real_gas.py:643-665) — ONE
    source for the physics; pass a precomputed ``olr_cont`` to ride an
    existing flux evaluation instead of launching another."""
    if olr_cont is None:
        _, _, olr_cont = atmos.get_flux(include_olr_breakdown=True)
    lw = _lw_band_mask(atmos)
    return _trapezoid(np.asarray(olr_cont['surface'])[lw],
                    atmos.nu_bands['centre'][lw])


def get_olr_area_add_ghg(atmos, ghg_molecule, co2_ppmv_added, T_func):
    """OLR area vs added GHG mass (in CO2-equivalent ppmv); requires the GHG to
    use a constant_q profile (base.py:95-121)."""
    q_args_base = dict(atmos.q_funcs_args)
    if co2_ppmv_added[0] != 0:
        raise ValueError('co2_ppmv_added should have 0 as the first value as '
                         'we are interested in OLR reduction.')
    key = ghg_molecule.upper() if ghg_molecule.upper() in q_args_base \
        else ghg_molecule
    if not isinstance(q_args_base[key][1], str):
        raise ValueError(f'{ghg_molecule} should have a constant_q specific '
                         'humidity profile')
    tot_flux, surface_flux = [], []
    for co2_ppmv in co2_ppmv_added:
        q_args = dict(q_args_base)
        q_args[key] = (
            q_args_base[key][0] + eqv_ppmv(ghg_molecule.upper(), co2_ppmv),
            q_args_base[key][1])
        update_tau(atmos, q_args, T_func)
        up, down, olr_cont = atmos.get_flux(include_olr_breakdown=True)
        atmos.up_flux, atmos.down_flux = up, down
        d_nu = atmos.nu_bands['delta']
        atmos.net_flux = (up * d_nu).sum(axis=1) - (down * d_nu).sum(axis=1)
        tot_flux.append(get_olr_area(atmos))
        surface_flux.append(get_surface_up_flux_olr_area(atmos, olr_cont))
    return np.array(tot_flux), np.array(surface_flux)


def ghg_diff_initial_h2o_plot(ax, atmos, h2o_scale_factors, ghg_molecule,
                              co2_ppmv_added, T_func):
    """Delta-OLR vs added GHG at several H2O scalings — the Arctic-
    amplification experiment (base.py:124-154)."""
    q_args_base = dict(atmos.q_funcs_args)
    for h2o_scale in h2o_scale_factors:
        q_args = dict(q_args_base)
        q_args['H2O'] = (h2o_scale,)
        atmos.q_funcs_args = q_args
        tot_flux, _ = get_olr_area_add_ghg(atmos, ghg_molecule, co2_ppmv_added,
                                           T_func)
        label = (f'{h2o_scale:.1f}' if 0 < h2o_scale < 1
                 else f'{h2o_scale:.0f}')
        ax.plot(co2_ppmv_added, tot_flux - tot_flux[0], label=label)
    update_flux(atmos, q_args_base, T_func)
    ax.legend(title='Multiple of\n$H_2O$ concentration')
    ax.set_ylabel(r'$\Delta OLR$ (W/m$^2$)')
    ax.set_xlabel(f'Mass of {ghg_molecule} added ($CO_2$ ppmv)')
    return ax


def get_ghg_activity(atmos, molecule=None):
    """|d transmission / d q| surface->TOA per CO2-ppmv-equivalent mass of a
    k=1 absorber (or of ``molecule``'s spectrum), per long-wave band
    (base.py:157-186)."""
    if molecule is None:
        absorb = np.ones_like(atmos.nu)
    else:
        # any molecule's spectrum can be probed, like the reference's
        # load_absorption_coef (base.py:175) — not just atmosphere members
        table = atmos._tables.get(molecule)
        if table is None:
            from ..spectral import hitran
            table = hitran.load_table(molecule, atmos.table_folder)
            atmos._tables[molecule] = table      # cache for sweep loops
        absorb = tr.crop_lookup(np.array([atmos.p_surface]),
                                np.array([atmos.T_g]), atmos.nu,
                                table).flatten()
    lw = ~atmos.nu_bands['sw']
    pk = atmos._packed
    p1 = atmos.p_interface[0, 0]      # TOA
    p2 = atmos.p_interface[-1, 0]     # surface
    mass_conv = humidity.humidity_from_ppmv(1, 'CO2')
    nu_centres = atmos.nu_bands['centre'][lw]
    out = np.zeros(lw.sum())
    for i, b in enumerate(np.where(lw)[0]):
        idx = pk.idx[b]
        w = pk.w[b]
        tau_band = atmos.tau_interface[[0, -1]][:, idx]
        val = tr.dtransmission_dq(p1, p2, tau_band, w, pk.delta[b],
                                  absorb[idx], g)
        out[i] = float(val)
    return nu_centres, -out * mass_conv


def plot_T_q(atmos, log_q=True):
    """Temperature + composition profile plot (base.py:16-34)."""
    import matplotlib.pyplot as plt
    fig, axs = plt.subplots(1, 2, figsize=(18, 6), sharey=True)
    axs[0].plot(atmos.T, atmos.p)
    axs[0].invert_yaxis()
    axs[0].set_yscale('log')
    axs[0].set_ylabel('Pressure / Pa')
    axs[0].set_xlabel('Temperature / K')
    for name in atmos.molecule_names:
        M_name = 'CO2' if name not in humidity.molecules else name
        axs[1].plot(humidity.ppmv_from_humidity(
            np.asarray(atmos.q_funcs[name](atmos.p[:, 0],
                                           *atmos.q_funcs_args[name])), M_name),
            atmos.p, label=name)
    if log_q:
        axs[1].set_xscale('log')
    axs[1].set_xlabel('Volume Mixing Ratio (ppmv)')
    axs[1].legend()
    return fig
