"""HITRAN spectroscopy pipeline: line lists -> absorption-coefficient tables
(port of ``climatemodel_tpu/spectral/hitran.py``; reference
real_gas_data/hitran.py of the NumPy original).  Host NumPy float64.

Lookup tables are ``{p [np], T [nT], nu [n_nu], absorption_coef [np x nT x
n_nu]}`` dicts saved as .npy (hitran.py:315-357).  The line lists and the
two toy-gas tables ('single_line', 'gray') ship in the repository, in the
JAX package's data folder; this module reads them there by path and never
writes into it.  A table is looked up in ``$CLIMATEMODEL_TPU_TORCH_LUT_DIR``
(when set), then in the port's own table folder ``build/lookup_tables/`` at
the repository root (git-ignored), then, for the shipped toy gases, in the
shipped folder.  Tables are written to the first of the two writable
folders.  The four earth tables (CO2, CH4, H2O, O3) are built there from
the shipped line fixtures at first use (``earth_tables.ensure_earth_tables``).

The line accumulation is the host float64 windowed Lorentzian sum of the
JAX package's ``backend='numpy'`` (``_accumulate_numpy``), in its order, so
the tables are bit-equal to that backend's.
"""
from __future__ import annotations

import math
import os
from pathlib import Path

import numpy as np

from ..constants import (Avogadro, h_planck, k_boltzmann, p_one_atmosphere,
                         p_surface_earth, p_toa_earth, speed_of_light)
from .humidity import molecules

# reference conditions of HITRAN line parameters (hitran.py:29-30)
p_reference = p_one_atmosphere
T_reference = 296.0

# default table grids (hitran.py:35-37)
table_p_values = np.logspace(np.log10(p_surface_earth), np.log10(p_toa_earth),
                             200)
table_T_values = np.arange(250, 350 + 10, 20, dtype=float)
table_dnu = 10.0

required_fields = ['molec_id', 'local_iso_id', 'nu', 'sw', 'elower',
                   'gamma_air', 'n_air']

_REPO = Path(__file__).resolve().parents[2]
# the shipped spectroscopy data, read by path (never imported, never written)
_SHIPPED_DATA = _REPO / 'climatemodel_tpu' / 'spectral' / 'data'
DEFAULT_LINE_DATA_DIR = str(_SHIPPED_DATA / 'HitranData')
SHIPPED_TABLE_DIR = str(_SHIPPED_DATA / 'LookupTables')
#: the tables committed to the repository
SHIPPED_TABLES = ('single_line', 'gray')
#: where the port writes the tables it builds (git-ignored)
BUILD_TABLE_DIR = str(_REPO / 'build' / 'lookup_tables')
LUT_ENV = 'CLIMATEMODEL_TPU_TORCH_LUT_DIR'
EARTH_GASES = ('CO2', 'CH4', 'H2O', 'O3')


def lookup_table_folder():
    """The folder tables are written to: ``$CLIMATEMODEL_TPU_TORCH_LUT_DIR``
    or the port's own ``build/lookup_tables/``."""
    return os.environ.get(LUT_ENV) or BUILD_TABLE_DIR


def table_path(molecule_name, folder=None):
    """Path of a molecule's .npy lookup table in folder."""
    return os.path.join(folder or lookup_table_folder(), molecule_name + '.npy')


def find_table(molecule_name):
    """Path of the first table of this name in the search order (the
    writable folder, then the shipped one for the shipped toy gases), or
    None."""
    folders = [lookup_table_folder()]
    if molecule_name in SHIPPED_TABLES:
        folders.append(SHIPPED_TABLE_DIR)
    for folder in folders:
        path = table_path(molecule_name, folder)
        if os.path.isfile(path):
            return path
    return None


def load_table(molecule_name, folder=None):
    """Load a lookup table dict.  ``molecule_name`` may be a full .npy path,
    a bare name resolved in ``folder``, or a bare name found by
    :func:`find_table`; a missing earth gas (CO2, CH4, H2O, O3) is built
    from the shipped fixtures first (``earth_tables.ensure_earth_tables``)."""
    if molecule_name.endswith('.npy'):
        path = molecule_name
    elif folder is not None:
        path = table_path(molecule_name, folder)
    else:
        path = find_table(molecule_name)
        if path is None and molecule_name in EARTH_GASES:
            from .earth_tables import ensure_earth_tables
            ensure_earth_tables()
            path = find_table(molecule_name)
        if path is None:
            raise FileNotFoundError(
                f'no lookup table {molecule_name!r} in '
                f'{lookup_table_folder()}' + (
                    f' or {SHIPPED_TABLE_DIR}'
                    if molecule_name in SHIPPED_TABLES else ''))
    return np.load(path, allow_pickle=True).item()


# --------------------------------------------------------------------------
# line-parameter physics (hitran.py:127-179)
# --------------------------------------------------------------------------

def s_conversion(s, M):
    """Line intensity (cm^-1/(molec cm^-2)) -> (cm^-1 m^2 kg^-1)
    (hitran.py:127-135)."""
    return 0.1 * Avogadro / M * s


def gamma_extrapolate(p, T, gamma_reference, n):
    """Lorentz half-width at (p, T) from the reference-condition width
    (hitran.py:138-150; Pierrehumbert eq. 4.61)."""
    return gamma_reference * (p / p_reference) * (T_reference / T) ** n


def s_extrapolate(T, s_reference, wave_number_line_center, n):
    """Line-strength temperature scaling (hitran.py:153-167; eq. 4.62)."""
    freq = 100.0 * wave_number_line_center * speed_of_light
    return s_reference * (T / T_reference) ** n * \
        np.exp(-(h_planck * freq / k_boltzmann) * (1 / T - 1 / T_reference))


def lorentzian_profile(wave_number_array, wave_number_line_center, gamma):
    """Pressure-broadened line shape (hitran.py:170-179)."""
    return (1.0 / np.pi) * gamma / (gamma ** 2 +
                                     (wave_number_array
                                      - wave_number_line_center) ** 2)


# --------------------------------------------------------------------------
# line accumulation (hitran.py:182-247)
# --------------------------------------------------------------------------

def get_absorption_coefficient(p, T, wavenumber_array, molecule_data,
                               n_line_widths=1000, chunk=512):
    """Absorption-coefficient grid [np x n_nu]: sum of all lines of a molecule.

    Each line contributes over a window of +-n_line_widths half-widths around
    its centre (wavenumbers_near_line, hitran.py:182-199), accumulated on the
    host in float64 in chunks of ``chunk`` lines: the JAX package's
    ``backend='numpy'``, op for op."""
    p = np.asarray(p, dtype=np.float64)
    T = np.asarray(T, dtype=np.float64)
    nu_grid = np.asarray(wavenumber_array, dtype=np.float64)
    n_nu = nu_grid.size
    d_nu = nu_grid[1] - nu_grid[0] if n_nu > 1 else 1.0
    L = len(molecule_data['nu'])
    if L == 0:
        return np.zeros((p.size, n_nu))

    nu_l = np.asarray(molecule_data['nu'], dtype=np.float64)
    sw_l = np.asarray(molecule_data['sw'], dtype=np.float64)
    gam_l = np.asarray(molecule_data['gamma_air'], dtype=np.float64)
    nair_l = np.asarray(molecule_data['n_air'], dtype=np.float64)

    # per-line window half-size in bins, from the max gamma over the p column
    gamma_all = np.asarray(gam_l[None, :] * (p[:, None] / p_reference)
                           * (T_reference / T[:, None]) ** nair_l[None, :])
    n_w = (n_line_widths * gamma_all.max(axis=0) / d_nu).astype(int)
    W = int(min(2 * n_w.max() + 1, 2 * n_nu + 1))
    # nearest grid bin per line centre, ties to the lower index like argmin
    mid = 0.5 * (nu_grid[:-1] + nu_grid[1:])
    centre = np.searchsorted(mid, nu_l, side='left')                  # [L]

    hck = 100.0 * h_planck * speed_of_light / k_boltzmann
    rel = np.arange(W) - W // 2
    acc = np.zeros((p.size, n_nu))
    for s in range(0, L, chunk):
        e = min(s + chunk, L)
        nu_c, s_ref = nu_l[s:e], sw_l[s:e]
        g_ref, n_air = gam_l[s:e], nair_l[s:e]
        c_idx, half = centre[s:e], n_w[s:e]
        idx = c_idx[:, None] + rel[None, :]                      # [C, W]
        in_win = (np.abs(rel)[None, :] <= half[:, None]) & \
            (idx >= 0) & (idx <= n_nu - 1)
        idx_c = np.clip(idx, 0, n_nu - 1)
        gamma = g_ref[None, :] * (p[:, None] / p_reference) * \
            (T_reference / T[:, None]) ** n_air[None, :]         # [np, C]
        strength = s_ref[None, :] * (T[:, None] / T_reference) ** \
            n_air[None, :] * np.exp(-hck * nu_c[None, :]
                                    * (1 / T[:, None] - 1 / T_reference))
        shape = (1.0 / np.pi) * gamma[:, :, None] / (
            gamma[:, :, None] ** 2
            + (nu_grid[idx_c][None] - nu_c[None, :, None]) ** 2)
        vals = strength[:, :, None] * shape * in_win[None]
        np.add.at(acc, (np.arange(p.size)[:, None, None], idx_c[None]), vals)
    return acc


# --------------------------------------------------------------------------
# line-list IO (hitran.py:40-124)
# --------------------------------------------------------------------------

# the native HITRAN 160-character fixed-width record (the .par download
# format, hitranonline "160-char" / HITRAN2004+): leading field widths and
# names.  Only the first 9 fields are consumed (same set the reference's
# named-column format carries, hitran.py:40-58); the quanta/error/reference
# trailer (93 chars) is ignored.
_PAR_WIDTHS = [2, 1, 12, 10, 10, 5, 5, 10, 4, 8]
_PAR_NAMES = ['molec_id', 'local_iso_id', 'nu', 'sw', 'a', 'gamma_air',
              'gamma_self', 'elower', 'n_air', 'delta_air']


def _looks_like_par(path):
    """Sniff a line file's format: the reference's .txt carries a named
    header ('molec_id ...'); a bare 160-char HITRAN record starts with the
    right-justified molecule id digits."""
    with open(path) as f:
        first = f.readline().rstrip('\n')
    if 'molec_id' in first:
        return False
    return len(first) >= sum(_PAR_WIDTHS) and \
        first[:3].strip().replace('.', '').isdigit()


def _parse_par(path):
    """Parse a HITRAN 160-char fixed-width .par line file into column
    arrays (the format hitranonline serves for bulk line downloads)."""
    data = np.genfromtxt(path, delimiter=_PAR_WIDTHS, names=_PAR_NAMES,
                         autostrip=True)
    data = np.atleast_1d(data)
    return {name: np.asarray(data[name], dtype=np.float64)
            for name in _PAR_NAMES}


def load_molecule_data(molecule_name, data_folder=None):
    """Load a HITRAN line list, keep the main isotopologue, convert
    intensities (hitran.py:40-58).

    Accepts BOTH upstream formats, resolved per file:

    * ``<mol>.txt`` with a named-column header (the reference's genfromtxt
      format, hitran.py:40-53), parsed with np.genfromtxt;
    * ``<mol>.par`` (or a headerless ``<mol>.txt``) in the native HITRAN
      160-character fixed-width record format — what hitranonline's bulk
      download serves, so real line lists drop in unmodified.
    """
    folder = data_folder or DEFAULT_LINE_DATA_DIR
    par_file = os.path.join(folder, molecule_name + '.par')
    molecule_file = os.path.join(folder, molecule_name + '.txt')
    if os.path.isfile(par_file):
        cols = _parse_par(par_file)
    elif os.path.isfile(molecule_file) and _looks_like_par(molecule_file):
        cols = _parse_par(molecule_file)
    else:
        data = np.genfromtxt(molecule_file, names=True)
        cols = {name: data[name] for name in data.dtype.names}
    keep = np.logical_and(cols['molec_id'] ==
                          molecules[molecule_name]['hitran_id'],
                          cols['local_iso_id'] == 1)
    out = {field: cols[field][keep] for field in required_fields[2:]}
    out['sw'] = s_conversion(out['sw'], molecules[molecule_name]['M'])
    return out


def get_wavenumber_array(molecule_data, dwavenumber=10, bin_spacing=500,
                         hist_thresh=100, n_line_widths=1000):
    """Auto wavenumber range from a strength-weighted line histogram
    (hitran.py:71-111)."""
    weights = molecule_data['sw'].copy()
    with np.errstate(divide='ignore'):
        small = np.log10(weights) < -5
    weights[small] = 99
    weights[weights < 1] = 1
    weights[weights == 99] = 0.1
    weights[weights > 100] = 100

    nu = molecule_data['nu']
    g = molecule_data['gamma_air']
    bins = np.arange(nu.min() - n_line_widths * g[nu.argmin()],
                     nu.max() + n_line_widths * g[nu.argmax()]
                     + bin_spacing - 2, bin_spacing)
    hist, _ = np.histogram(nu, bins, weights=weights)
    below = np.where(hist < hist_thresh)[0]
    clusters = np.split(below, np.where(np.diff(below) != 1)[0] + 1) \
        if below.size else []
    if not np.any(below == 0):
        bin_min = 0
    else:
        bin_min = max(clusters[0]) + 1
    if not np.any(below == len(hist) - 1):
        bin_max = len(hist)
    else:
        bin_max = min(clusters[-1])
    wavenumber_min = dwavenumber * round(math.floor(bins[bin_min] / dwavenumber))
    wavenumber_max = dwavenumber * round(math.ceil(bins[bin_max] / dwavenumber))
    return np.arange(wavenumber_min, wavenumber_max + dwavenumber / 2,
                     dwavenumber)


def update_molecule_data(molecule_data, wavenumber_array):
    """Drop lines outside the wavenumber range (hitran.py:114-124)."""
    keep = np.logical_and(molecule_data['nu'] >= wavenumber_array.min(),
                          molecule_data['nu'] <= wavenumber_array.max())
    return {key: molecule_data[key][keep] for key in molecule_data}


# --------------------------------------------------------------------------
# UV cross-section data (hitran.py:250-312)
# --------------------------------------------------------------------------

def load_from_cross_section_xsc(wavenumber_array, p_array, T_array,
                                molecule='O3', data_folder=None,
                                return_raw=False):
    """Read a HITRAN .xsc UV cross-section file and extend the IR grid with
    pressure/temperature-independent UV absorption (O3 extrapolated
    symmetrically about its peak, 10 cm^-1 boxcar-averaged)."""
    folder = data_folder or DEFAULT_LINE_DATA_DIR
    name = {'O3': 'O3_UV_273.xsc', 'CFC12': 'CFC12.xsc'}.get(molecule.upper())
    if name is None:
        raise ValueError('Molecule is not valid')
    file = os.path.join(folder, name)
    with open(file) as f:
        header = f.readline().rstrip().split('\t')
    min_nu, max_nu, N_nu = float(header[1]), float(header[2]), int(header[3])
    nu = np.linspace(min_nu, max_nu, N_nu)
    d_nu_raw = nu[1] - nu[0]
    absorption = np.genfromtxt(file, skip_header=1).flatten()[:-1]
    absorption = s_conversion(absorption, molecules[molecule.upper()]['M'])
    if return_raw:
        return nu, absorption
    if molecule.upper() == 'O3':
        # extrapolate beyond the data assuming symmetry about the peak
        max_ind = absorption.argmax()
        rep_end = np.where(absorption < absorption[-1])[0]
        rep_end = rep_end[rep_end < max_ind][-1]
        repeat_nu = nu[:rep_end + 1] - nu.min() + d_nu_raw + nu[-1]
        nu = np.concatenate((nu, repeat_nu))
        absorption = np.concatenate((absorption,
                                     absorption[:rep_end + 1][::-1]))
    # boxcar-average onto the coarse (10 cm^-1) grid
    d_nu_target = int(round(wavenumber_array[1] - wavenumber_array[0]))
    kernel = np.ones(d_nu_target + 1) / (d_nu_target + 1)
    nu_conv = np.convolve(nu, kernel, mode='valid')
    abs_conv = np.convolve(absorption, kernel, mode='valid')
    use = np.divmod(nu_conv, d_nu_target)[1] == 0
    nu_final = nu_conv[use]
    abs_final = abs_conv[use]
    abs_final[0] = 1e-15   # so the UV-IR gap reads as zero absorption
    if nu_final[0] < wavenumber_array[-1]:
        raise ValueError('UV and IR wavenumber regions overlap')
    wavenumber_final = np.concatenate((wavenumber_array, nu_final))
    grid = np.zeros((np.size(p_array), np.size(T_array),
                     np.size(wavenumber_final)))
    uv_index = np.where(wavenumber_final.reshape(-1, 1) == nu_final)[0]
    grid[:, :, uv_index] = abs_final
    return wavenumber_final, grid


# --------------------------------------------------------------------------
# table construction (hitran.py:315-357)
# --------------------------------------------------------------------------

def make_table(molecule_name, p_array=table_p_values, T_array=table_T_values,
               dwavenumber=table_dnu, n_line_widths=1000,
               wavenumber_array=None, data_folder=None, output_folder=None,
               overwrite=False, verbose=False):
    """Build and save a [np x nT x n_nu] absorption-coefficient lookup table.

    ``molecule_name`` may be a molecule string (requires a HITRAN .txt line
    file) or a dict of line arrays for fabricated/toy gases
    (real_gas_script.py:16-25)."""
    if isinstance(molecule_name, dict):
        molecule_data = molecule_name
        molecule_name = 'custom'
    out_folder = output_folder or lookup_table_folder()
    os.makedirs(out_folder, exist_ok=True)
    output_file = table_path(molecule_name, out_folder)
    if os.path.isfile(output_file) and not overwrite:
        raise ValueError('Lookuptable file already exists')
    p_array = np.asarray(p_array, dtype=np.float64)
    T_array = np.asarray(T_array, dtype=np.float64)
    if molecule_name.lower() not in ('custom', 'cfc12'):
        molecule_data = load_molecule_data(molecule_name, data_folder)
    elif wavenumber_array is None:
        raise ValueError(
            f'wavenumber_array must be specified for molecule={molecule_name}')
    if wavenumber_array is None:
        wavenumber_array = get_wavenumber_array(molecule_data, dwavenumber,
                                                n_line_widths=n_line_widths)
    if molecule_name.lower() not in ('custom', 'cfc12'):
        molecule_data = update_molecule_data(molecule_data, wavenumber_array)
    if molecule_name.upper() in ('O3', 'CFC12'):
        wavenumber_array, grid = load_from_cross_section_xsc(
            wavenumber_array, p_array, T_array, molecule=molecule_name,
            data_folder=data_folder)
    else:
        grid = np.zeros((p_array.size, T_array.size, wavenumber_array.size))
    final = {'p': p_array, 'T': T_array,
             'nu': np.asarray(wavenumber_array, dtype=np.float64)}
    if molecule_name.upper() != 'CFC12':
        for i in range(T_array.size):
            if verbose:
                print(f'Obtaining absorption coefficient {i + 1}/{T_array.size}')
            T = np.ones_like(p_array) * T_array[i]
            grid[:, i, :] += get_absorption_coefficient(
                p_array, T, wavenumber_array, molecule_data, n_line_widths)
    final['absorption_coef'] = grid
    _save_atomic(output_file, final)
    return final


def _save_atomic(path, table):
    """np.save to ``path`` through a temporary file beside it, so a reader
    (or a second process building the same table) never sees half a file."""
    tmp = f'{path[:-4]}.{os.getpid()}.tmp.npy'
    np.save(tmp, table)   # type: ignore[arg-type]
    os.replace(tmp, path)


# --------------------------------------------------------------------------
# diagnostics
# --------------------------------------------------------------------------

def plot_absorption_coefficient(molecule_name, p_plot, T_plot, ax=None,
                                do_plot=True, folder=None):
    """Absorption coefficient vs wavenumber at the table's nearest (p, T)
    (hitran.py:360-387).  With ``do_plot=False`` returns (nu, k) arrays."""
    table = load_table(molecule_name, folder)
    p_index = int(np.abs(table['p'] - p_plot).argmin())
    T_index = int(np.abs(table['T'] - T_plot).argmin())
    absorption_coef = table['absorption_coef'][p_index, T_index]
    if not do_plot:
        return table['nu'], absorption_coef
    import matplotlib.pyplot as plt
    if ax is None:
        fig, ax = plt.subplots(1, 1)
    else:
        fig = ax.figure
    ax.plot(table['nu'], absorption_coef)
    ax.set_yscale('log')
    ax.set_ylim((1e-10, max(1e6, float(absorption_coef.max()))))
    visible = np.where(absorption_coef > 1e-10)[0]
    if visible.size:
        ax.set_xlim(table['nu'].min(), table['nu'][visible[-1]])
    ax.set_xlabel('Wavenumber cm$^{-1}$')
    ax.set_ylabel('Absorption coefficient (m$^2$/kg)')
    ax.set_title(f"{molecule_name} at "
                 f"({int(round(table['T'][T_index]))} K, "
                 f"{int(round(table['p'][p_index]))} Pa), air-broadened")
    return fig, ax


# --------------------------------------------------------------------------
# shipped toy gases (the reference's spectroscopy test fixtures)
# --------------------------------------------------------------------------

def make_single_line_table(output_folder=None, overwrite=True):
    """Toy gas: one wide strong line at the Planck peak
    (real_gas_script.py:16-25)."""
    folder = output_folder or lookup_table_folder()
    final = table_path('single_line', folder)
    # the overwrite guard must protect the FINAL file: make_table writes the
    # 'custom' temp name and os.replace would clobber single_line.npy
    if os.path.isfile(final) and not overwrite:
        raise ValueError('Lookuptable file already exists')
    line = {'nu': np.array([525.0]), 'sw': np.array([500.0]),
            'gamma_air': np.array([0.1]), 'n_air': np.array([0.7])}
    table = make_table(line, wavenumber_array=np.arange(320, 722, 10,
                                                        dtype=float),
                       p_array=np.array([p_reference]),
                       T_array=np.array([T_reference]),
                       output_folder=output_folder, overwrite=True)
    os.replace(table_path('custom', folder), final)
    return table


def make_gray_table(k=1.0, nu_max=5000.0, output_folder=None, overwrite=True):
    """Toy gas: constant absorption coefficient k over 0..nu_max
    (coast_talk gray fixture)."""
    nu = np.arange(0.0, nu_max + table_dnu / 2, table_dnu)
    grid = np.full((1, 1, nu.size), float(k))
    final = {'p': np.array([p_reference]), 'T': np.array([T_reference]),
             'nu': nu, 'absorption_coef': grid}
    folder = output_folder or lookup_table_folder()
    os.makedirs(folder, exist_ok=True)
    path = table_path('gray', folder)
    if os.path.isfile(path) and not overwrite:
        raise ValueError('Lookuptable file already exists')
    _save_atomic(path, final)
    return final
