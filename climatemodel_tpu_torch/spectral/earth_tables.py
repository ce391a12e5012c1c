"""Standalone earth-like spectroscopy fixtures (port of
``climatemodel_tpu/spectral/earth_tables.py``).

The upstream HITRAN line lists are not distributed, so the repository ships
FABRICATED line fixtures (``climatemodel_tpu/spectral/data/HitranData``:
CO2/CH4/H2O/O3 ``.txt`` line lists and O3/CFC12 ``.xsc`` cross sections)
from which the four earth lookup tables are built at first use:

  * ``fabricate_molecule_lines``: deterministic synthetic line lists — a
    few hundred Lorentzian lines clustered in each gas's real vibrational
    bands, with strengths tuned to earth-like optical depths.  Physically
    shaped test fixtures, not HITRAN parameters.
  * ``write_line_fixtures`` / ``write_uv_fixtures``: the fixture files, for
    a folder that lacks them (the port's own ``build/hitran_data/``; the
    shipped folder is never written).
  * ``ensure_earth_tables``: builds any missing CO2/CH4/H2O/O3 table into
    the port's table folder (``hitran.lookup_table_folder()``), with the
    stamp, crc and keep-user-tables rules of the JAX package.

Everything is seeded and reproducible; regenerating gives byte-identical
tables.
"""
from __future__ import annotations

import os
import warnings
import zlib

import numpy as np

from . import hitran
from .humidity import molecules

#: where the port writes fixture files the shipped folder lacks (git-ignored)
FIXTURE_DIR = os.path.join(os.path.dirname(hitran.BUILD_TABLE_DIR),
                           'hitran_data')

# HITRAN molecule ids used in the fabricated .txt line files
_HITRAN_ID = {name: molecules[name]['hitran_id'] for name in molecules}

# band recipes: (centre cm^-1, width cm^-1, n lines, peak HITRAN-native
# strength).  Strengths are in the native cm^-1/(molec cm^-2) unit that
# s_conversion rescales (hitran.py:127-135); magnitudes picked so surface
# optical depths land in the earth-like range (CO2 667 band tau ~ 10^1,
# H2O rotational band tau ~ 10^1-10^2, CH4/O3 ~ 10^0).
_BANDS = {
    'CO2': [(667.0, 60.0, 120, 3.0e-19),     # nu2 bending (15 um)
            (2349.0, 50.0, 60, 3.5e-18),     # nu3 asymmetric stretch (4.3 um)
            (1063.0, 30.0, 20, 4.0e-23)],    # weak laser bands
    'CH4': [(1306.0, 80.0, 100, 1.5e-19),    # nu4 bending (7.7 um)
            (3019.0, 60.0, 40, 1.0e-19)],    # nu3 stretch
    'H2O': [(200.0, 350.0, 180, 3.0e-19),    # pure rotation band
            (1595.0, 180.0, 120, 1.0e-19),   # nu2 bending (6.3 um)
            (3657.0, 150.0, 60, 5.0e-20)],   # stretch
    'O3': [(1042.0, 40.0, 60, 1.4e-19),      # nu3 (9.6 um)
           (701.0, 30.0, 30, 6.0e-21)],
}


def fabricate_molecule_lines(name, seed=0):
    """Deterministic synthetic line list dict (the make_table dict pathway,
    hitran.py:328-330) with HITRAN-native strength units."""
    # crc32, not hash(): str hashes are randomized per process and would make
    # "byte-identical regeneration" false across runs/machines
    rng = np.random.default_rng(zlib.crc32(f'{name}:{seed}'.encode()))
    nu, sw, gamma, n_air = [], [], [], []
    for centre, width, n, peak in _BANDS[name]:
        x = rng.uniform(-1.0, 1.0, n)
        nu.append(centre + x * width)
        # strengths fall off from the band centre, log-spread within the band
        sw.append(peak * np.exp(-2.0 * x ** 2)
                  * 10 ** rng.uniform(-1.5, 0.0, n))
        gamma.append(rng.uniform(0.04, 0.10, n))
        n_air.append(rng.uniform(0.5, 0.8, n))
    order = np.argsort(np.concatenate(nu))
    return {'nu': np.concatenate(nu)[order],
            'sw': np.concatenate(sw)[order],
            'gamma_air': np.concatenate(gamma)[order],
            'n_air': np.concatenate(n_air)[order]}


def _write_line_file(name, path, seed=0):
    """Write a fabricated HITRAN-style .txt line list (whitespace table with a
    header row of field names, the load_molecule_data layout)."""
    lines = fabricate_molecule_lines(name, seed)
    n = lines['nu'].size
    cols = {
        'molec_id': np.full(n, _HITRAN_ID[name], dtype=float),
        'local_iso_id': np.ones(n),
        'nu': lines['nu'],
        'sw': lines['sw'],
        'elower': np.zeros(n),
        'gamma_air': lines['gamma_air'],
        'n_air': lines['n_air'],
    }
    with open(path, 'w') as f:
        f.write(' '.join(cols) + '\n')
        for i in range(n):
            f.write(' '.join(f'{cols[k][i]:.6E}' for k in cols) + '\n')


def _write_xsc(path, molecule_label, nu_min, values, T=273.0):
    """Write a HITRAN .xsc cross-section file: tab-separated header
    (label, nu_min, nu_max, N, T, ...), then the N values plus one trailing
    dummy in full rows of 10 (the loader reads with genfromtxt and drops the
    final entry, hitran.py:250-312 — real files carry the same extra token)."""
    n = values.size
    assert (n + 1) % 10 == 0, 'xsc layout needs N = 9 (mod 10)'
    nu_max = nu_min + n - 1                       # spacing exactly 1 cm^-1
    with open(path, 'w') as f:
        f.write(f'{molecule_label}\t{nu_min:.4f}\t{nu_max:.4f}\t{n}\t'
                f'{T:.1f}\t0.0\t{values.max():.3E}\tsynthetic\t0\n')
        padded = np.concatenate([values, [0.0]])
        for row in padded.reshape(-1, 10):
            f.write(' ' + ' '.join(f'{v:.4E}' for v in row) + '\n')


def write_uv_fixtures(folder=None, overwrite=False):
    """Synthetic O3 UV (Hartley-band-like hump) and CFC12 IR cross-section
    files in ``folder`` (default: the port's own fixture folder)."""
    folder = folder or FIXTURE_DIR
    os.makedirs(folder, exist_ok=True)
    o3_path = os.path.join(folder, 'O3_UV_273.xsc')
    if overwrite or not os.path.isfile(o3_path):
        nu = np.arange(28901.0, 28901.0 + 1199.0)            # N = 1199
        # rising-baseline gaussian hump: the left tail must dip below the
        # final value so the symmetric-peak extrapolation of hitran.py:278-286
        # finds its anchor.  Magnitude is Huggins-band-like (~5e-20 cm^2 at
        # 330-345 nm): the Hartley peak value (1e-17) at these wavenumbers
        # would absorb ~100x the real near-UV heating and drive the micro-mass
        # TOA levels (p_toa = 0.1 Pa) into a >1500 K runaway the fabricated
        # LW opacity cannot re-emit
        vals = 5e-20 * np.exp(-0.5 * ((nu - 29800.0) / 300.0) ** 2) + 1e-23
        _write_xsc(o3_path, 'O3', 28901.0, vals)
    cfc_path = os.path.join(folder, 'CFC12.xsc')
    if overwrite or not os.path.isfile(cfc_path):
        nu = np.arange(810.0, 810.0 + 459.0)                 # N = 459
        vals = (1.1e-17 * np.exp(-0.5 * ((nu - 920.0) / 12.0) ** 2)
                + 1.4e-17 * np.exp(-0.5 * ((nu - 1160.0) / 10.0) ** 2)
                + 1e-22)
        _write_xsc(cfc_path, 'CCl2F2', 810.0, vals)
    return folder


def write_line_fixtures(folder=None, overwrite=False):
    """Fabricated .txt line lists for the four earth gases (the
    load_molecule_data pathway) in ``folder`` (default: the port's own
    fixture folder)."""
    folder = folder or FIXTURE_DIR
    os.makedirs(folder, exist_ok=True)
    for name in ('CO2', 'CH4', 'H2O', 'O3'):
        path = os.path.join(folder, name + '.txt')
        if overwrite or not os.path.isfile(path):
            _write_line_file(name, path)
    return folder


# wavenumber ranges for the fabricated tables (cover each gas's bands; O3's
# IR range must end below its UV fixture, hitran.py:296-297)
_NU_RANGE = {'CO2': (0.0, 2800.0), 'CH4': (0.0, 3400.0), 'H2O': (0.0, 4200.0),
             'O3': (0.0, 1400.0)}


_FIXTURE_FILES = ('CO2.txt', 'CH4.txt', 'H2O.txt', 'O3.txt',
                  'O3_UV_273.xsc', 'CFC12.xsc')


def _fixture_digest(folder=hitran.DEFAULT_LINE_DATA_DIR):
    """crc32 over the fixture files actually in ``folder`` — tables built
    from them are invalid the moment any fixture changes."""
    crc = 0
    for name in _FIXTURE_FILES:
        path = os.path.join(folder, name)
        if os.path.isfile(path):
            with open(path, 'rb') as f:
                crc = zlib.crc32(f.read(), crc)
    return f'{crc:08x}'


def fixture_folder():
    """The line-data folder the earth tables are built from: the shipped
    one when it holds every fixture file, else the port's own, where the
    missing fixtures are written first."""
    shipped = hitran.DEFAULT_LINE_DATA_DIR
    if all(os.path.isfile(os.path.join(shipped, n)) for n in _FIXTURE_FILES):
        return shipped
    write_line_fixtures(FIXTURE_DIR)
    write_uv_fixtures(FIXTURE_DIR)
    return FIXTURE_DIR


def ensure_earth_tables(output_folder=None, overwrite=False, verbose=False,
                        backend='auto', device=None):
    """First-boot table generation: build any missing CO2/CH4/H2O/O3 lookup
    tables from the fabricated fixtures into ``output_folder`` (default
    ``hitran.lookup_table_folder()``, the port's own).  ``backend`` and
    ``device`` pick the line accumulation
    (:func:`hitran.get_absorption_coefficient`).

    A stamp file in the table folder records the fixture digest the tables
    were built from; when the fixtures change, previously-built tables are
    rebuilt automatically instead of staying silently stale.  Tables that
    predate any stamp (possibly real user-dropped spectroscopy) are never
    clobbered unless ``overwrite``.

    :return: (table folder, names built by this call)
    """
    import json
    out = output_folder or hitran.lookup_table_folder()
    os.makedirs(out, exist_ok=True)
    data_folder = fixture_folder()
    digest = _fixture_digest(data_folder)
    stamp_path = os.path.join(out, '_earth_fixture_stamp.json')
    stamp = {}
    if os.path.isfile(stamp_path):
        try:
            with open(stamp_path) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict):
                stamp = loaded
        except (ValueError, OSError):
            pass        # corrupt stamp: treat every existing table as foreign
    old_digest = stamp.get('digest')
    # 'built' maps table name -> crc of the file WE wrote; a user who dropped
    # real spectroscopy over a fixture-built table changes that crc, and the
    # mismatch protects their file from a fixture-driven rebuild.  (Older
    # stamps stored a list — no hashes — so those entries rebuild on a
    # digest change, the pre-hash semantics.)
    built_map = stamp.get('built')
    if isinstance(built_map, list):
        built_map = {name: None for name in built_map}
    elif not isinstance(built_map, dict):
        built_map = {}
    stale = old_digest is not None and old_digest != digest

    def _crc(path):
        with open(path, 'rb') as f:
            return f'{zlib.crc32(f.read()):08x}'

    built = []
    kept_unstamped = []
    for name in ('CO2', 'CH4', 'H2O', 'O3'):
        path = hitran.table_path(name, out)
        if os.path.isfile(path) and not overwrite:
            ours = name in built_map and built_map[name] in (None, _crc(path))
            if not (stale and ours):
                if name not in built_map:
                    kept_unstamped.append(name)
                continue
        nu_min, nu_max = _NU_RANGE[name]
        wavenumbers = np.arange(nu_min, nu_max + hitran.table_dnu / 2,
                                hitran.table_dnu)
        hitran.make_table(name, wavenumber_array=wavenumbers,
                          data_folder=data_folder, output_folder=out,
                          overwrite=True, verbose=verbose, backend=backend,
                          device=device)
        built_map[name] = _crc(path)
        built.append(name)
    if kept_unstamped:
        # Tables that predate the stamp file may be user-dropped real
        # spectroscopy — but they may equally be fixture-built tables from a
        # release before a fixture fix (e.g. the O3 UV magnitude correction,
        # the exact class the digest mechanism targets).  Keep them, but say
        # so instead of marching silently on possibly-runaway-prone data.
        warnings.warn(
            f'lookup tables {kept_unstamped} in {out} predate the fixture '
            'stamp and were kept as-is; if they were built by an earlier '
            'release of this package (not dropped in by you), rebuild them '
            'with ensure_earth_tables(overwrite=True) or delete the files '
            'to pick up current fixture data')
    tmp = f'{stamp_path}.{os.getpid()}.tmp'
    with open(tmp, 'w') as f:
        json.dump({'digest': digest, 'built': built_map}, f)
    os.replace(tmp, stamp_path)
    return out, built
