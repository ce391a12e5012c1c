"""Command-line entry points of the PyTorch port:
``python -m climatemodel_tpu_torch <command>`` (port of
``climatemodel_tpu/cli.py``: the same commands, flags, defaults and JSON
records).

Commands:
  grey        grey-gas column march to radiative(-convective) equilibrium
  real-gas    HITRAN-band column march (toy gases or the earth-like tables)
  shallow     shallow-water scenario run (all nine reference scenarios)
  ice-albedo  stellar-constant hysteresis sweep (ice_albedo_feedback.py)

Every command runs on the card (``--device cuda``, the default) in float32
(``--dtype``); ``--device cpu`` and ``--dtype float64`` are the port's form
of the JAX package's ``JAX_PLATFORMS=cpu`` and ``JAX_ENABLE_X64``.  Without
a card and without ``--device cpu`` the command exits with an error.
"""
from __future__ import annotations

import argparse
import json


# ---------------------------------------------------------------------------
# shallow-water scenario registry (shallow_script.py:10-116 parameter blocks)
# ---------------------------------------------------------------------------

def shallow_scenario(name):
    """ShallowWater kwargs + run defaults for each reference scenario block."""
    import numpy as np
    from .constants import Omega, R_earth, g

    base = dict(nx=254, ny=50, dx=100e3, dy=100e3, dt=60.0, f_0=1e-4,
                beta=1.6e-11, r=0.0, g=g, linear=False,
                boundary_type={'x': 'periodic', 'y': 'walls'},
                orography_info=None)
    lo, hi = 9750.0, 10750.0
    run = dict(n_days=4.0, save_every=0.1 * 86400)
    if name == 'geostrophic_adjustment':        # shallow_script.py:29-36
        h0 = (base['f_0'] * base['dx']) ** 2 / g
        base.update(beta=0.0,
                    boundary_type={'x': 'walls', 'y': 'periodic'},
                    initial_info={'type': 'height_step', 'direction': 'x',
                                  'discontinuity_pos': 0,
                                  'min_h_surface': h0,
                                  'max_h_surface': h0 * 1.2,
                                  'add_noise': False})
    elif name == 'gravity_wave':                # shallow_script.py:38-45
        base.update(ny=254, f_0=0.0, beta=0.0,
                    initial_info={'type': 'height_gaussian',
                                  'min_h_surface': lo, 'max_h_surface': hi,
                                  'x0': -9487500.0, 'y0': 0.0,
                                  'x_std': 8 * base['dy'],
                                  'y_std': 8 * base['dy'],
                                  'add_noise': False})
        run['n_days'] = 1.5
    elif name == 'tsunami':                     # shallow_script.py:47-57
        base.update(ny=254, f_0=0.0, beta=0.0,
                    initial_info={'type': 'height_gaussian',
                                  'min_h_surface': lo, 'max_h_surface': hi,
                                  'x0': -9487500.0, 'y0': 0.0,
                                  'x_std': 8 * base['dy'],
                                  'y_std': 8 * base['dy'],
                                  'add_noise': False},
                    orography_info={'type': 'mountain', 'max_h_base': 9250.0,
                                    'x0': 0.0, 'y0': -12 * base['dy'],
                                    'x_std': 40 * base['dy'],
                                    'y_std': 40 * base['dy']})
        run['n_days'] = 1.5
    elif name == 'barotropic_instability':      # shallow_script.py:59-61
        base.update(initial_info={'type': 'jet_zonal', 'u_max': 400.0,
                                  'jet_width': base['dy'],
                                  'mean_h_surface': lo, 'y0': 0.0,
                                  'add_noise': True})
    elif name == 'jupiter_red_spot':            # shallow_script.py:63-66
        base.update(initial_info={'type': 'sinusoidal_zonal', 'u_max': 100.0,
                                  'n_periods': 1, 'mean_h_surface': lo,
                                  'y0': 0.0, 'add_noise': True})
        run['n_days'] = 10.0
    elif name == 'rossby_mountain_waves':       # shallow_script.py:68-74
        base.update(initial_info={'type': 'uniform_zonal',
                                  'mean_h_surface': 1000.0, 'u_mean': 10.0,
                                  'add_noise': False},
                    orography_info={'type': 'mountain', 'max_h_base': 500.0,
                                    'x0': 0.0, 'y0': 0.0,
                                    'x_std': 5 * base['dy'],
                                    'y_std': 5 * base['dy']})
        run['n_days'] = 10.0
    elif name == 'equatorial_waves':            # shallow_script.py:76-81
        base.update(f_0=0.0, beta=2.5e-10,
                    initial_info={'type': 'sinusoidal_zonal', 'u_max': 90.0,
                                  'n_periods': 1, 'mean_h_surface': lo,
                                  'y0': 0.0, 'add_noise': True})
        run['n_days'] = 10.0
    elif name == 'kelvin_wave':                 # shallow_script.py:83-91
        base.update(ny=100, f_0=0.0, beta=5e-10,
                    boundary_type={'x': 'walls', 'y': 'walls'},
                    initial_info={'type': 'height_gaussian',
                                  'min_h_surface': lo, 'max_h_surface': hi,
                                  'x0': 0.0, 'y0': 0.0,
                                  'x_std': 8 * base['dy'],
                                  'y_std': 8 * base['dy'],
                                  'add_noise': False})
        run['n_days'] = 1.0
    elif name == 'el_nino':                     # shallow_script.py:93-116
        h_mean, g_use = 100.0, 0.05
        c = np.sqrt(g_use * h_mean)
        beta = 2 * Omega / R_earth
        L = np.sqrt(c / beta)
        dx = L / 5
        nx, ny = int(round(30 * L / dx)), int(round(15 * L / dx))
        r = 1 / (10 * 30 * 24 * 3600)
        base.update(nx=nx, ny=ny, dx=dx, dy=dx, dt=0.01 * dx / c, f_0=0.0,
                    beta=beta, r=r, g=g_use,
                    boundary_type={'x': 'walls', 'y': 'walls',
                                   'y_walls_damp': {
                                       'dist_thresh': (ny / 2) * dx - 6 * dx,
                                       'r': r * 100}},
                    initial_info={'type': 'el_nino', 'max_h_surface': 110.0,
                                  'min_h_surface': 90.0, 'y_std': L,
                                  'add_noise': False,
                                  'wind': {'type': 'forced'}})
        run = dict(n_days=25.0, save_every=86400.0)
    else:
        raise SystemExit(f'unknown scenario {name!r}; choose from '
                         f'{sorted(SHALLOW_SCENARIOS)}')
    return base, run


SHALLOW_SCENARIOS = ('geostrophic_adjustment', 'gravity_wave', 'tsunami',
                     'barotropic_instability', 'jupiter_red_spot',
                     'rossby_mountain_waves', 'equatorial_waves',
                     'kelvin_wave', 'el_nino')

GREY_WORLDS = ('thermosphere', 'mesosphere', 'stratosphere', 'analytic_sw',
               'scale_height')


def grey_world_kwargs(name):
    """GreyGas kwargs for each radiation_script.py experiment block."""
    from .constants import p_surface_earth
    if name == 'thermosphere':          # radiation_script.py:32-36
        return dict(tau_lw_func='scale_height_and_peak_in_atmosphere',
                    tau_lw_func_args=[51000, 4, 100, 600, 0.1],
                    tau_sw_func='scale_height_and_peak_in_atmosphere',
                    tau_sw_func_args=[p_surface_earth, 0.12, 100, 20, 0.002])
    if name == 'mesosphere':            # radiation_script.py:27-31
        return dict(tau_lw_func='scale_height_and_peak_in_atmosphere',
                    tau_lw_func_args=[50000, 4, 1000, 600, 0.3],
                    tau_sw_func='peak_in_atmosphere',
                    tau_sw_func_args=[10000, 2000, 0.05])
    if name == 'stratosphere':          # radiation_script.py:23-26
        return dict(tau_lw_func='exponential', tau_lw_func_args=[100000, 4],
                    tau_sw_func='peak_in_atmosphere',
                    tau_sw_func_args=[30000, 2000, 0.5])
    if name == 'analytic_sw':           # radiation_script.py:15-22
        from .ops import optical_depth as od
        alpha_sw = od.get_exponential_alpha(100000) / 5
        return dict(tau_lw_func='exponential', tau_lw_func_args=[100000, 4],
                    tau_sw_func='exponential',
                    tau_sw_func_args=[od.get_exponential_p_width(alpha_sw),
                                      0.6])
    if name == 'scale_height':          # radiation_script.py:159-163
        return dict(tau_lw_func='scale_height',
                    tau_lw_func_args=[0.22 * p_surface_earth, 4.0])
    raise SystemExit(f'unknown grey world {name!r}; choose from '
                     f'{sorted(GREY_WORLDS)}')


def _add_common(p):
    p.add_argument('--out', default=None,
                   help='write the final state (npz checkpoint)')
    p.add_argument('--plot', default=None,
                   help='write the model plot (png path)')
    p.add_argument('--device', default='cuda',
                   help="torch device of the run ('cuda', 'cuda:1', 'cpu')")
    p.add_argument('--dtype', choices=['float32', 'float64'],
                   default='float32', help='float dtype of the state')


def _placement(args):
    import torch
    return dict(device=args.device, dtype=getattr(torch, args.dtype))


def _save_state(args, world):
    if args.out:
        from .utils.checkpoint import save_pytree
        save_pytree(args.out, world.state)
        print(f'state -> {args.out}')


def _agg():
    import matplotlib
    matplotlib.use('Agg')


def _cmd_grey(args):
    from .models.grey import GreyGas
    kw = grey_world_kwargs(args.world)
    world = GreyGas(nz='auto' if args.nz == 'auto' else int(args.nz),
                    ny=args.ny, **kw, **_placement(args))
    world.evolve_to_equilibrium(flux_thresh=args.flux_thresh, save=False,
                                convective_adjust=args.convective,
                                conv_method=args.conv_method,
                                verbose=args.verbose,
                                check_every=args.check_every,
                                dip_memory=args.dip_memory,
                                debug=args.debug)
    info = world._equilibrium_info
    out = {'world': args.world, 'nz': world.nz, 'ny': args.ny,
           'steps': int(info.steps),
           'T_surface': float(world.T[0].max()),
           'max_net_flux': float(abs(world.net_flux).max()),
           'model_days': float(world.state.t) / 86400.0}
    if args.sensitivity:
        from .diagnostics import sensitivity as _sens
        # convective marches use the RCE variant (pooled marginal-neutrality
        # solve); radiative ones the plain implicit-function-theorem solve
        dT = (_sens.grey_rce_equilibrium_sensitivity(world) if args.convective
              else _sens.grey_equilibrium_sensitivity(world))
        out['dT_surface_dF_stellar'] = float(dT[0].max())
    print(json.dumps(out))
    if args.plot:
        _agg()
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        ax.plot(world.T, world.p / 100.0)
        ax.set_yscale('log')
        ax.invert_yaxis()
        ax.set_xlabel('T (K)')
        ax.set_ylabel('p (hPa)')
        ax.set_title(f'{args.world}: equilibrium T(p)')
        fig.savefig(args.plot, dpi=90)
        print(f'plot -> {args.plot}')
    _save_state(args, world)


def _cmd_real_gas(args):
    from .models.real_gas import RealGas
    from .spectral import humidity
    if args.find_tg and not args.sweep:
        # validate BEFORE the (expensive) table + band construction
        raise SystemExit('--find-tg requires --sweep (the batched solve '
                         'runs over ensemble members)')
    if args.molecules == ['earth']:
        from .spectral import earth_tables
        earth_tables.ensure_earth_tables()
        kw = dict(molecule_names=['CO2', 'CH4', 'H2O', 'O3'], T_g=265.19,
                  p_toa=0.1)
    else:
        kw = dict(molecule_names=args.molecules)
        if args.molecules == ['single_line']:
            kw.update(q_funcs={'single_line': humidity.co2},
                      q_funcs_args={'single_line': ()}, T_g=265.0)
    gas = RealGas(nz='auto' if args.nz == 'auto' else int(args.nz), ny=1,
                  n_nu_bands=args.n_bands, **kw, **_placement(args))
    if args.sweep:
        # one lock-step march of all insolation-scaled members; optionally
        # solve each member's balanced T_g first
        import numpy as np
        from .models import ensemble
        lo, hi = args.sweep_range
        scales = np.linspace(lo, hi, args.sweep)
        states, sc, T_gs, margs = ensemble.real_gas_ensemble(
            gas, F_scales=scales)
        rec = {'molecules': kw['molecule_names'], 'nz': gas.nz,
               'sweep': [float(v) for v in scales]}
        if args.find_tg:
            # the solve marches at the reference's flux_thresh=0.1
            # (real_gas.py:530-562); --flux-thresh governs the final march
            T_gs, states, tg_info = ensemble.real_gas_find_Tg_ensemble(
                states, sc, T_gs, margs, verbose=args.verbose)
            rec['tg_converged'] = int(tg_info['converged'].sum())
        fs, info = ensemble.real_gas_evolve_ensemble(
            states, sc, T_gs, *margs, args.flux_thresh, t_end=20.0,
            check_every=args.check_every, dip_memory=args.dip_memory)
        eqb_np = info.equilibrium.cpu().numpy()
        Tg_np = T_gs.cpu().numpy()
        T_sfc = fs.T[:, -1, 0].cpu().numpy()
        rec.update({'converged': int(eqb_np.sum()),
                    'T_g': [round(float(v), 3) for v in Tg_np],
                    'T_surface_air': [round(float(v), 3) for v in T_sfc]})
        print(json.dumps(rec))
        if args.plot:
            _agg()
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots()
            ax.plot(scales, T_sfc, 'o-', label='surface air T')
            if args.find_tg:
                ax.plot(scales, Tg_np, 's--', label='solved T_g')
            ax.set_xlabel('insolation scale')
            ax.set_ylabel('T (K)')
            ax.legend()
            fig.savefig(args.plot, dpi=90)
            print(f'plot -> {args.plot}')
        if args.out:
            from .utils.checkpoint import save_pytree
            save_pytree(args.out, fs)
            print(f'ensemble states -> {args.out}')
        return
    gas.evolve_to_equilibrium(flux_thresh=args.flux_thresh, save=False,
                              verbose=args.verbose,
                              check_every=args.check_every,
                              dip_memory=args.dip_memory,
                              debug=args.debug)
    print(json.dumps({'molecules': kw['molecule_names'], 'nz': gas.nz,
                      'n_bands': args.n_bands, 'T_g': float(gas.T_g),
                      'T_surface_air': float(gas.T[-1, 0]),
                      'model_days': float(gas.state.t) / 86400.0}))
    if args.plot:
        _agg()
        ax = gas.plot_olr()
        ax.figure.savefig(args.plot, dpi=90)
        print(f'plot -> {args.plot}')
    _save_state(args, gas)


def _cmd_shallow(args):
    from .models.shallow_water import ShallowWater
    kw, run = shallow_scenario(args.scenario)
    if args.n_days is not None:
        run['n_days'] = args.n_days
    world = ShallowWater(numerical_solver=args.solver, **kw,
                         **_placement(args))
    data = world.run(n_days=run['n_days'], save_every=run['save_every'])
    print(json.dumps({'scenario': args.scenario,
                      'grid': [kw['nx'], kw['ny']],
                      'n_days': run['n_days'],
                      'snapshots': len(data['t']),
                      'final_t_days': float(world.state.t) / 86400.0}))
    if args.plot:
        _agg()
        if args.scenario == 'el_nino':
            fig = world.el_nino_plot(data['t'], data['h'])
        else:
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots()
            im = ax.pcolormesh(world.X[:, 0] / 1e3, world.Y[0, :] / 1e3,
                               world.h.T)
            fig.colorbar(im, ax=ax, label='h (m)')
            ax.set_xlabel('x (km)')
            ax.set_ylabel('y (km)')
        fig.savefig(args.plot, dpi=90)
        print(f'plot -> {args.plot}')
    _save_state(args, world)


def _cmd_ice_albedo(args):
    from .constants import p_surface_earth
    from .models.ice_albedo import GreyAlbedoFeedback
    import numpy as np
    sweep = GreyAlbedoFeedback(
        tau_lw_surface_values=4.0,
        stellar_constant_values=np.linspace(args.f_min, args.f_max,
                                            args.n_values),
        nz=args.nz, ny=args.ny,
        tau_lw_func='scale_height',
        tau_lw_func_args=[0.22 * p_surface_earth, 4.0], **_placement(args))
    _, ice_latitude, T_surface = sweep.run(
        delta_net_flux_thresh=args.flux_thresh)
    print(json.dumps({
        'F_values': [float(v) for v in sweep.changing_param_values],
        'ice_latitude': [float(v) for v in ice_latitude]}))
    if args.out:
        # the sweep has no single world state; save the sweep arrays
        out = args.out if args.out.endswith('.npz') else args.out + '.npz'
        np.savez(out, F_values=np.asarray(sweep.changing_param_values),
                 ice_latitude=np.asarray(ice_latitude),
                 T_surface=np.asarray(T_surface))
        print(f'sweep -> {out}')
    if args.plot:
        _agg()
        fig = sweep.plot(ice_latitude, T_surface)
        fig.savefig(args.plot, dpi=90)
        print(f'plot -> {args.plot}')


def _check_device(ap, args):
    """A CUDA device must exist when one is asked for: the CLI never falls
    back to the CPU."""
    import torch
    if torch.device(args.device).type == 'cuda' and \
            not torch.cuda.is_available():
        ap.error(f'--device {args.device}: no CUDA device is available '
                 '(pass --device cpu to run on the CPU)')


def main(argv=None):
    """Entry point of ``python -m climatemodel_tpu_torch`` (see README)."""
    ap = argparse.ArgumentParser(prog='climatemodel-tpu-torch',
                                 description=__doc__)
    sub = ap.add_subparsers(dest='cmd', required=True)

    p = sub.add_parser('grey', help='grey-gas equilibrium march')
    p.add_argument('--world', choices=sorted(GREY_WORLDS),
                   default='scale_height')
    p.add_argument('--nz', default='auto')
    p.add_argument('--ny', type=int, default=1)
    p.add_argument('--flux-thresh', type=float, default=1e-3)
    p.add_argument('--convective', action='store_true')
    p.add_argument('--sensitivity', action='store_true',
                   help='report dT_surface/dF_stellar at the marched '
                        'equilibrium (implicit differentiation, no '
                        're-march)')
    p.add_argument('--check-every', type=int, default=1,
                   help='evaluate the march exit criteria every N steps '
                        '(chunked exit; 1 = reference per-step cadence)')
    p.add_argument('--dip-memory', action='store_true',
                   help='with --check-every N: per-step exit statistics with '
                        'the carry frozen at the first stop event — '
                        'bit-identical to per-step cadence')
    p.add_argument('--conv-method', choices=['reference', 'isotonic'],
                   default='reference',
                   help='faithful group-blend (the default everywhere) or '
                        'the parallel isotonic variational form (the '
                        'iso_fit kernel on the card; different fixed '
                        'points)')
    p.add_argument('--debug', action='store_true',
                   help='checked march: a NaN/negative-T failure raises '
                        'with the first failing level/interface, step and '
                        'simulated time')
    p.add_argument('--verbose', action='store_true')
    _add_common(p)
    p.set_defaults(fn=_cmd_grey)

    p = sub.add_parser('real-gas', help='band-radiation equilibrium march')
    p.add_argument('--molecules', nargs='+', default=['single_line'],
                   help="molecule names, or the preset 'earth'")
    p.add_argument('--nz', default='auto')
    p.add_argument('--n-bands', type=int, default=40)
    p.add_argument('--flux-thresh', type=float, default=1e-3)
    p.add_argument('--sweep', type=int, default=0, metavar='N',
                   help='march N insolation-scaled members as one batched '
                        'ensemble instead of a single column')
    p.add_argument('--sweep-range', type=float, nargs=2, default=(0.9, 1.1),
                   metavar=('LO', 'HI'), help='insolation scale range')
    p.add_argument('--find-tg', action='store_true',
                   help="solve each sweep member's balanced ground "
                        'temperature first (batched secant; the solve '
                        "marches at the reference's flux_thresh=0.1)")
    p.add_argument('--check-every', type=int, default=1,
                   help='evaluate the march exit criteria every N steps '
                        '(chunked exit; 1 = reference per-step cadence)')
    p.add_argument('--dip-memory', action='store_true',
                   help='with --check-every N: per-step exit statistics with '
                        'the carry frozen at the first stop event — '
                        'bit-identical to the per-step cadence')
    p.add_argument('--debug', action='store_true',
                   help='checked march: a NaN/negative-T failure raises '
                        'with the first failing level/interface, step and '
                        'simulated time')
    p.add_argument('--verbose', action='store_true')
    _add_common(p)
    p.set_defaults(fn=_cmd_real_gas)

    p = sub.add_parser('shallow', help='shallow-water scenario run')
    p.add_argument('--scenario', choices=SHALLOW_SCENARIOS, default='el_nino')
    p.add_argument('--n-days', type=float, default=None)
    p.add_argument('--solver', default='richtmyer',
                   choices=['richtmyer', 'richtmyer_pallas', 'lax_friedrichs',
                            'lax_wendroff', 'maccormack'],
                   help="'richtmyer_pallas' runs the fused Richtmyer CUDA "
                        'kernel on the card; the others the plain schemes')
    _add_common(p)
    p.set_defaults(fn=_cmd_shallow)

    p = sub.add_parser('ice-albedo', help='stellar-constant hysteresis sweep')
    p.add_argument('--nz', type=int, default=30)
    p.add_argument('--ny', type=int, default=16)
    p.add_argument('--f-min', type=float, default=700.0)
    p.add_argument('--f-max', type=float, default=1500.0)
    p.add_argument('--n-values', type=int, default=5)
    # loose thresholds leave each sweep point far from equilibrium and the
    # next forcing jump can then crash the march (negative-T abort) — keep
    # the reference's tight default (ice_albedo_feedback.py:160)
    p.add_argument('--flux-thresh', type=float, default=1e-3)
    _add_common(p)
    p.set_defaults(fn=_cmd_ice_albedo)

    args = ap.parse_args(argv)
    _check_device(ap, args)
    args.fn(args)


if __name__ == '__main__':             # pragma: no cover
    main()
