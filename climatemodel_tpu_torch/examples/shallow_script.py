"""Shallow-water experiments (port of ``examples/shallow_script.py``;
the reference's shallow_script.py).

All nine scenario configs are listed (commented) exactly like the
reference; El Nino runs by default, with the plain Richtmyer stencils
(``numerical_solver='richtmyer'``, as the reference; ``'richtmyer_pallas'``
runs the fused step kernel K6 on the card).  The whole run stays on the
device and is read back once.
"""
import numpy as np
import torch

from ..constants import Omega, R_earth
from ..models.shallow_water import ShallowWater
from . import out_path, parse_args, pyplot, say_fn

"""Default values (shallow_script.py:10-27)"""
# n_days = 4; nx = 254; ny = 50; dt = 60.0; dx = 100.0e3; dy = dx
# min_h_surface = 9750; max_h_surface = min_h_surface + 1000
# f_0 = 1e-4; beta = 1.6e-11
# boundary_type = {'x': 'periodic', 'y': 'walls'}
# orography_info = None; r = 0; g_use = g; linear = False
# save_every = 0.1; initial_info = None

"""Geostrophic adjustment (shallow_script.py:29-36)"""
# deform_radius = dx * 1
# min_h_surface = (f_0 * deform_radius) ** 2 / g
# initial_info = {'type': 'height_step', 'direction': 'x',
#                 'discontinuity_pos': 0, 'min_h_surface': min_h_surface,
#                 'max_h_surface': min_h_surface * 1.2, 'add_noise': False}
# beta = 0
# boundary_type = {'x': 'walls', 'y': 'periodic'}

"""Gravity wave (shallow_script.py:38-45)"""
# n_days = 1.5; ny = nx; f_0 = 0; beta = 0
# initial_info = {'type': 'height_gaussian', 'min_h_surface': min_h_surface,
#                 'max_h_surface': max_h_surface, 'x0': -9487500, 'y0': 0,
#                 'x_std': 8 * dy, 'y_std': 8 * dy, 'add_noise': False}

"""Tsunami (shallow_script.py:47-57): gravity wave + sea-floor mountain"""
# orography_info = {'type': 'mountain', 'max_h_base': 9250, 'x0': 0,
#                   'y0': -12 * dy, 'x_std': 40 * dy, 'y_std': 40 * dy}

"""Barotropic instability (shallow_script.py:59-61)"""
# initial_info = {'type': 'jet_zonal', 'u_max': 400, 'jet_width': dy,
#                 'mean_h_surface': min_h_surface, 'y0': 0, 'add_noise': True}

"""Jupiter red spot (shallow_script.py:63-66)"""
# n_days = 10
# initial_info = {'type': 'sinusoidal_zonal', 'u_max': 100, 'n_periods': 1,
#                 'mean_h_surface': min_h_surface, 'y0': 0, 'add_noise': True}

"""Rossby mountain waves (shallow_script.py:68-74)"""
# n_days = 10
# initial_info = {'type': 'uniform_zonal', 'mean_h_surface': 1000,
#                 'u_mean': 10, 'add_noise': False}
# orography_info = {'type': 'mountain', 'max_h_base': 500, 'x0': 0, 'y0': 0,
#                   'x_std': 5 * dy, 'y_std': 5 * dy}

"""Equatorially trapped waves (shallow_script.py:76-81)"""
# n_days = 10; f_0 = 0; beta = 2.5e-10
# initial_info = {'type': 'sinusoidal_zonal', 'u_max': 90, 'n_periods': 1,
#                 'mean_h_surface': min_h_surface, 'y0': 0, 'add_noise': True}

"""Equatorial Kelvin wave (shallow_script.py:83-91)"""
# ny = 100; n_days = 1; f_0 = 0; beta = 5e-10
# initial_info = {'type': 'height_gaussian', 'min_h_surface': min_h_surface,
#                 'max_h_surface': max_h_surface, 'x0': 0, 'y0': 0,
#                 'x_std': 8 * dy, 'y_std': 8 * dy, 'add_noise': False}
# boundary_type = {'x': 'walls', 'y': 'walls'}


def el_nino_config():
    """The El Nino scenario (shallow_script.py:93-116): the ShallowWater
    arguments and the run's default n_days and save_every."""
    f_0 = 0
    h_mean = 100
    g_use = 0.05
    c = np.sqrt(g_use * h_mean)
    beta = 2 * Omega / R_earth
    L_def = np.sqrt(c / beta)
    dx = L_def / 5
    dy = dx
    nx = int(round(30 * L_def / dx))
    ny = int(round(15 * L_def / dy))
    dt = 0.01 * dx / c
    r = 1 / (10 * 30 * 24 * 60 ** 2)          # 16-month damping
    boundary_type = {'x': 'walls', 'y': 'walls',
                     'y_walls_damp': {'dist_thresh': (ny / 2) * dy - 6 * dy,
                                      'r': r * 100}}
    h_perturb = h_mean / 10
    initial_info = {'type': 'el_nino', 'max_h_surface': h_mean + h_perturb,
                    'min_h_surface': h_mean - h_perturb, 'y_std': L_def,
                    'add_noise': False, 'wind': {'type': 'forced'}}
    world_kw = dict(nx=nx, ny=ny, dx=dx, dy=dy, dt=dt, f_0=f_0, beta=beta,
                    initial_info=initial_info, boundary_type=boundary_type,
                    orography_info=None, r=r, g=g_use, linear=False)
    return world_kw, 25.0, 24 * 60 ** 2


def run_shallow_script(n_days=None, save_every=None,
                       numerical_solver='richtmyer', save_png=True,
                       out_dir=None, verbose=True, device='cuda',
                       dtype=torch.float32):
    """Run the El Nino scenario (shallow_script.py:119-136); returns
    (world, data_dict).  ``n_days`` and ``save_every`` default to the
    reference's 25 days and daily snapshots."""
    say = say_fn(verbose)
    world_kw, days, every = el_nino_config()
    n_days = days if n_days is None else n_days
    save_every = every if save_every is None else save_every
    shallow_world = ShallowWater(**world_kw,
                                 numerical_solver=numerical_solver,
                                 dtype=dtype, device=device)
    data_dict = shallow_world.run(n_days=n_days, save_every=save_every)
    say(f"ran {n_days} days on a {world_kw['nx']}x{world_kw['ny']} grid "
        f"({len(data_dict['t'])} snapshots)")
    if save_png:
        plt = pyplot()
        fig = shallow_world.el_nino_plot(data_dict['t'], data_dict['h'])
        path = out_path(out_dir, 'el_nino_thermocline.png')
        fig.savefig(path, dpi=90)
        plt.close(fig)
        say(f'saved {path}')
    return shallow_world, data_dict


#: the configuration ``main()`` runs: the function's defaults, the
#: reference's 25-day El Nino run with daily snapshots
MAIN = {}


def main(argv=None):
    args = parse_args(__doc__.splitlines()[0], argv)
    run_shallow_script(**MAIN, save_png=args.figures, out_dir=args.out_dir,
                       device=args.device, dtype=args.dtype)


if __name__ == '__main__':
    main()
