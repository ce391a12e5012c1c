"""Walkthrough: how the convective adjustment algorithm works (port of
``examples/walkthrough_convective_adjustment.py``).

Runnable translation of the reference's Convective Adjustment notebook —
same thermosphere example, same step-by-step construction, same enthalpy
printouts (notebook cells 10-12).

The physics: convection develops wherever the lapse rate is supercritical,
dT/dz < -gamma with gamma = g/c_p the dry adiabat.  In pressure coordinates
that is dtheta/dp > 0 for the potential temperature theta = T/(p/p0)^alpha
with alpha = R gamma / g (notebook eqs 5-9).  The adjustment flattens each
unstable run of levels onto a constant-theta (adiabatic) profile while
conserving column enthalpy H = -integral(T dp) (notebook eq 4):

1. march the thermosphere world to RADIATIVE equilibrium (on the card, K1
   in the march) — its lower atmosphere ends up convectively unstable;
2. find the connected unstable runs of levels (theta_diff < -1e-10 going
   up);
3. for the first run, build the TWO flattened candidate profiles — theta set
   to the value just above the run ('lower', cools) and to the value at its
   base ('upper', warms).  NEITHER conserves enthalpy;
4. blend them, T = beta*T_upper + (1-beta)*T_lower with beta chosen so the
   blend's enthalpy equals the original (eq 10-11);
5. repeat over all runs until stable — what
   ``climatemodel_tpu_torch.ops.convection.convective_adjustment`` (the
   faithful ``method='reference'``) runs on the world's device; the
   walkthrough checks that its output removes every unstable level at
   conserved enthalpy and lowers the surface temperature.

Steps 2-5 are :func:`adjust_profile`, on any given profile.
"""
import numpy as np
import torch

from ..constants import R_specific, c_p_dry, g, p_surface_earth
from ..models.grey import GreyGas
from ..ops.convection import convective_adjustment, get_enthalpy, get_theta
from . import out_path, parse_args, pyplot, say_fn


def find_unstable_groups(theta, small=1e-10):
    """Connected runs of unstable levels, exactly like the reference's
    groupby construction (convective_adjustment.py:60-71 / notebook cell 4):
    duplicate the last diff so the array matches the level count, flag
    theta_diff < -small (pressure is DEcreasing with index).  ``small`` may
    be a per-level array (the operator's dtype-aware tolerance)."""
    d = np.diff(theta)
    d = np.concatenate([d, d[-1:]])
    small = np.broadcast_to(np.asarray(small), d.shape)
    unstable = np.where(d < -small)[0]
    groups = []
    for lev in unstable:
        if groups and lev == groups[-1][-1] + 1:
            groups[-1].append(int(lev))
        else:
            groups.append([int(lev)])
    return groups


def candidate_profiles(T, theta, pi, group):
    """The notebook's get_adjust_theta (cell 6; convective_adjustment.py:74-94):
    flatten theta over the run anchored just ABOVE it ('lower') and at its
    BASE ('upper'), extending each flat region until the profile is stable."""
    n = T.size
    idx = np.arange(n)
    out = {}
    # 'lower': theta of the level just above the run, applied down to the
    # first level below it with smaller theta
    lo_anchor = min(group[-1] + 1, n - 1)
    theta_lo = theta[lo_anchor]
    low_levels = idx[(theta < theta_lo) & (idx < lo_anchor)]
    start = (low_levels.max() + 1) if low_levels.size else 0
    T_lower = T.copy()
    T_lower[start:lo_anchor + 1] = theta_lo * pi[start:lo_anchor + 1]
    out['lower'] = T_lower
    # 'upper': theta at the run's base, applied up to the first level above
    # with larger theta
    hi_anchor = group[0]
    theta_hi = theta[hi_anchor]
    hi_levels = idx[(theta > theta_hi) & (idx > hi_anchor)]
    stop = hi_levels.min() if hi_levels.size else n - 1
    T_upper = T.copy()
    T_upper[hi_anchor:stop + 1] = theta_hi * pi[hi_anchor:stop + 1]
    out['upper'] = T_upper
    return out


def _enthalpy(T, p):
    """Column enthalpy of host float64 arrays (``get_enthalpy`` on CPU
    tensors)."""
    return float(get_enthalpy(torch.tensor(np.asarray(T, np.float64)),
                              torch.tensor(np.asarray(p, np.float64))))


def adjust_profile(p, T0, dtype=torch.float32, device='cuda', verbose=True):
    """Steps 2-5 on the surface-first profile (p, T0): the unstable runs,
    the two candidates of the first run and their enthalpy-conserving blend
    (host float64), then the library operator on ``device`` in ``dtype``.

    :return: dict with theta0, groups, cand, H0, H_lo, H_hi, beta, T_blend,
        H_blend, T_adj, theta_adj, groups_after, H_adj.
    """
    say = say_fn(verbose)
    p = np.asarray(p, np.float64)
    T0 = np.asarray(T0, np.float64)
    lapse = g / c_p_dry
    alpha = R_specific * lapse / g
    pi = (p / p_surface_earth) ** alpha
    theta0 = np.asarray(get_theta(T0, p, p_surface_earth, alpha))
    groups = find_unstable_groups(theta0)
    say(f'unstable runs of levels (theta falling with height): '
        f'{[f"{gr[0]}-{gr[-1]}" for gr in groups]}')
    assert groups, 'the thermosphere profile should be unstable near the surface'

    # 3. candidate flattened profiles for the first (near-surface) run and
    #    their enthalpies — neither conserves H (notebook cell 10)
    H0 = _enthalpy(T0, p)
    cand = candidate_profiles(T0, theta0, pi, groups[0])
    H_lo = _enthalpy(cand['lower'], p)
    H_hi = _enthalpy(cand['upper'], p)
    say(f'Initial Enthalpy:    {H0:.6e}')
    say(f'theta_low Enthalpy:  {H_lo:.6e}   (cools: too little energy)')
    say(f'theta_upper Enthalpy:{H_hi:.6e}   (warms: too much energy)')

    # 4. the enthalpy-conserving blend (notebook eq 10-11)
    beta = (H0 - H_lo) / (H_hi - H_lo)
    T_blend = beta * cand['upper'] + (1 - beta) * cand['lower']
    H_blend = _enthalpy(T_blend, p)
    say(f'beta = {beta:.4f}')
    say(f'Final Enthalpy:      {H_blend:.6e}   '
        f'(conserved to {abs(H_blend / H0 - 1):.2e} relative)')
    assert abs(H_blend / H0 - 1) < 1e-12

    # 5. the library operator runs that iteration over ALL runs — stable
    #    everywhere, enthalpy conserved, surface cooled
    T_adj = convective_adjustment(
        torch.as_tensor(p, dtype=dtype, device=device),
        torch.as_tensor(T0, dtype=dtype, device=device),
        method='reference').cpu().numpy().astype(np.float64)
    theta_adj = np.asarray(get_theta(T_adj, p, p_surface_earth, alpha))
    # stability is judged at the operator's own tolerance: theta carries
    # ~16 eps |theta| of round-trip noise in the operator's dtype
    # (ops/convection.py _instability_tol) — at the micro-mass high-theta
    # top levels far above the reference's f64-calibrated 1e-10
    eps = torch.finfo(dtype).eps
    tol = np.maximum(1e-10, 16 * eps * np.abs(theta_adj))
    groups_after = find_unstable_groups(theta_adj, small=tol)
    H_adj = _enthalpy(T_adj, p)
    say(f'full operator: unstable levels after = '
        f'{sum(len(gr) for gr in groups_after)} (at the {dtype} tolerance), '
        f'enthalpy drift = {abs(H_adj / H0 - 1):.2e} relative')
    say(f'surface temperature {T0[0]:.2f} K -> {T_adj[0]:.2f} K '
        '(cooled: the near-surface gradient relaxed to the adiabat)')
    assert not groups_after
    assert abs(H_adj / H0 - 1) < 1e-5     # f32 arithmetic in the operator
    assert T_adj[0] < T0[0]
    return dict(theta0=theta0, groups=groups, cand=cand, H0=H0, H_lo=H_lo,
                H_hi=H_hi, beta=beta, T_blend=T_blend, H_blend=H_blend,
                T_adj=T_adj, theta_adj=theta_adj, groups_after=groups_after,
                H_adj=H_adj)


def run_walkthrough(nz=150, flux_thresh=1e-1, save_png=True, verbose=True,
                    out_dir=None, device='cuda', dtype=torch.float32):
    say = say_fn(verbose)
    # 1. thermosphere world (radiation_script.py:33-36) to RADIATIVE
    #    equilibrium — convection deliberately off so the instability shows
    world = GreyGas(nz=nz, ny=1,
                    tau_lw_func='scale_height_and_peak_in_atmosphere',
                    tau_lw_func_args=[51000, 4, 100, 600, 0.1],
                    tau_sw_func='scale_height_and_peak_in_atmosphere',
                    tau_sw_func_args=[p_surface_earth, 0.12, 100, 20, 0.002],
                    dtype=dtype, device=device)
    world.evolve_to_equilibrium(flux_thresh=flux_thresh, save=False)
    p = np.asarray(world.p[:, 0], np.float64)          # surface first
    T0 = np.asarray(world.T[:, 0], np.float64)
    say(f'radiative equilibrium: nz={world.nz}, '
        f'T_surface={T0[0]:.2f} K')
    a = adjust_profile(p, T0, dtype=dtype, device=device, verbose=verbose)

    if save_png:
        plt = pyplot()
        cand, theta0 = a['cand'], a['theta0']
        fig, axs = plt.subplots(1, 2, sharey=True, figsize=(12, 6))
        for ax in axs:
            ax.set_yscale('log')
            ax.set_ylim(p.max() * 1.05, p.min())
            ax.set_ylabel('Pressure / Pa')
        axs[0].plot(T0, p, label='radiative equilibrium')
        axs[0].plot(cand['lower'], p, 'k--', lw=1,
                    label=r'$T(\theta_{low})$ candidate')
        axs[0].plot(cand['upper'], p, 'r--', lw=1,
                    label=r'$T(\theta_{upper})$ candidate')
        axs[0].plot(a['T_adj'], p, color='tab:orange',
                    label='adjusted (blend)')
        axs[0].set_xlabel('Temperature / K')
        axs[0].legend(fontsize=8)
        axs[1].plot(theta0, p, label='original')
        axs[1].plot(a['theta_adj'], p, color='tab:orange', label='adjusted')
        for gr in a['groups']:
            axs[1].axhspan(p[gr[0]], p[min(gr[-1] + 1, p.size - 1)],
                           color='red', alpha=0.15)
        axs[1].set_xlabel(r'Potential temperature $\theta$ / K')
        axs[1].set_xlim(theta0.min() * 0.95, np.percentile(theta0, 75))
        axs[1].legend(fontsize=8)
        fig.suptitle('Convective adjustment: enthalpy-conserving flattening '
                     'of unstable runs')
        fig.tight_layout()
        path = out_path(out_dir, 'walkthrough_convective_adjustment.png')
        fig.savefig(path, dpi=90)
        plt.close(fig)
        say(f'saved {path}')
    return {'world': world, 'T0': T0, 'T_adj': a['T_adj'],
            'groups': a['groups'], 'H0': a['H0'], 'H_adj': a['H_adj'],
            'beta': a['beta']}


#: the configuration ``main()`` runs (the JAX script's)
MAIN = dict(nz=150)


def main(argv=None):
    args = parse_args(__doc__.splitlines()[0], argv)
    run_walkthrough(**MAIN, save_png=args.figures, out_dir=args.out_dir,
                    device=args.device, dtype=args.dtype)


if __name__ == '__main__':
    main()
