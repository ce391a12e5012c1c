#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``climatemodel_tpu_torch``) on one NVIDIA
GPU: builds the CUDA kernels from ``climatemodel_tpu_torch/ops/csrc/``,
holds each against its plain PyTorch version on the card, drives the grey
radiative-equilibrium ensemble march at the headline size, checks the card
against the CPU, and times the kernels.

    python3 chip_smoke.py

Every phase prints one JSON line.  The last lines are the kernel summary,
the card's name and power limit as nvidia-smi reports them, and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
that last line.  Needs one CUDA device and ``nvcc``; imports no JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# bench_grey, the headline configuration of the JAX package (bench.py:85)
HEADLINE = dict(members=4096, nz=60, F=(800.0, 1600.0), flux_thresh=1e-3,
                max_steps=3000)
# its CPU smoke configuration (bench.py:780)
SMOKE = dict(members=64, nz=40, max_steps=600)
SAMPLED = (0, 1000, 2000, 3000, 4095)

# Kernel vs plain PyTorch version on the card, in units in the last place of
# the kernel's dtype.  Both take the same ops in the same order with one
# rounding each (no FMA), so the expected difference is 0; the bound leaves
# room for the two exp implementations (CUDA's expf/exp and PyTorch's exp
# kernel, each within 2 ulp of exact) once the walk carries an exp's error
# through the cancelling x e + s (1 - e) of ~60 levels.
ULP_BOUND = 4096
T_BOUND_K = 0.1        # BASELINE bound, levels with tau > 0.03


class Failed(Exception):
    pass


def emit(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def check(ok, what):
    if not ok:
        raise Failed(what)


def nvidia_smi_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


def ulp_diff(a, b):
    """Max distance in units in the last place between same-shape float
    tensors (NaN positions must agree; they are skipped)."""
    import torch
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    check(torch.equal(nan_a, nan_b), 'NaN positions differ')
    keep = ~nan_a
    a, b = a[keep], b[keep]
    if a.numel() == 0:
        return 0
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    mask = 0x7FFFFFFF if it == torch.int32 else 0x7FFFFFFFFFFFFFFF

    def ordered(x):
        i = x.contiguous().view(it).to(torch.int64)
        m = torch.bitwise_and(i, mask)
        return torch.where(i < 0, -m, m)
    return int((ordered(a) - ordered(b)).abs().max())


def max_abs(a, b):
    import torch
    d = (a.double() - b.double()).abs()
    return float(torch.nan_to_num(d, nan=0.0).max()) if d.numel() else 0.0


def walk_inputs(gen, n, b, dtype, dev):
    import torch
    r = lambda *s: torch.rand(*s, generator=gen, dtype=torch.float64)  # noqa
    T = (200 + 100 * r(n, b)).to(dtype).to(dev)
    dtau = (0.2 * r(n, b)).to(dtype).to(dev)
    toa = (200 + 50 * r(b)).to(dtype).to(dev)
    return T, dtau, toa


def phase_kernels(cts, ts, dev):
    """Each kernel against its plain version on the card (phase 2)."""
    import torch
    at_main = {}
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator().manual_seed(2)
        for n, b in [(59, 7), (24, 130), (60, 1024), (59, 1025), (59, 4096)]:
            T, dtau, toa = walk_inputs(gen, n, b, dtype, dev)
            uk, dk = cts.lw_walk(T, dtau, toa)
            up, dp = ts.lw_flux_sequential(T, dtau, toa)
            torch.cuda.synchronize()
            ulp = max(ulp_diff(uk, up), ulp_diff(dk, dp))
            err = max(max_abs(uk, up), max_abs(dk, dp))
            emit('kernel_vs_plain', kernel='lw_walk', dtype=str(dtype),
                 n=n, b=b, max_ulp=ulp, max_abs_err=err,
                 bit_equal=ulp == 0)
            check(ulp <= ULP_BOUND, f'lw_walk {n}x{b} {dtype}: {ulp} ulp')
            if (n, b) == (59, 4096) and dtype == torch.float32:
                at_main['lw_walk'] = err
        gen = torch.Generator().manual_seed(33)
        for n, b, pct in [(59, 4096, 95), (149, 16, 95), (20, 1025, 90),
                          (5, 9, 50)]:
            T, dtau, toa = walk_inputs(gen, n, b, dtype, dev)
            r = lambda *s: torch.rand(*s, generator=gen,  # noqa: E731
                                      dtype=torch.float64).to(dtype).to(dev)
            usw, dsw, prev = 100 * r(n + 1, b), 300 * r(n + 1, b), \
                300 * r(n + 1, b) - 150
            L = ts.topk_depth(n + 1, pct)
            args = (T, dtau, usw, dsw, toa, prev, L)
            outk = cts.net_stats_walk(*args)
            outp = ts.net_stats_sequential(*args)
            torch.cuda.synchronize()
            ulps = [ulp_diff(k, p) for k, p in zip(outk, outp)]
            errs = [max_abs(k, p) for k, p in zip(outk, outp)]
            emit('kernel_vs_plain', kernel='net_stats_walk', dtype=str(dtype),
                 n=n, b=b, pct=pct, L=L,
                 max_ulp=dict(zip(('net', 'top1', 'top_hi', 'top_lo',
                                   'absmax'), ulps)),
                 max_abs_err=max(errs), bit_equal=max(ulps) == 0)
            check(max(ulps) <= ULP_BOUND,
                  f'net_stats_walk {n}x{b} {dtype}: {max(ulps)} ulp')
            if (n, b) == (59, 4096) and dtype == torch.float32:
                at_main['net_stats_walk'] = max(errs)
    # NaN sentinel (tests/test_two_stream.py:181-198)
    gen = torch.Generator().manual_seed(34)
    n, b = 12, 16
    T, dtau, toa = walk_inputs(gen, n, b, torch.float32, dev)
    zeros = torch.zeros((n + 1, b), dtype=torch.float32, device=dev)
    prev = zeros.clone()
    prev[4, 3] = float('nan')
    outk = cts.net_stats_walk(T, dtau, zeros, zeros, toa, prev, 3)
    outp = ts.net_stats_sequential(T, dtau, zeros, zeros, toa, prev, 3)
    nan_k = torch.isnan(outk[1]).cpu()
    nan_p = torch.isnan(outp[1]).cpu()
    x = torch.tensor([1.0, float('nan'), 3.0, 2.0], device=dev)
    topk_nan_first = bool(torch.isnan(torch.topk(x, 2).values[0]))
    argmax_nan = int(torch.argmax(x))
    emit('nan_sentinel', kernel_top1_nan=nan_k.nonzero().flatten().tolist(),
         plain_top1_nan=nan_p.nonzero().flatten().tolist(),
         absmax_finite=bool(torch.isfinite(outk[4]).all()),
         cuda_topk_orders_nan_first=topk_nan_first,
         cuda_argmax_of_nan=argmax_nan)
    check(nan_k.tolist() == nan_p.tolist() and bool(nan_k[3])
          and int(nan_k.sum()) == 1, 'NaN sentinel differs')
    check(bool(torch.isfinite(outk[4]).all()), 'absmax not finite')
    return at_main


def build_world(GreyGas, p_surface_earth, nz, device):
    """The bench_grey world (scale_height, [0.22 p_surface_earth, 4.0]), f32."""
    return GreyGas(nz=nz, ny=1, tau_lw_func='scale_height',
                   tau_lw_func_args=[0.22 * p_surface_earth, 4.0],
                   device=device)


def phase_main(ens, GreyGas, p_surface_earth, cts, dev):
    """The headline ensemble march, its f64 finish, and one single-world
    march, all on the card (phase 3).  Launch counts cover this phase."""
    import numpy as np
    import torch
    world = build_world(GreyGas, p_surface_earth, HEADLINE['nz'], dev)
    F = np.linspace(*HEADLINE['F'], HEADLINE['members'])
    states, forcings, p_int, p_c = ens.grey_ensemble(world, F)
    ft = HEADLINE['flux_thresh']

    def run():
        return ens.grey_evolve_ensemble(states, forcings, p_int, p_c, ft,
                                        max_steps=HEADLINE['max_steps'])
    cts.reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    wall = float('inf')
    for _ in range(3):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = min(wall, time.perf_counter() - t0)
    fs, info = out
    k3_ensemble = cts.launch_counts['net_stats_walk']
    days = float(fs.t.double().sum()) / 86400.0
    res = dict(members=HEADLINE['members'], nz=world.nz,
               model_days_per_sec=days / wall, wall_s=wall, warm_run_s=warm_s,
               total_steps=int(info.steps.sum()),
               lockstep_iterations=int(info.steps.max()),
               ms_per_iteration=1e3 * wall / int(info.steps.max()),
               converged_fraction_f32=float(info.equilibrium.double().mean()),
               nan_members=int(info.nan.sum()),
               failed_members=int(info.failed.sum()),
               timed_out_members=int(info.timed_out.sum()))
    t0 = time.perf_counter()
    fs_r, info_r, finished = ens.grey_finish_unconverged_f64(
        fs, info, forcings, p_int, p_c, ft, max_steps=HEADLINE['max_steps'])
    torch.cuda.synchronize()
    res.update(f64_finish_wall_s=time.perf_counter() - t0,
               f64_finished_members=int(len(finished)),
               converged_fraction=float(info_r.equilibrium.double().mean()),
               nan_after_f64=int(info_r.nan.sum()),
               failed_after_f64=int(info_r.failed.sum()))
    # the single-world march of tests/test_grey_rce.py:27 (K1, unfused)
    single = build_world(GreyGas, p_surface_earth, 100, dev)
    _, _, T_eqb, *_ = single.equilibrium_sol()
    t0 = time.perf_counter()
    for _ in range(2):                                  # test_grey_rce.py:20
        single.evolve_to_equilibrium(flux_thresh=1e-4, save=False, t_end=30.0)
    torch.cuda.synchronize()
    active = single.tau[:, 0] > 0.03
    res.update(single_world_wall_s=time.perf_counter() - t0,
               single_world_steps=int(single._equilibrium_info.steps),
               single_world_max_err_K=float(
                   np.abs(single.T - T_eqb)[active].max()))
    launches = dict(cts.launch_counts)
    res.update(launches_k3=launches['net_stats_walk'],
               launches_k3_ensemble_runs=k3_ensemble,
               launches_k1=launches['lw_walk'])
    emit('main_path', **res)
    check(res['nan_members'] == 0 and res['failed_members'] == 0,
          'nan or failed members in the f32 march')
    check(res['nan_after_f64'] == 0 and res['failed_after_f64'] == 0,
          'nan or failed members after the f64 pass')
    check(launches['net_stats_walk'] > 0, 'K3 never launched on the main path')
    check(launches['lw_walk'] > 0, 'K1 never launched on the main path')
    check(res['single_world_max_err_K'] < T_BOUND_K,
          f'single world {res["single_world_max_err_K"]} K from analytic')
    check(bool(torch.isfinite(fs_r.T).all()), 'non-finite temperatures')
    return states, forcings, fs, info, world, launches


def march_on(ens, states, forcings, p_int, p_c, idx, device, max_steps):
    sub = lambda x: x[idx].to(device)  # noqa: E731
    return ens.grey_evolve_ensemble(states.map(sub), forcings.map(sub),
                                    p_int.to(device), p_c.to(device),
                                    HEADLINE['flux_thresh'],
                                    max_steps=max_steps)


def lockstep_card_vs_cpu(ens, states, forcings, p_int, p_c, idx, dev,
                         max_steps, active):
    """March members ``idx`` on the card one step at a time; before every
    step the CPU (plain versions) takes the same carry.  Returns the largest
    per-step |T card - T CPU| on ``active`` levels and the number of
    member-steps whose exit flags differ."""
    import torch
    from climatemodel_tpu_torch.models import column as col
    sub = lambda d: (lambda x: x[idx.to(x.device)].to(d))  # noqa: E731
    st = states.map(sub(dev))
    fo = forcings.map(sub(dev))
    fo_c = fo.map(lambda x: x.cpu())
    fns = ens.grey_march_fns(fo, st.net_flux.shape)
    fns_c = ens.grey_march_fns(fo_c, st.net_flux.shape)
    B = len(idx)
    ft = torch.full((B,), HEADLINE['flux_thresh'], dtype=st.T.dtype,
                    device=dev)
    i = torch.zeros((B,), dtype=torch.int32, device=dev)
    stop = torch.zeros((B,), dtype=torch.bool, device=dev)
    t0 = st.t
    worst, flag_diffs, steps = 0.0, 0, 0
    while True:
        go = ~stop & (i < max_steps)
        if not bool(go.any()):
            return worst, flag_diffs, steps
        steps += 1
        new = col.march_step(st, ft, i, t0, fns[0], p_int, t_end=4.0,
                             net_stats_fn=fns[1])
        cpu = col.march_step(st.map(lambda x: x.cpu()), ft.cpu(), i.cpu(),
                             t0.cpu(), fns_c[0], p_int.cpu(), t_end=4.0,
                             net_stats_fn=fns_c[1])
        g = go.cpu()
        dT = (new[0].T.cpu() - cpu[0].T)[g][:, active].abs()
        worst = max(worst, float(dT.max()) if dT.numel() else 0.0)
        flag_diffs += int(sum((a.cpu() != b)[g].sum()
                              for a, b in zip(new[3:], cpu[3:])))
        st, ft = (col.where_members(go, a, b) for a, b in
                  ((new[0], st), (new[1], ft)))
        i = torch.where(go, i + 1, i)
        stop = stop | (go & (new[3] | new[4] | new[5] | new[6]))


def phase_card_vs_cpu(ens, GreyGas, p_surface_earth, main, dev):
    """Sampled members of the headline ensemble and the smoke config, on
    the card and on the CPU with the plain versions (phase 4).

    Checked: step by step from the same carry, the card and the CPU stay
    within 0.1 K on every step of the sampled members' marches, and the
    free-running sampled members end with the same equilibrium flags.
    Reported, not checked: the free-running endpoints.  The march amplifies
    a last-bit difference (CUDA's expf vs the CPU's vectorised exp) ~10x
    every ~5 steps and the delta-percentile exit is path dependent, so two
    free-running f32 marches of one member end up to ~1 K apart (measured,
    PERF.md)."""
    import numpy as np
    import torch
    states, forcings, fs, info, world, _ = main
    p_int = world._tensor(world.p_interface)
    p_c = world._tensor(world.p[:, 0])
    idx = torch.tensor(SAMPLED)
    active = torch.from_numpy(world.tau[:, 0] > 0.03)
    fc, ic = march_on(ens, states, forcings, p_int, p_c, idx, 'cpu',
                      HEADLINE['max_steps'])
    dT = (fc.T[:, active] - fs.T[idx.to(dev)][:, active].cpu()).abs()
    lock_dT, lock_flags, lock_steps = lockstep_card_vs_cpu(
        ens, states, forcings, p_int, p_c, idx, dev, HEADLINE['max_steps'],
        active)
    res = dict(sampled=list(SAMPLED), lockstep_steps=lock_steps,
               lockstep_max_dT_K=lock_dT, lockstep_flag_diffs=lock_flags,
               flags_card=info.equilibrium[idx.to(dev)].cpu().tolist(),
               flags_cpu=ic.equilibrium.tolist(),
               steps_card=info.steps[idx.to(dev)].cpu().tolist(),
               steps_cpu=ic.steps.tolist(),
               max_dT_K=dT.amax(dim=(1, 2)).tolist())
    smoke = build_world(GreyGas, p_surface_earth, SMOKE['nz'], dev)
    F = np.linspace(*HEADLINE['F'], SMOKE['members'])
    s_st, s_fo, s_pi, s_pc = ens.grey_ensemble(smoke, F)
    allm = torch.arange(SMOKE['members'])
    g_out = march_on(ens, s_st, s_fo, s_pi, s_pc, allm, dev,
                     SMOKE['max_steps'])
    c_out = march_on(ens, s_st, s_fo, s_pi, s_pc, allm, 'cpu',
                     SMOKE['max_steps'])
    s_act = torch.from_numpy(smoke.tau[:, 0] > 0.03)
    s_dT = (g_out[0].T.cpu()[:, s_act] - c_out[0].T[:, s_act]).abs()
    flags_same = (g_out[1].equilibrium.cpu() == c_out[1].equilibrium)
    both = g_out[1].equilibrium.cpu() & c_out[1].equilibrium
    res.update(smoke_flags_equal=int(flags_same.sum()),
               smoke_converged_card=int(g_out[1].equilibrium.sum()),
               smoke_converged_cpu=int(c_out[1].equilibrium.sum()),
               smoke_steps_card=int(g_out[1].steps.sum()),
               smoke_steps_cpu=int(c_out[1].steps.sum()),
               smoke_max_dT_K=float(s_dT.max()),
               smoke_max_dT_both_converged_K=float(
                   s_dT[both].max()) if bool(both.any()) else None)
    emit('card_vs_cpu', **res)
    check(res['lockstep_max_dT_K'] < T_BOUND_K,
          f'card and CPU steps differ by {res["lockstep_max_dT_K"]} K')
    check(res['flags_card'] == res['flags_cpu'],
          'sampled members: equilibrium flags differ between card and CPU')


def time_ms(fn, reps=50):
    import torch
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_times(cts, ts, dev):
    """K1 and K3 against their plain versions at 4096 x 59, CUDA events,
    in turns plain, kernel, kernel, plain (phase 5)."""
    import torch
    gen = torch.Generator().manual_seed(5)
    n, b = 59, HEADLINE['members']
    T, dtau, toa = walk_inputs(gen, n, b, torch.float32, dev)
    r = lambda *s: torch.rand(*s, generator=gen).to(dev)  # noqa: E731
    usw, dsw, prev = 100 * r(n + 1, b), 300 * r(n + 1, b), r(n + 1, b)
    L = ts.topk_depth(n + 1, 95)
    saved = dict(cts.launch_counts)
    pairs = {
        'lw_walk': (lambda: cts.lw_walk(T, dtau, toa),
                    lambda: ts.lw_flux_sequential(T, dtau, toa)),
        'net_stats_walk': (
            lambda: cts.net_stats_walk(T, dtau, usw, dsw, toa, prev, L),
            lambda: ts.net_stats_sequential(T, dtau, usw, dsw, toa, prev, L)),
    }
    res = {}
    for name, (kern, plain) in pairs.items():
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                          time_ms(plain))
        res[name] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                         runs_ms=[p1, k1, k2, p2])
    cts.launch_counts.update(saved)     # timing launches are not main path
    emit('kernel_times', n=n, b=b, **res)
    return res


def main():
    try:
        import torch
    except ImportError:
        print('chip_smoke: PyTorch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'False)', file=sys.stderr)
        return 2
    if not (ROOT / 'climatemodel_tpu_torch' / 'ops' / 'csrc').is_dir():
        print(f'chip_smoke: the climatemodel_tpu_torch package is not next '
              f'to {Path(__file__).name}', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from climatemodel_tpu_torch.constants import p_surface_earth
    from climatemodel_tpu_torch.models import ensemble as ens
    from climatemodel_tpu_torch.models.grey import GreyGas
    from climatemodel_tpu_torch.ops import _cuda_build
    from climatemodel_tpu_torch.ops import cuda_two_stream as cts
    from climatemodel_tpu_torch.ops import two_stream as ts

    dev = torch.device('cuda', 0)
    smi = nvidia_smi_line()
    emit('device', name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib, built = _cuda_build.load('two_stream')
    cts.library()
    regs = [int(w.split()[1]) for line in built.log.splitlines()
            for w in [line[line.find('Used'):]] if 'Used' in line]
    spills = [line.strip() for line in built.log.splitlines()
              if 'spill' in line and not ' 0 bytes spill stores, 0 bytes '
              'spill loads' in line]
    emit('build', seconds=time.perf_counter() - t0, nvcc_seconds=built.seconds,
         library=str(built.path.relative_to(ROOT)),
         max_registers=max(regs) if regs else None, nonzero_spills=spills[:4],
         max_topk=cts.max_topk())

    at_main = phase_kernels(cts, ts, dev)
    main_res = phase_main(ens, GreyGas, p_surface_earth, cts, dev)
    launches = main_res[5]
    phase_card_vs_cpu(ens, GreyGas, p_surface_earth, main_res, dev)
    times = phase_times(cts, ts, dev)

    src = 'climatemodel_tpu_torch/ops/csrc/two_stream.cu'
    print(json.dumps({'kernels': [
        {'name': 'lw_walk', 'route': 'cuda', 'source': src,
         'replaces': 'climatemodel_tpu/ops/pallas_two_stream.py:120 '
                     '(_lw_kernel, K1) and :38 (_lw_kernel_packed, K2)',
         'launches': launches['lw_walk'], 'max_abs_err': at_main['lw_walk'],
         'ms': times['lw_walk']['ms'],
         'plain_ms': times['lw_walk']['plain_ms']},
        {'name': 'net_stats_walk', 'route': 'cuda', 'source': src,
         'replaces': 'climatemodel_tpu/ops/pallas_two_stream.py:64 '
                     '(_net_stats_kernel, K3)',
         'launches': launches['net_stats_walk'],
         'max_abs_err': at_main['net_stats_walk'],
         'ms': times['net_stats_walk']['ms'],
         'plain_ms': times['net_stats_walk']['plain_ms']},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except Failed as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
        sys.exit(1)
