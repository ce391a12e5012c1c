#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``climatemodel_tpu_torch``) on one NVIDIA
GPU: builds the CUDA kernels from ``climatemodel_tpu_torch/ops/csrc/`` (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version on the card (the group blend, K8, bit-equal to its twin and timed
beside the lock-step loop), probes the f32 division the kernels compile to,
drives
the grey radiative-equilibrium ensemble march at the headline size and the
radiative-convective marches (the 512-member convective ensemble and the
single thermosphere world, both adjustment methods), the ice-albedo EBM
(bench_ebm's latitude world with one dt shared by its latitudes and as an
ensemble of single columns, and a stellar hysteresis sweep, checked
against the same sweep on the CPU), the march options (check_every,
dip_memory, bake_forcing, save=True), the real-gas band column (the four
earth tables built from the shipped line fixtures; bench.py's real-gas rows:
the 4-gas earth column at nz='auto' with 200 bands, with check_every=4, the
single-line column, the 64-member insolation ensemble, the nz=400 column
with its f32 and bf16 caches, and the convective single-line column with
each adjustment method) and the shallow-water
engine (bench_sw's El Nino world at 2050 x 1026 through the fused Richtmyer
kernel, and ``ShallowWater.time_step`` through its interior mode), checks
the card against the CPU, profiles the marches and the shallow-water run,
and times the kernels.  Then the README's commands run through the port's
CLI in process (``climatemodel_tpu_torch.cli.main``: the grey worlds with
and without --sensitivity, the earth column and its 16-member --find-tg
sweep, El Nino with each Richtmyer solver, the ice-albedo sweep), the
state --out wrote is loaded into card and CPU worlds whose sensitivities
must agree, a checkpointed march must resume bit-equal, and the earth
column's real-gas sensitivity is held to the CPU's.  The sharded worlds
(``parallel/``) run on 4 shards of the card: bench_sw's worlds through
``ShardedShallowWater`` (each shard on the fused kernel's 'given' mode;
the wind-free world bit-equal to the unsharded run), the 2-D
decomposition and the level-sharded flux scan; then the member- and
band-sharded compositions (``parallel/ensemble.py``): the grey headline and
the convective ensemble with their members on the shards (K3, and K4 on
isotonic or K8 on reference, on every shard), the real-gas net flux with its bands on the
shards, the real-gas ensemble with its members on them and on a (2, 2)
mesh with the bands on its other axis, and bench_sw's El Nino world as an
ensemble of 4 members on a (2, 2) mesh.  The ranks phase runs the
headline dp and the x-sharded El Nino world SPMD, one process a card
(``parallel/launch.run_ranks``, NCCL; one rank on one card), each rank's
result bit-equal to the single-controller mesh of the same cards.  Last, the line-accumulation
backends of ``spectral/hitran`` (the four earth tables and a 1e5-line list
built with the C++ library and with PyTorch on the card, held to each other
and to a NumPy row), the nine example scripts
(``climatemodel_tpu_torch.examples``) at their tests' sizes with their
claims, and reverse mode: a gradient through ``sw_simulate`` on the card
against the CPU, and each kernel wrapper refusing an input that requires
grad.  Then the port's bench (``python -m climatemodel_tpu_torch.bench
--smoke``) in a process of its own, its line and record checked.

    python3 chip_smoke.py

Every phase prints one JSON line.  The last lines are the kernel summary,
the card's name and power limit as nvidia-smi reports them, and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
that last line.  Needs one CUDA device, ``nvcc`` and ``g++``; imports no
JAX.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# bench_grey, the headline configuration of the JAX package (bench.py:85)
HEADLINE = dict(members=4096, nz=60, F=(800.0, 1600.0), flux_thresh=1e-3,
                max_steps=3000)
# its CPU smoke configuration (bench.py:780)
SMOKE = dict(members=64, nz=40, max_steps=600)
SAMPLED = (0, 1000, 2000, 3000, 4095)

# bench_rce_conv_ensemble (bench.py:510) and bench_rce_conv (bench.py:426):
# the thermosphere world (cli.grey_world_kwargs('thermosphere'),
# radiation_script.py:32-36) at nz=150, f32
CONV = dict(members=512, nz=150, F=(1200.0, 1500.0), flux_thresh=0.1,
            max_steps=3000)
CONV_SINGLE = dict(nz=150, flux_thresh=1e-3, t_end=30.0)
CONV_SAMPLED = (0, 170, 341, 511)
METHODS = ('reference', 'isotonic')
# K4 (b members x n levels): the convective ensemble's width, the grey
# headline's, ragged shapes, and n = 1, 2, 33 and the kernel's 512
ISO_SHAPES = [(512, 149), (4096, 59), (7, 149), (129, 64), (1, 8), (17, 255),
              (9, 1), (33, 2), (65, 33), (8, 512)]
# K3 (n cells, b members, top-k depth L): the grey headline's (L of the 95th
# percentile of 60 interfaces) and the convective ensemble's (150: L = 9),
# ragged shapes, L = 2 and L = 32
K3_CASES = [(59, 4096, 4), (149, 512, 9), (149, 16, 9), (20, 1025, 3),
            (5, 9, 4), (59, 130, 2), (63, 100, 32), (31, 7, 32), (39, 64, 3)]
# K1 (n cells, b members): the grey single world (nz=100, batch 1: where K1
# is launched on the main path), the headline's width, an 'auto' grid of
# ~600 levels at batch 1, ragged batches, and n above one chunk of the
# block's 48 KB of shared memory (192 levels at 16 members in f32, 96 in
# f64: n = 700 is 4 / 8 chunks, n = 200 is 2 / 3), and the EBM's latitude
# world (39 cells x 64 latitudes)
K1_SHAPES = [(99, 1), (59, 4096), (59, 7), (24, 130), (60, 1024), (59, 1025),
             (601, 1), (200, 40), (700, 33), (39, 64)]
K1_MAIN = (99, 1)

# bench_ebm (bench.py:556-630): the icy-pole latitude world, 64 latitudes x
# nz=40, f32, marched with one dt shared by the latitudes (K1 at [39, 64])
# and as 64 single-column members (K3 at 64 x 39, f32, then f64)
EBM = dict(ny=64, nz=40, flux_thresh=1e-3)
# a GreyAlbedoFeedback stellar sweep of that world size
# (tests/test_ice_albedo.py:64-84 cut to 7 values): 13 sweep points
SWEEP = dict(F=(600.0, 2250.0, 7), delta_albedo=0.1, flux_thresh=1e-3)
# the spread of two free-running marches of one world
# (tests/test_torch_ice_albedo.py): a latitude whose albedo differs between
# the card's sweep and the CPU's must end a march there this close to T_ice
SWEEP_T_BOUND_K = 1.5
# bench_grey_single_column (bench.py:377-405): the thermosphere world at
# nz=150, radiative, flux_thresh 1e-3; and bench_rce_conv's (bench.py:426)
MARCH_OPTIONS = dict(nz=150, flux_thresh=1e-3, conv_t_end=30.0)


# the real-gas rows of bench.py (bench_real_gas :200, bench_real_gas_earth
# :229, bench_real_gas_earth_ensemble :285, bench_real_gas_hires :330), f32:
# the 4-gas earth column with 200 bands (nz='auto' gives 121 levels)
RG_EARTH = dict(molecule_names=['CO2', 'CH4', 'H2O', 'O3'], T_g=265.19,
                p_toa=0.1, n_nu_bands=200, temp_change=1,
                delta_temp_change=0.1)
RG_MAIN = dict(nz_expected=121, flux_thresh=1e-3, t_end=20.0, check_every=4)
RG_SINGLE = dict(T_g=265.0, delta_temp_change=0.1, flux_thresh=1e-4)
RG_ENSEMBLE = dict(members=64, F=(0.85, 1.15), temp_change=0.5,
                   max_steps=5000, t_end=20.0, flux_thresh=1e-3)
RG_HIRES = dict(nz=400, max_steps=500, t_end=2.0, flux_thresh=1e-3)
# card vs CPU from a shared carry: steps of the earth column, and the bound
# a step on the optically active cells (tau > 0.03 at some wavenumber: the
# thin TOA cells carry a tendency that is f32 rounding noise,
# tests/test_torch_real_gas.py)
RG_CARD_CPU = dict(steps=20, bound_K=1e-3)
# the convective single-line marches: at most this many steps held step by
# step card vs CPU
RG_CONV = dict(lockstep_steps=200)
# steps of the profiled earth march: the profiler's post-processing takes
# ~40 ms per step's ~200 events, so the march is cut here (its steps all
# do the same work)
RG_PROFILE_STEPS = 300


def thermosphere_kwargs(p_surface_earth):
    """GreyGas kwargs of the thermosphere world (cli.py:140-144)."""
    return dict(tau_lw_func='scale_height_and_peak_in_atmosphere',
                tau_lw_func_args=[51000, 4, 100, 600, 0.1],
                tau_sw_func='scale_height_and_peak_in_atmosphere',
                tau_sw_func_args=[p_surface_earth, 0.12, 100, 20, 0.002])


# The card's published peaks (H100 SXM at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12

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


T_START = time.perf_counter()


def emit(phase, **fields):
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({'phase': phase, **fields,
                      'elapsed_s': time.perf_counter() - T_START}), flush=True)


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


def stats_rows(gen, n, b, dtype, dev):
    """K3's inputs as the march holds them, one member per row: T, dtau
    [b, n], up_sw, down_sw [b, n+1], up_toa [b], prev_net [b, n+1]."""
    import torch
    r = lambda *s: torch.rand(*s, generator=gen, dtype=torch.float64)  # noqa
    t = lambda x: x.to(dtype).to(dev)  # noqa: E731
    return (t(200 + 100 * r(b, n)), t(0.2 * r(b, n)), t(100 * r(b, n + 1)),
            t(300 * r(b, n + 1)), t(200 + 50 * r(b)),
            t(300 * r(b, n + 1) - 150))


SOURCES = ('two_stream', 'convection', 'stencils')


def build_all():
    """One nvcc per source under ops/csrc/, the PTX of convection.cu and
    the native HITRAN library (g++), all at once; one 'build' line per
    source, with its registers a thread per kernel and any nonzero spills
    for the CUDA ones.  Returns the PTX."""
    from climatemodel_tpu_torch import native
    from climatemodel_tpu_torch.ops import _cuda_build as cuda_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES) + 2) as pool:
        futures = {name: pool.submit(cuda_build.build, name)
                   for name in SOURCES}
        ptx_future = pool.submit(cuda_build.ptx, 'convection')
        native_future = pool.submit(native.build)
        built = {name: f.result() for name, f in futures.items()}
        ptx_text = ptx_future.result()
        native_lib = native_future.result()
    emit('build', source='climatemodel_tpu_torch/native/hitran_native.cpp',
         seconds_all=time.perf_counter() - t0,
         library=os.path.relpath(native_lib, ROOT),
         openmp=native_lib == native._target(native.FLAG_SETS[0]))
    for name, res in built.items():
        log = res.log.splitlines()
        # ptxas: "Compiling entry function '<mangled>'" then "Used N
        # registers" for that entry
        regs, entry = {}, None
        for line in log:
            if 'Compiling entry function' in line:
                entry = line.split("'")[1] if "'" in line else line
            elif 'Used' in line and entry is not None:
                regs[entry] = int(line[line.find('Used'):].split()[1])
        spills = [line.strip() for line in log if 'spill' in line and
                  ' 0 bytes spill stores, 0 bytes spill loads' not in line]
        emit('build', source=f'ops/csrc/{name}.cu',
             seconds_all=time.perf_counter() - t0, nvcc_seconds=res.seconds,
             library=os.path.relpath(res.path, ROOT),
             max_registers=max(regs.values()) if regs else None,
             registers=regs, nonzero_spills=spills[:4])
    return ptx_text


def phase_kernels(cts, ts, dev):
    """Each kernel against its plain version on the card (phase 2): K1 at
    K1_SHAPES, and K3 on the march's rows at K3_CASES and with a NaN in
    prev_net or in T."""
    import torch
    at_main = {}
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator().manual_seed(2)
        for n, b in K1_SHAPES:
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
            if (n, b) == K1_MAIN and dtype == torch.float32:
                at_main['lw_walk'] = err
        gen = torch.Generator().manual_seed(33)
        cases = [(n, b, L, None) for n, b, L in K3_CASES] + [
            (n, b, L, where) for n, b, L in ((149, 512, 9), (12, 16, 3))
            for where in ('prev', 'temp')]
        for n, b, L, where in cases:
            args = stats_rows(gen, n, b, dtype, dev)
            if where == 'prev':
                args[5][3, 4] = float('nan')
            elif where == 'temp':
                args[0][3, n // 2] = float('nan')
            outk = cts.net_stats_walk(*args, L)
            outp = ts.net_stats_rows_plain(*args, L)
            torch.cuda.synchronize()
            ulps = [ulp_diff(k, p) for k, p in zip(outk, outp)]
            errs = [max_abs(k, p) for k, p in zip(outk, outp)]
            nan_members = [torch.isnan(x).nonzero().flatten().tolist()
                           for x in outk[1:]]
            emit('kernel_vs_plain', kernel='net_stats_walk', dtype=str(dtype),
                 n=n, b=b, L=L, nan_in=where,
                 max_ulp=dict(zip(('net', 'top1', 'top_hi', 'top_lo',
                                   'absmax'), ulps)),
                 max_abs_err=max(errs), bit_equal=max(ulps) == 0,
                 nan_members_top1_hi_lo_absmax=nan_members)
            check(max(ulps) <= ULP_BOUND,
                  f'net_stats_walk {n}x{b} L={L} {dtype} NaN in {where}: '
                  f'{max(ulps)} ulp')
            want = [[3]] * 3 + [[3] if where == 'temp' else []]
            check(nan_members == (want if where else [[]] * 4),
                  f'net_stats_walk NaN in {where}: NaN members {nan_members}')
            if (n, b) == (59, 4096) and dtype == torch.float32:
                at_main['net_stats_walk'] = max(errs)
    # NaN sentinel (tests/test_two_stream.py:181-198)
    gen = torch.Generator().manual_seed(34)
    n, b = 12, 16
    T, dtau, toa = walk_inputs(gen, n, b, torch.float32, dev)
    T, dtau = T.T.contiguous(), dtau.T.contiguous()
    zeros = torch.zeros((b, n + 1), dtype=torch.float32, device=dev)
    prev = zeros.clone()
    prev[3, 4] = float('nan')
    outk = cts.net_stats_walk(T, dtau, zeros, zeros, toa, prev, 3)
    outp = ts.net_stats_rows_plain(T, dtau, zeros, zeros, toa, prev, 3)
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


def reset_counts(mods):
    for m in mods:
        m.reset_launch_counts()


def read_counts(mods):
    out = {}
    for m in mods:
        out.update(m.launch_counts)
    return out


def phase_main(ens, GreyGas, p_surface_earth, mods, dev):
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
    reset_counts(mods)
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
    k3_ensemble = read_counts(mods)['net_stats_walk']
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
    launches = read_counts(mods)
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
                         max_steps, active, flux_thresh=HEADLINE['flux_thresh'],
                         conv_kw=None):
    """March members ``idx`` on the card one step at a time; before every
    step the CPU (plain versions) takes the same carry.  Returns the largest
    per-step |T card - T CPU| on ``active`` levels, the number of
    member-steps whose exit flags differ, the number of steps, and the
    number of (member-step, level) convective flags that differ — the
    adjustment's decisions (``conv_kw``: convective keywords of
    ``column.march_step``, with ``p_centre_col`` on the card)."""
    import torch
    from climatemodel_tpu_torch.models import column as col
    sub = lambda d: (lambda x: x[idx.to(x.device)].to(d))  # noqa: E731
    st = states.map(sub(dev))
    fo = forcings.map(sub(dev))
    fo_c = fo.map(lambda x: x.cpu())
    fns = ens.grey_march_fns(fo, st.net_flux.shape)
    fns_c = ens.grey_march_fns(fo_c, st.net_flux.shape)
    B = len(idx)
    conv_kw = dict(conv_kw or {})
    conv_c = dict(conv_kw)
    if conv_kw:
        conv_c['p_centre_col'] = conv_kw['p_centre_col'].cpu()
    ft = torch.full((B,), flux_thresh, dtype=st.T.dtype, device=dev)
    i = torch.zeros((B,), dtype=torch.int32, device=dev)
    stop = torch.zeros((B,), dtype=torch.bool, device=dev)
    t0 = st.t
    worst, flag_diffs, steps, conv_diffs = 0.0, 0, 0, 0
    while True:
        go = ~stop & (i < max_steps)
        if not bool(go.any()):
            return worst, flag_diffs, steps, conv_diffs
        steps += 1
        new = col.march_step(st, ft, i, t0, fns[0], p_int, t_end=4.0,
                             net_stats_fn=fns[1], **conv_kw)
        cpu = col.march_step(st.map(lambda x: x.cpu()), ft.cpu(), i.cpu(),
                             t0.cpu(), fns_c[0], p_int.cpu(), t_end=4.0,
                             net_stats_fn=fns_c[1], **conv_c)
        g = go.cpu()
        dT = (new[0].T.cpu() - cpu[0].T)[g][:, active].abs()
        worst = max(worst, float(dT.max()) if dT.numel() else 0.0)
        flag_diffs += int(sum((a.cpu() != b)[g].sum()
                              for a, b in zip(new[3:], cpu[3:])))
        conv_diffs += int((new[0].tsi.convective.cpu()
                           != cpu[0].tsi.convective)[g].sum())
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
    lock_dT, lock_flags, lock_steps, _ = lockstep_card_vs_cpu(
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


def iso_inputs(gen, b, n, dtype):
    """theta [b, n] (random profiles, one per row) and v [n], on the CPU."""
    import torch
    theta = (200 + 100 * torch.rand(b, n, generator=gen, dtype=torch.float64)
             ).to(dtype)
    v = torch.empty(n, dtype=torch.float64).uniform_(0.5, 2.0, generator=gen
                                                     ).to(dtype)
    return theta, v


def phase_conv_kernels(ccv, pc, dev):
    """iso_fit (K4) against its plain version, f32 and f64, at ISO_SHAPES,
    with a NaN in a row and with sums the kernel must take in order (phase
    2b).  The plain version runs on CPU
    copies of the inputs, since its prefix-sum rule (a sequential double
    sum) is exact there; the kernel must equal it bit for bit.  Its min-max
    half, ``iso_fit_plain``, also runs on the card from those prefix sums
    and must equal the kernel too."""
    import torch
    at_main = {}
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator().manual_seed(4)
        # 'nan': a NaN in a row; 'wide': weights over 12 decades and some
        # negative theta, whose f32 prefix sums are not provably exact in a
        # parallel order, so the kernel takes its sequential loop
        cases = ([(b, n, None) for b, n in ISO_SHAPES]
                 + [(33, 40, 'nan'), (512, 149, 'nan'), (33, 200, 'wide')])
        for b, n, case in cases:
            theta, v = iso_inputs(gen, b, n, dtype)
            if case == 'nan':
                theta[b // 2, n // 3] = float('nan')
            elif case == 'wide':
                v = v * torch.logspace(0, -12, n, dtype=dtype)
                theta[::3] = -theta[::3]
            k = ccv.iso_fit(theta.to(dev), v.to(dev))
            torch.cuda.synchronize()
            k = k.cpu()
            SV, SW = pc.iso_prefix_sums(theta, v)
            p = pc.iso_rows_plain(theta, v)
            q = pc.iso_fit_plain(SV.to(dev), SW.to(dev)).T.cpu()
            ulp, ulp_card, err = ulp_diff(k, p), ulp_diff(k, q), max_abs(k, p)
            emit('kernel_vs_plain', kernel='iso_fit', dtype=str(dtype), b=b,
                 n=n, case=case, max_ulp=ulp, max_abs_err=err,
                 bit_equal=ulp == 0, max_ulp_vs_iso_fit_plain_on_card=ulp_card,
                 nan_entries=int(torch.isnan(k).sum()))
            check(ulp == 0 and ulp_card == 0,
                  f'iso_fit {b}x{n} {dtype} {case}: {ulp} ulp from the '
                  f'plain version, {ulp_card} from iso_fit_plain on the card')
            if (b, n, case) == ISO_SHAPES[0] + (None,) \
                    and dtype == torch.float32:
                at_main['iso_fit'] = err
    return at_main


#: the group blend's (K8) cases: (columns, nz) of the thermosphere world
#: (nz 'auto' is the CLI's 598-level world), and its timed shapes
BLEND_CASES = [(4096, 150), (1, 'auto')]
BLEND_TIMED = [(32768, 150), (1, 'auto')]


def blend_inputs(GreyGas, p_surface_earth, pc, C, nz, dtype, seed):
    """C seeded thermosphere columns for the group blend, on the CPU: the
    radiative-convective profile (a quarter the radiative one) warmed by
    0-3% plus 0-0.02 K of noise (a march step); thresholds median / 4, 0.05
    K on every fifth column from the fifth (groups skipped).  (T [C, n], pi,
    w [n], thresh [C])."""
    import numpy as np
    import torch
    world = GreyGas(nz=nz, ny=1, device='cpu', dtype=torch.float64,
                    **thermosphere_kwargs(p_surface_earth))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')      # the tau_sw = 0 closed form
        rce = world.equilibrium_sol(convective_adjust=True)[2][:, 0]
        rad = world.equilibrium_sol()[2][:, 0]
    rng = np.random.default_rng(seed)
    base = np.where(rng.random((C, 1)) < 0.25, rad, rce) * (
        1 + 0.03 * rng.random((C, 1)))
    T = torch.tensor(base + 0.02 * rng.random((C, 1))
                     * rng.standard_normal((C, len(rce))), dtype=dtype)
    pi, w = pc.grid_factors(torch.tensor(world.p[:, 0], dtype=dtype))
    thresh = pc.median_last(T) / 4
    thresh[4::5] = 0.05
    return T, pi, w, thresh


def phase_group_blend(GreyGas, p_surface_earth, ccv, pc, dev):
    """The group blend (K8) against its plain twin (phase 2c):
    ``group_blend_plain`` on CPU copies, bit for bit, one launch a call,
    f32 and f64 at BLEND_CASES; then timed at BLEND_TIMED in f32 beside the
    lock-step loop the card ran before (``torch.sum``'s order): CUDA events
    (50 kernel calls, 3 of the loop) and the profiler's device time.  The
    bound: T read and written, pi, w and thresh read, over the card's
    memory rate."""
    import torch
    res = {}
    for dtype in (torch.float32, torch.float64):
        for C, nz in BLEND_CASES:
            T, pi, w, thresh = blend_inputs(GreyGas, p_surface_earth, pc, C,
                                            nz, dtype, 7)
            mg, mo = pc._blend_limits(T.shape[1], None, None)
            before = ccv.launch_counts['group_blend']
            got = ccv.group_blend(*(x.to(dev) for x in (T, pi, w, thresh)),
                                  mg, mo).cpu()
            launches = ccv.launch_counts['group_blend'] - before
            want = pc.group_blend_plain(T, pi, w, thresh)
            same = torch.equal(got, want)
            emit('kernel_vs_plain', kernel='group_blend', dtype=str(dtype),
                 b=C, n=T.shape[1], bit_equal=same, launches=launches,
                 adjusted=int(((want - T).abs() > 0).any(dim=1).sum()))
            check(same and launches == 1, f'group_blend {C}x{T.shape[1]} '
                  f'{dtype}: bit_equal {same}, {launches} launches')
    for C, nz in BLEND_TIMED:
        T, pi, w, thresh = (x.to(dev) for x in blend_inputs(
            GreyGas, p_surface_earth, pc, C, nz, torch.float32, 8))
        n = T.shape[1]
        mg, mo = pc._blend_limits(n, None, None)

        def kern():
            return ccv.group_blend(T, pi, w, thresh, mg, mo)

        def plain():
            return pc._lockstep_blend(T, pi, w, thresh, mg, mo,
                                      pc._torch_row_sums)
        k1, p1, k2 = time_ms(kern), time_ms(plain, reps=3), time_ms(kern)
        k_dev = device_ms(kern)
        res[f'group_blend_{C}x{n}'] = dict(
            b=C, n=n, ms=k_dev if k_dev is not None else min(k1, k2),
            call_ms=min(k1, k2), plain_ms=p1, device_ms=k_dev,
            plain_device_ms=device_ms(plain, 2),
            bound=bound(4 * (2 * C * n + 2 * n + C), 0))
    emit('group_blend_times', **res)
    return res


def probe_inputs():
    """The division probe's own inputs (tools/probe_mosaic_div.py:50-56)."""
    import numpy as np
    rng = np.random.default_rng(11)
    a = np.float32(10.0 ** rng.uniform(-6, 4, (256, 128))
                   * rng.choice([-1, 1], (256, 128)))
    b = np.float32(10.0 ** rng.uniform(-4, 5, (256, 128))
                   * rng.choice([-1, 1], (256, 128)))
    return a, b


# operands outside in_fast_range's [2^-20, 2^40], each sending its warp to
# `/`: signed zeros, subnormals, the ends of the normal range, infinities,
# NaN, and 2^-21 and 2^41 just outside the range
DIV_PROBE_SPECIALS = (0.0, -0.0, 2.0 ** -149, -(2.0 ** -149), 1e-40, -1e-40,
                      2.0 ** -126, -(2.0 ** -126), 2.0 ** 127, -(2.0 ** 127),
                      3.4028235e38, float('inf'), float('-inf'), float('nan'),
                      2.0 ** -21, 2.0 ** 41)


def div_probe_cases():
    """The two cases beside the probe's inputs, [256, 128] f32 each; a row
    is one warp's chunk of the div_probe kernel (128 elements).
    'in_range': every operand well inside [2^-20, 2^40] (|a| in 1e-3 ..
    1e11, so C a too; |b| in 1e-5 .. 1e11), every warp on div_rn_in_range.
    'ends': rows 0-127 hold DIV_PROBE_SPECIALS among ordinary operands (the
    warps take `/`); rows 128-191 operands +-2^-20 and +-2^40 (quotients
    2^-60 .. 2^60 on div_rn_in_range); rows 192-223 numerators +0 and
    +-1.5 over +-2^-20 and +-2^40 (a +0 over a negative denominator sends
    the warp to `/` for a / b, not for a / |b|); rows 224-255 the same
    numerators over +2^-20 and +2^40 (+0 numerators on div_rn_in_range)."""
    import numpy as np
    rng = np.random.default_rng(12)
    shape = (256, 128)

    def signed(lo, hi):
        return 10.0 ** rng.uniform(lo, hi, shape) * rng.choice([-1, 1], shape)
    cases = {'in_range': (np.float32(signed(-3, 11)),
                          np.float32(signed(-5, 11)))}
    a, b = signed(-3, 3), signed(-3, 3)
    for x in (a, b):
        special = rng.random((128, 128)) < 0.25
        x[:128][special] = rng.choice(DIV_PROBE_SPECIALS, int(special.sum()))
    ends = (2.0 ** -20, -(2.0 ** -20), 2.0 ** 40, -(2.0 ** 40))
    a[128:192] = rng.choice(ends, (64, 128))
    b[128:192] = rng.choice(ends, (64, 128))
    a[192:224] = rng.choice((0.0, 1.5, -1.5), (32, 128))
    b[192:224] = rng.choice(ends, (32, 128))
    a[224:] = rng.choice((0.0, 1.5, -1.5), (32, 128))
    b[224:] = rng.choice(ends[::2], (32, 128))
    cases['ends'] = (np.float32(a), np.float32(b))
    return cases


def div_probe_numpy(a, b, C):
    """The probe's three quotients in numpy's f32 arithmetic."""
    import numpy as np
    with np.errstate(divide='ignore', invalid='ignore', over='ignore',
                     under='ignore'):
        return a / b, C * a / b, a / np.abs(b)


def same_bits(x, y):
    """f32 arrays bit for bit, NaN payloads aside (NaNs where the other has
    them; every other entry, the sign of zero included, the same bits)."""
    import numpy as np
    nan_x, nan_y = np.isnan(x), np.isnan(y)
    return bool(np.array_equal(nan_x, nan_y) and np.array_equal(
        x[~nan_x].view(np.uint32), y[~nan_y].view(np.uint32)))


def ptx_entry(ptx_text, name):
    """The PTX of the kernel entry whose (mangled) name holds ``name``:
    from its ``.entry`` line to the ``}`` that closes its body."""
    lines = ptx_text.splitlines()
    starts = [i for i, line in enumerate(lines)
              if '.entry' in line and name in line]
    check(len(starts) == 1, f'{len(starts)} PTX entries named {name}')
    ends = [i for i in range(starts[0], len(lines))
            if lines[i].rstrip() == '}']
    check(bool(ends), f'the PTX entry of {name} has no end')
    return '\n'.join(lines[starts[0]:ends[0] + 1])


PTX_DIVISIONS = ('div.rn.f32', 'div.approx', 'div.full', 'div.rn.f64',
                 'rcp.approx', 'rcp.approx.ftz.f32')


def phase_div_probe(pc, mods, dev, ptx_text):
    """K7: both forms of the f32 division compiled into convection.cu
    (div_rn_in_range where a warp's vote allows it, `/` otherwise) against
    PyTorch's CUDA division and numpy's, per pattern, on the probe's inputs
    (driven through ``convection.div_probe`` with the counts at 0) and on
    div_probe_cases; the warps that took each form
    (``convection.div_probe_warp_paths``); and the division instructions in
    the PTX of the whole file and of ``div_probe_kernel`` (phase 2c)."""
    import numpy as np
    import torch
    a_np, b_np = probe_inputs()
    a, b = torch.from_numpy(a_np).to(dev), torch.from_numpy(b_np).to(dev)
    reset_counts(mods)
    outs_probe = pc.div_probe(a, b)
    torch.cuda.synchronize()
    launches = read_counts(mods)['div_probe']
    C = np.float32(pc.DIV_PROBE_C)
    names = ('a_div_b', 'c_mul_a_div_b', 'a_div_abs_b')
    res, err = {}, 0.0
    for case, (x_np, y_np) in {'probe': (a_np, b_np),
                               **div_probe_cases()}.items():
        x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
        outs_k = outs_probe if case == 'probe' else pc.div_probe(x, y)
        outs_p = pc.div_probe_plain(x, y)
        paths = pc.div_probe_warp_paths(x, y)
        res[case] = {}
        for name, k, p, n in zip(names, outs_k, outs_p,
                                 div_probe_numpy(x_np, y_np, C)):
            k, p = k.cpu().numpy(), p.cpu().numpy()
            finite = np.isfinite(k) & np.isfinite(p) & (p != 0)
            rel = np.abs(k[finite] - p[finite]) / np.abs(p[finite])
            res[case][name] = {
                'bit_equal': same_bits(k, p),
                'bit_equal_numpy': same_bits(k, n),
                'max_rel': float(rel.max()) if rel.size else 0.0,
                'frac_differ': float(np.mean(k.view(np.uint32)
                                             != p.view(np.uint32))),
                'warps': paths[name]}
            if case == 'probe':
                err = max(err, float(np.abs(k.astype(np.float64) - p).max()))
    entry = ptx_entry(ptx_text, 'div_probe_kernel')
    ptx_file = {pat: ptx_text.count(pat) for pat in PTX_DIVISIONS}
    ptx_kernel = {pat: entry.count(pat) for pat in PTX_DIVISIONS}
    emit('div_probe', launches=launches, ptx_division=ptx_file,
         ptx_div_probe_kernel=ptx_kernel, **res)
    check(launches == 1, f'div_probe launched {launches} times, not once')
    for case, pats in res.items():
        for name, r in pats.items():
            check(r['bit_equal'] and r['bit_equal_numpy'],
                  f'div_probe {case} {name} differs from PyTorch\'s CUDA '
                  f'division or numpy\'s')
    probe_warps = res['probe'].values()
    check(any(r['warps']['fast'] for r in probe_warps)
          and any(r['warps']['div_rn'] for r in probe_warps),
          'the probe\'s inputs did not put a warp on each division form')
    check(all(r['warps']['div_rn'] == 0 for r in res['in_range'].values()),
          'a warp of the in_range case took `/`')
    check(ptx_file['div.rn.f32'] > 0 and ptx_file['div.approx'] == 0
          and ptx_file['div.full'] == 0,
          f'convection.cu PTX divides approximately: {ptx_file}')
    check(ptx_kernel['rcp.approx.ftz.f32'] > 0
          and ptx_kernel['div.rn.f32'] > 0 and ptx_kernel['div.approx'] == 0
          and ptx_kernel['div.full'] == 0,
          f'div_probe_kernel\'s PTX lacks a form or divides approximately: '
          f'{ptx_kernel}')
    return dict(err=err, launches=launches, a=a, b=b)


def phase_conv_main(ens, GreyGas, p_surface_earth, mods, dev):
    """The radiative-convective path on the card (phase 3b): the 512-member
    convective ensemble (bench.py:510) with each adjustment method, its f64
    finish, and the single thermosphere world (bench.py:426) with each
    method.  Launch counts are read per method and cover that method's
    ensemble runs, f64 pass and single-world march."""
    import numpy as np
    import torch
    from climatemodel_tpu_torch.constants import R_specific, c_p_dry
    kw = thermosphere_kwargs(p_surface_earth)
    world = GreyGas(nz=CONV['nz'], ny=1, device=dev, **kw)
    F = np.linspace(*CONV['F'], CONV['members'])
    states, forcings, p_int, p_c = ens.grey_ensemble(world, F)
    ft = CONV['flux_thresh']
    out = {}
    for method in METHODS:
        march_kw = dict(convective_adjust=True, conv_method=method,
                        max_steps=CONV['max_steps'])

        def run():
            return ens.grey_evolve_ensemble(states, forcings, p_int, p_c, ft,
                                            **march_kw)
        reset_counts(mods)
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        wall = float('inf')
        for _ in range(3):
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall = min(wall, time.perf_counter() - t0)
        fs, info = res
        days = float(fs.t.double().sum()) / 86400.0
        r = dict(method=method, members=CONV['members'], nz=world.nz,
                 model_days_per_sec=days / wall, wall_s=wall,
                 warm_run_s=warm_s, total_steps=int(info.steps.sum()),
                 lockstep_iterations=int(info.steps.max()),
                 converged_fraction_f32=float(
                     info.equilibrium.double().mean()),
                 nan_members=int(info.nan.sum()),
                 failed_members=int(info.failed.sum()),
                 timed_out_members=int(info.timed_out.sum()),
                 iso_fit_launches_4_marches=read_counts(mods)['iso_fit'])
        t0 = time.perf_counter()
        fs_r, info_r, finished = ens.grey_finish_unconverged_f64(
            fs, info, forcings, p_int, p_c, ft, **march_kw)
        torch.cuda.synchronize()
        eqb = info_r.equilibrium.cpu().numpy()
        r.update(f64_finish_wall_s=time.perf_counter() - t0,
                 f64_finished_members=int(len(finished)),
                 converged_fraction=float(eqb.mean()),
                 unconverged_F=[float(x) for x in F[~eqb]],
                 nan_after_f64=int(info_r.nan.sum()),
                 failed_after_f64=int(info_r.failed.sum()))
        # the single world, built without naming a device: the card
        single = [GreyGas(nz=CONV_SINGLE['nz'], ny=1, **kw) for _ in range(2)]
        check(single[0].device.type == 'cuda', 'GreyGas did not default to '
              'the card')
        for w in single:                       # a warm march, a timed one
            t0 = time.perf_counter()
            w.evolve_to_equilibrium(flux_thresh=CONV_SINGLE['flux_thresh'],
                                    save=False, convective_adjust=True,
                                    conv_method=method,
                                    t_end=CONV_SINGLE['t_end'])
            torch.cuda.synchronize()
            s_wall = time.perf_counter() - t0
        w = single[-1]
        # stability as tests/test_grey_rce.py:112-129 checks it, with the
        # f32 march's own instability tolerance in place of the f64 test's
        # 1e-7 (one ulp of theta is ~3e-5 K in f32)
        alpha = R_specific / c_p_dry
        active = w.tau[:, 0] > 0.05
        theta = w.T[:, 0].astype(np.float64) / (
            w.p[:, 0] / p_surface_earth) ** alpha
        tol = np.maximum(1e-7, 16 * np.finfo(np.float32).eps * np.maximum(
            np.abs(theta[:-1]), np.abs(theta[1:])))
        d = np.diff(theta)[active[:-1]]
        launches = read_counts(mods)
        r.update(single_world=dict(
            nz=w.nz, steps=int(w._equilibrium_info.steps), wall_s=s_wall,
            equilibrium=bool(w._equilibrium_info.equilibrium),
            model_days_per_sec=float(w.state.t[0]) / 86400.0 / s_wall,
            min_dtheta_active=float(d.min()),
            min_dtheta_over_tol=float((d / tol[active[:-1]]).min()),
            T_min=float(w.T.min()), T_max=float(w.T.max())),
            launches=launches)
        emit('conv_main_path', **r)
        check(r['nan_members'] == 0 and r['failed_members'] == 0,
              f'{method}: nan or failed members in the f32 march')
        check(r['nan_after_f64'] == 0 and r['failed_after_f64'] == 0,
              f'{method}: nan or failed members after the f64 pass')
        check(bool(torch.isfinite(fs_r.T).all()), 'non-finite temperatures')
        if method == 'isotonic':
            check(launches['iso_fit'] > 0 and launches['group_blend'] == 0,
                  'K4 never launched on the isotonic path, or K8 did')
        else:
            check(launches['iso_fit'] == 0 and launches['group_blend'] > 0,
                  'K4 launched on the reference path, or K8 never did')
        check(launches['net_stats_walk'] > 0, 'K3 never launched on the '
              'convective path')
        check(bool((d > -tol[active[:-1]]).all()),
              f'{method}: single world unstable on tau > 0.05')
        check(150 < w.T.min() and w.T.max() < 400,
              f'{method}: single world T outside (150, 400) K')
        out[method] = r
    return out, (states, forcings, p_int, p_c, world)


# The profiled marches are cut to a window: the first 300 lock-step
# iterations of the convective march (the isotonic one runs ~1320; the
# reference one ends at ~70, inside the window), the first simulated year of
# the EBM's (of 4).  Under the profiler the whole marches took 170 s of a
# 918 s run of this script on an NVIDIA H100 80GB HBM3 machine, the limit
# being 1200 s.  A window's figures a step are the window's own, not the
# whole march's: later steps may differ.
PROFILE_ITERS = 300
PROFILE_EBM_T_END = 1.0


def device_rows(prof):
    """(device us, launches, name) of each kernel that a
    ``torch.profiler`` profile recorded on the device."""
    rows = [(getattr(e, 'device_time_total', None)
             or getattr(e, 'cuda_time_total', 0), e.count, e.key)
            for e in prof.key_averages()]
    return [r for r in rows if r[0] > 0]


def phase_ebm_profile(GreyGas, p_surface_earth):
    """Where a shared-dt EBM march's time goes (phase 4d): the first
    PROFILE_EBM_T_END years of bench_ebm's march (a quarter of its ~1780
    steps) under ``torch.profiler`` (CUDA activity only): wall, device busy
    time, device operations a step, the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    w = icy_ebm(GreyGas, p_surface_earth)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        w.evolve_to_equilibrium(flux_thresh=EBM['flux_thresh'], save=False,
                                t_end=PROFILE_EBM_T_END)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    steps = int(w._equilibrium_info.steps)
    emit('ebm_profile', wall_s=wall, steps=steps,
         ms_per_step=1e3 * wall / steps, device_busy_s=busy,
         device_idle_share=1 - busy / wall if busy > 0 else None,
         device_ops_per_step=sum(r[1] for r in rows) / steps,
         top_kernels_ms=[[k[:60], round(t / 1e3, 3), c] for t, c, k in
                         sorted(rows, reverse=True)[:8]])


def phase_conv_profile(ens, conv_state):
    """Where a convective ensemble march's time goes (phase 4c): the
    first PROFILE_ITERS lock-step iterations of each method's march under
    ``torch.profiler`` (CUDA activity only): wall, device busy time (the
    kernels' time summed), kernel launches per lock-step iteration, and
    the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    states, forcings, p_int, p_c, _ = conv_state
    res = {}
    for method in METHODS:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, info = ens.grey_evolve_ensemble(
                states, forcings, p_int, p_c, CONV['flux_thresh'],
                convective_adjust=True, conv_method=method,
                max_steps=min(CONV['max_steps'], PROFILE_ITERS))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = device_rows(prof)
        busy = sum(r[0] for r in rows) / 1e6
        iters = int(info.steps.max())
        res[method] = dict(
            wall_s=wall, device_busy_s=busy,
            device_idle_share=1 - busy / wall if busy > 0 else None,
            lockstep_iterations=iters,
            device_ops_per_iteration=sum(r[1] for r in rows) / iters,
            top_kernels_ms=[[k[:60], round(t / 1e3, 3), c] for t, c, k in
                            sorted(rows, reverse=True)[:6]],
            # every scan on the path (torch.cumsum and kin), by name
            scan_kernels_ms=[[k[:90], round(t / 1e3, 3), c]
                             for t, c, k in rows if 'scan' in k.lower()
                             or 'cumsum' in k.lower()])
    emit('conv_profile', **res)


def phase_conv_card_vs_cpu(ens, conv_state, dev, max_steps=400):
    """Members CONV_SAMPLED of the convective ensemble, each method, step by
    step from the card's carry: the CPU's plain path within 0.1 K on levels
    with tau > 0.03 (phase 4b).  The march is cut at ``max_steps``."""
    import torch
    states, forcings, p_int, p_c, world = conv_state
    idx = torch.tensor(CONV_SAMPLED)
    active = torch.from_numpy(world.tau[:, 0] > 0.03)
    res = {}
    for method in METHODS:
        conv_kw = dict(convective_adjust=True, conv_method=method,
                       p_centre_col=p_c)
        dT, flags, steps, conv_diffs = lockstep_card_vs_cpu(
            ens, states, forcings, p_int, p_c, idx, dev, max_steps, active,
            flux_thresh=CONV['flux_thresh'], conv_kw=conv_kw)
        res[method] = dict(lockstep_steps=steps, lockstep_max_dT_K=dT,
                           lockstep_flag_diffs=flags,
                           lockstep_convective_flag_diffs=conv_diffs)
    emit('conv_card_vs_cpu', sampled=list(CONV_SAMPLED), **res)
    for method in METHODS:
        check(res[method]['lockstep_max_dT_K'] < T_BOUND_K,
              f'{method}: card and CPU steps differ by '
              f'{res[method]["lockstep_max_dT_K"]} K')


# bench_sw (bench.py:141): the El Nino wind-feedback world scaled to
# 2050 x 1026, f32, 400 steps; its CPU smoke size (bench.py:781)
def icy_ebm(GreyGas, p_surface_earth, **kw):
    """bench.py:565-570 ``_icy_ebm``: the scale-height world at EBM's size
    with icy poles (albedo 0.6 poleward of 60 degrees, 0.3 elsewhere)."""
    import numpy as np
    return GreyGas(nz=EBM['nz'], ny=EBM['ny'], tau_lw_func='scale_height',
                   tau_lw_func_args=[0.22 * p_surface_earth, 4.0],
                   albedo=lambda lat: np.where(np.abs(lat) > 60, 0.6, 0.3),
                   **kw)


def phase_ebm_main(ens, GreyGas, p_surface_earth, mods):
    """bench_ebm on the card (phase 3c), with its names: the latitude world
    built without naming a device, marched with one dt shared by its
    latitudes (K1 at [39, 64]), best of 3 after a warm run; then its
    latitudes as independent single-column members
    (``grey_latitude_ensemble``, K3 at 64 x 39), best of 3 after a warm
    run, and their f64 finish.  Returns each path's launches."""
    import numpy as np
    import torch
    ft = EBM['flux_thresh']
    reset_counts(mods)
    warm = icy_ebm(GreyGas, p_surface_earth)
    check(warm.device.type == 'cuda', 'GreyGas did not default to the card')
    warm.evolve_to_equilibrium(flux_thresh=ft, save=False)
    torch.cuda.synchronize()
    wall = float('inf')
    for _ in range(3):                   # best of 3, a fresh world a trial
        w = icy_ebm(GreyGas, p_surface_earth)
        t0 = time.perf_counter()
        w.evolve_to_equilibrium(flux_thresh=ft, save=False)
        torch.cuda.synchronize()
        if time.perf_counter() - t0 < wall:
            wall, best = time.perf_counter() - t0, w
    shared_launches = read_counts(mods)
    eq = best._equilibrium_info
    res = dict(ny=EBM['ny'], nz=best.nz,
               model_days_per_sec=float(best.state.t[0]) / 86400.0 / wall,
               steps=int(eq.steps), wall_s=wall,
               equilibrium=bool(eq.equilibrium), timed_out=bool(eq.timed_out),
               launches=shared_launches)

    states, forcings, p_int, p_c = ens.grey_latitude_ensemble(
        icy_ebm(GreyGas, p_surface_earth))

    def run():
        return ens.grey_evolve_ensemble(states, forcings, p_int, p_c, ft)
    reset_counts(mods)
    out = run()
    torch.cuda.synchronize()
    wall_e = float('inf')
    for _ in range(3):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_e = min(wall_e, time.perf_counter() - t0)
    f32_launches = read_counts(mods)
    fs, info = out
    reset_counts(mods)
    t0 = time.perf_counter()
    fs_r, info_r, finished = ens.grey_finish_unconverged_f64(
        fs, info, forcings, p_int, p_c, ft)
    torch.cuda.synchronize()
    f64_launches = read_counts(mods)
    res['independent_dt_ensemble'] = dict(
        model_days_per_sec=float(fs.t.double().sum()) / 86400.0 / wall_e,
        wall_s=wall_e, total_steps=int(info.steps.sum()),
        lockstep_iterations=int(info.steps.max()),
        converged_fraction_f32=float(info.equilibrium.double().mean()),
        f64_finish_wall_s=time.perf_counter() - t0,
        f64_finished_members=int(len(finished)),
        converged_fraction=float(info_r.equilibrium.double().mean()),
        nan_after_f64=int(info_r.nan.sum()),
        failed_after_f64=int(info_r.failed.sum()),
        launches_f32=f32_launches, launches_f64=f64_launches)
    emit('ebm_main', **res)
    ind = res['independent_dt_ensemble']
    check(not (bool(eq.nan) or bool(eq.failed)), 'EBM shared-dt march '
          'aborted')
    check(shared_launches['lw_walk'] > 0, 'K1 never launched on the '
          'shared-dt EBM march')
    check(f32_launches['net_stats_walk'] > 0, 'K3 never launched on the '
          'EBM ensemble')
    check(ind['f64_finished_members'] == 0
          or f64_launches['net_stats_walk'] > 0,
          'K3 never launched in the EBM f64 finish')
    check(ind['converged_fraction'] == 1.0,
          f'EBM ensemble converged {ind["converged_fraction"]} after f64')
    check(bool(torch.isfinite(fs_r.T).all()), 'non-finite EBM temperatures')
    check(np.isfinite(best.T).all(), 'non-finite EBM world temperatures')
    return {k: shared_launches[k] + f32_launches[k] + f64_launches[k]
            for k in shared_launches}


def run_sweep(pice, p_surface_earth, sweep, ebm, device=None):
    """The ``sweep`` (as SWEEP) of a GreyAlbedoFeedback world of ``ebm``'s
    size (as EBM) on ``device`` (the card when None).  Returns the sweep's
    outputs, the surface temperature after each of its marches by sweep
    point, and its wall."""
    import numpy as np
    kw = {} if device is None else dict(device=device)
    exp = pice.GreyAlbedoFeedback(
        4.0, np.linspace(*sweep['F']), nz=ebm['nz'], ny=ebm['ny'],
        tau_lw_func='scale_height',
        tau_lw_func_args=[0.22 * p_surface_earth, 4.0], **kw)
    world, marches, point = exp.grey_world, [], [-1]
    update, evolve = exp.update_albedo, world.evolve_to_equilibrium

    def update_albedo(*args, **kwargs):
        point[0] += 1
        return update(*args, **kwargs)

    def evolve_to_equilibrium(*args, **kwargs):
        out = evolve(*args, **kwargs)
        marches.append((point[0], world.T[0].copy()))
        return out
    exp.update_albedo = update_albedo
    world.evolve_to_equilibrium = evolve_to_equilibrium
    t0 = time.perf_counter()
    albedo, ice_latitude, T_surface = exp.run(
        delta_albedo=sweep['delta_albedo'],
        delta_net_flux_thresh=sweep['flux_thresh'])
    return dict(values=exp.changing_param_values, albedo=np.array(albedo),
                ice_latitude=ice_latitude, T_surface=np.array(T_surface),
                marches=marches, T_ice=exp.T_ice, device=str(world.device),
                wall_s=time.perf_counter() - t0)


def cpu_sweep(sweep, ebm):
    """:func:`run_sweep` on the CPU, for a process of its own."""
    import torch
    torch.set_num_threads(2)
    sys.path.insert(0, str(ROOT))
    from climatemodel_tpu_torch.constants import p_surface_earth
    from climatemodel_tpu_torch.models import ice_albedo as pice
    return run_sweep(pice, p_surface_earth, sweep, ebm, device='cpu')


def phase_ebm_sweep(pice, p_surface_earth, mods):
    """The ice-albedo stellar sweep on the card (phase 3d), f32, with the
    physics of tests/test_ice_albedo.py:34-84 (albedos in {0.3, 0.6}, ice
    grows on the cooling branch, hysteresis); the same sweep on the CPU, in
    a spawned process while the card runs, gives the same albedos and
    ice-edge latitudes up to the first sweep point where a latitude
    differs, and there a march on each device ends with that latitude
    within SWEEP_T_BOUND_K of T_ice.  Returns the launches."""
    import numpy as np
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context('spawn')) as pool:
        cpu_future = pool.submit(cpu_sweep, SWEEP, EBM)
        reset_counts(mods)
        card = run_sweep(pice, p_surface_earth, SWEEP, EBM)
        launches = read_counts(mods)
        cpu = cpu_future.result()
    values, ice = card['values'], card['ice_latitude']
    n_cool = int(values.argmin()) + 1
    cooling = ice[:n_cool]
    cool = dict(zip(values[:n_cool], ice[:n_cool]))
    warm = dict(zip(values[n_cool - 1:], ice[n_cool - 1:]))
    shared = [v for v in cool if v in warm]
    physics = dict(
        albedos_two_valued=bool(set(np.unique(card['albedo'])) <= {0.3, 0.6}),
        ice_grows_cooling=bool(all(a >= b for a, b in
                                   zip(cooling, cooling[1:]))
                               and ice[n_cool - 1] < ice[0]),
        hysteresis=bool(all(warm[v] <= cool[v] for v in shared)
                        and any(warm[v] < cool[v] for v in shared)))

    def margin(run, k, lats):
        """The least distance to T_ice, over the marches at sweep point k,
        of the farthest of latitudes ``lats``."""
        return min(float(np.abs(T[lats] - run['T_ice']).max())
                   for p, T in run['marches'] if p == k)
    flip, dT = None, 0.0
    for k in range(len(values)):
        if not np.array_equal(card['albedo'][k], cpu['albedo'][k]):
            lats = np.nonzero(card['albedo'][k] != cpu['albedo'][k])[0]
            flip = dict(sweep_point=k, latitudes=lats.tolist(),
                        card_margin_K=margin(card, k, lats),
                        cpu_margin_K=margin(cpu, k, lats))
            break
        dT = max(dT, float(np.abs(card['T_surface'][k]
                                  - cpu['T_surface'][k]).max()))
    emit('ebm_sweep', values=values.tolist(), ice_latitude=ice,
         ice_latitude_cpu=cpu['ice_latitude'], wall_s=card['wall_s'],
         cpu_wall_s=cpu['wall_s'], marches=len(card['marches']),
         cpu_device=cpu['device'], max_T_surface_diff_K=dT,
         first_differing_point=flip, launches=launches, **physics)
    check(all(physics.values()), f'EBM sweep physics: {physics}')
    check(launches['lw_walk'] > 0, 'K1 never launched on the sweep')
    check(flip is None or max(flip['card_margin_K'], flip['cpu_margin_K'])
          <= SWEEP_T_BOUND_K, f'card and CPU sweeps differ at {flip}')
    return launches


def phase_march_options(GreyGas, p_surface_earth, mods):
    """The march options on the card (phase 3e): bench_grey_single_column's
    rows (bench.py:377-405) — the thermosphere world at nz=150 marched per
    step, with check_every=8 and with check_every=8 and dip_memory —
    beside bake_forcing and save=True; and bench_rce_conv's reference row
    with its baked and dip-memory variants (bench.py:426-460).  The dip
    and baked marches and the snapshot march's last temperature must equal
    the per-step march's bit for bit.  Returns the launches."""
    import torch
    kw = thermosphere_kwargs(p_surface_earth)
    rows, worlds = {}, {}

    def march(key, **opts):
        w = GreyGas(nz=MARCH_OPTIONS['nz'], ny=1, **kw)
        t0 = time.perf_counter()
        data = w.evolve_to_equilibrium(
            flux_thresh=MARCH_OPTIONS['flux_thresh'], **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eq = w._equilibrium_info
        rows[key] = dict(steps=int(eq.steps), wall_s=wall,
                         ms_per_step=1e3 * wall / int(eq.steps),
                         model_days_per_sec=float(w.state.t[0]) / 86400.0
                         / wall, equilibrium=bool(eq.equilibrium))
        worlds[key] = w
        return data
    reset_counts(mods)
    radiative = dict(save=False)
    conv = dict(save=False, convective_adjust=True,
                t_end=MARCH_OPTIONS['conv_t_end'])
    march('per_step', **radiative)         # a warm march, then the timed one
    march('per_step', **radiative)
    march('check_every_8', check_every=8, **radiative)
    march('check_every_8_dip', check_every=8, dip_memory=True, **radiative)
    march('baked_variant', bake_forcing=True, **radiative)
    data = march('save', save=True)
    march('conv_reference', **conv)
    march('conv_baked_variant', bake_forcing=True, **conv)
    march('conv_dip_memory_variant', check_every=8, dip_memory=True, **conv)
    launches = read_counts(mods)

    def same(a, b):
        wa, wb = worlds[a], worlds[b]
        return (torch.equal(wa.state.T, wb.state.T)
                and rows[a]['steps'] == rows[b]['steps'])
    bit_equal = dict(
        check_every_8_dip=same('check_every_8_dip', 'per_step'),
        baked_variant=same('baked_variant', 'per_step'),
        save=(bool((torch.from_numpy(data['T'][-1])
                    == worlds['per_step'].state.T[0].cpu()).all())
              and len(data['t']) == rows['save']['steps'] + 1),
        conv_baked_variant=same('conv_baked_variant', 'conv_reference'),
        conv_dip_memory_variant=same('conv_dip_memory_variant',
                                     'conv_reference'))
    emit('march_options', nz=worlds['per_step'].nz, rows=rows,
         bit_equal_to_per_step=bit_equal, launches=launches)
    check(all(bit_equal.values()), f'march options differ: {bit_equal}')
    check(all(r['equilibrium'] for r in rows.values()),
          'a march option did not converge')
    check(launches['lw_walk'] > 0, 'K1 never launched on the march options')
    return launches


def earth_gas(prg, nz, **kw):
    """bench_real_gas_earth's column (bench.py:229), built without naming a
    device (the card), f32."""
    return prg.RealGas(nz=nz, ny=1, **{**RG_EARTH, **kw})


def single_line_gas(prg, phum, **kw):
    """bench_real_gas's single-line column (bench.py:200), f32."""
    return prg.RealGas(nz='auto', ny=1, molecule_names=['single_line'],
                       T_g=RG_SINGLE['T_g'],
                       q_funcs={'single_line': phum.co2},
                       q_funcs_args={'single_line': ()},
                       delta_temp_change=RG_SINGLE['delta_temp_change'], **kw)


def march_row(gas, state0, runs=1, **kw):
    """March ``gas`` from ``state0`` with evolve_to_equilibrium ``runs``
    times (the first a warm run when runs > 1): the best wall and its
    row."""
    import torch
    wall = float('inf')
    for _ in range(runs):
        gas._state = state0
        t0 = time.perf_counter()
        gas.evolve_to_equilibrium(**kw)
        torch.cuda.synchronize()
        wall = min(wall, time.perf_counter() - t0)
    eq = gas._equilibrium_info
    steps = int(eq.steps)
    return dict(steps=steps, wall_s=wall, ms_per_step=1e3 * wall / steps,
                model_days_per_sec=float(gas.state.t[0]) / 86400.0 / wall,
                equilibrium=bool(eq.equilibrium),
                timed_out=bool(eq.timed_out), failed=bool(eq.failed),
                nan=bool(eq.nan))


def phase_rg_tables(pet, ph):
    """The four earth tables built by the port from the shipped line
    fixtures into its own folder (phase 3f): the build wall, the shapes
    [200, 6, n_nu], and a second call that builds nothing."""
    folder = ph.lookup_table_folder()
    fresh = not os.path.isfile(os.path.join(folder,
                                            '_earth_fixture_stamp.json'))
    t0 = time.perf_counter()
    out, built = pet.ensure_earth_tables()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, built2 = pet.ensure_earth_tables()
    wall2 = time.perf_counter() - t0
    shapes = {n: list(ph.load_table(n, out)['absorption_coef'].shape)
              for n in RG_EARTH['molecule_names']}
    emit('rg_tables', folder=out, fresh_folder=fresh, built=built,
         build_wall_s=wall, second_call_built=built2,
         second_call_wall_s=wall2, shapes=shapes,
         fixture_folder=pet.fixture_folder())
    check(not fresh or sorted(built) == sorted(RG_EARTH['molecule_names']),
          f'the earth tables were not all built: {built}')
    check(built2 == [], f'a second ensure_earth_tables built {built2}')
    check(all(s[:2] == [200, 6] for s in shapes.values()),
          f'earth table shapes {shapes}')


def phase_rg_main(prg, phum, mods):
    """bench_real_gas_earth on the card (phase 3g): the 4-gas column at
    nz='auto' with 200 bands marched by evolve_to_equilibrium from its
    initial state, per step and with check_every=4, each best of 3 after a
    warm march; then bench_real_gas's single-line column.  Returns (the
    earth world, its initial state)."""
    import torch
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          'f32 matmuls would run in TF32')
    check(torch.get_float32_matmul_precision() == 'highest',
          'f32 matmul precision is not highest')
    t0 = time.perf_counter()
    gas = earth_gas(prg, 'auto')
    build_s = time.perf_counter() - t0
    check(gas.device.type == 'cuda', 'RealGas did not default to the card')
    state0 = gas.state
    ft, t_end = RG_MAIN['flux_thresh'], RG_MAIN['t_end']
    reset_counts(mods)
    res = dict(nz=gas.nz, n_nu=int(gas.nu.size),
               n_lw_bands=int(gas._packed.lw_list.size),
               packed=list(gas._packed.idx.shape), host_build_s=build_s)
    res['per_step'] = march_row(gas, state0, runs=4, flux_thresh=ft,
                                t_end=t_end)
    res['check_every_4'] = march_row(gas, state0, runs=4, flux_thresh=ft,
                                     t_end=t_end,
                                     check_every=RG_MAIN['check_every'])
    single = single_line_gas(prg, phum)
    res['single_line'] = dict(nz=single.nz, **march_row(
        single, single.state, runs=4, flux_thresh=RG_SINGLE['flux_thresh']))
    launches = read_counts(mods)
    res['launches'] = launches
    emit('rg_main', **res)
    check(gas.nz == RG_MAIN['nz_expected'],
          f'earth column nz {gas.nz}, expected {RG_MAIN["nz_expected"]}')
    for key in ('per_step', 'check_every_4'):
        check(res[key]['equilibrium'], f'earth column ({key}) did not reach '
              'equilibrium')
    for key in ('per_step', 'check_every_4', 'single_line'):
        check(not res[key]['failed'] and not res[key]['nan'],
              f'real-gas march {key} failed or went non-finite')
    gas._state = state0
    return gas, state0


def phase_rg_ensemble(prg, pens, mods):
    """bench_real_gas_earth_ensemble on the card (phase 3h): 64 members of
    the earth column (temp_change 0.5) sweeping the insolation scale over
    one shared composition, a warm run then a timed one; every member must
    converge (the JAX record's converged_fraction 1.0, bench.py:294-300)."""
    import numpy as np
    import torch
    gas = earth_gas(prg, 'auto', temp_change=RG_ENSEMBLE['temp_change'])
    scales = np.linspace(*RG_ENSEMBLE['F'], RG_ENSEMBLE['members'])
    states, sc, T_gs, args = pens.real_gas_ensemble(gas, F_scales=scales)
    reset_counts(mods)
    for _ in range(2):
        t0 = time.perf_counter()
        fs, info = pens.real_gas_evolve_ensemble(
            states, sc, T_gs, *args, RG_ENSEMBLE['flux_thresh'],
            t_end=RG_ENSEMBLE['t_end'], max_steps=RG_ENSEMBLE['max_steps'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eqb = info.equilibrium.cpu().numpy()
    steps = int(info.steps.sum())
    res = dict(members=len(scales), nz=gas.nz, wall_s=wall,
               total_steps=steps, lockstep_iterations=int(info.steps.max()),
               member_steps_per_sec=steps / wall,
               model_days_per_sec=float(fs.t.double().sum()) / 86400.0
               / wall, converged_fraction=float(eqb.mean()),
               unconverged_scales=[float(x) for x in scales[~eqb]],
               failed_members=int(info.failed.sum()),
               nan_members=int(info.nan.sum()), launches=read_counts(mods))
    emit('rg_ensemble', **res)
    check(res['converged_fraction'] == 1.0,
          f'real-gas ensemble converged {res["converged_fraction"]}')
    check(bool(torch.isfinite(fs.T).all()), 'non-finite ensemble T')


def phase_rg_hires(prg):
    """bench_real_gas_hires on the card (phase 3i): the earth column at
    nz=400 with 200 bands, 500 steps from its initial state with the f32
    cache and with the bf16 cache (its row-differenced layout), a warm run
    then a timed one each; neither may fail.  Prints the bytes of the f32
    march operator M_sum and of the bf16 one D_sum."""
    import torch
    t0 = time.perf_counter()
    gas = earth_gas(prg, RG_HIRES['nz'])
    build_s = time.perf_counter() - t0
    res = dict(nz=gas.nz, n_lw_bands=int(gas._packed.lw_list.size),
               host_build_s=build_s)
    for key, cd in (('f32', None), ('bf16_cache', torch.bfloat16)):
        t0 = time.perf_counter()
        cache = prg.precompute_transmission(gas.tau_device, gas.band_arrays,
                                            cd)
        torch.cuda.synchronize()
        fold_s = time.perf_counter() - t0
        for _ in range(2):
            t0 = time.perf_counter()
            st, info = prg._real_gas_evolve(
                gas.state, *gas._march_args(), RG_HIRES['flux_thresh'],
                t_end=RG_HIRES['t_end'], max_steps=RG_HIRES['max_steps'],
                cache=cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps = int(info.steps[0])
        op = cache.M_sum if cd is None else cache.D_sum
        res[key] = dict(steps=steps, wall_s=wall,
                        ms_per_step=1e3 * wall / steps, fold_s=fold_s,
                        operator_bytes=op.numel() * op.element_size(),
                        failed=bool(info.failed[0]), nan=bool(info.nan[0]),
                        finite=bool(torch.isfinite(st.T).all()))
    emit('rg_hires', **res)
    for key in ('f32', 'bf16_cache'):
        check(not res[key]['failed'] and not res[key]['nan']
              and res[key]['finite'], f'hires march ({key}) failed')
    return gas


def rg_lockstep_card_vs_cpu(prg, pcol, gas, state, steps, t_end, ft,
                            conv_kw=None):
    """March ``gas`` from ``state`` on the card one step at a time; before
    every step the CPU takes the same carry and the card's operators.
    Returns the largest per-step |T card - T CPU| on the active cells and
    on all cells, the member-steps whose exit flags differ, the (step,
    level) convective flags that differ, and the steps run."""
    import numpy as np
    import torch
    T_g, tau, ba, F, delta, p_int, p_c = gas._march_args()
    cache = gas.transmission()
    cpu = lambda x: x.cpu()  # noqa: E731
    fn = prg.real_gas_net_fn(T_g, cache, ba, F, delta)
    fn_c = prg.real_gas_net_fn(T_g.cpu(), cache.map(cpu), ba.map(cpu),
                               F.cpu(), delta.cpu())
    conv_kw = dict(conv_kw or {})
    conv_c = dict(conv_kw)
    if conv_kw:
        conv_kw['p_centre_col'], conv_c['p_centre_col'] = p_c, p_c.cpu()
    act = torch.from_numpy(np.asarray(gas.tau_interface).max(axis=1)[1:]
                           > 0.03)
    st = state
    ft = torch.full((1,), ft, dtype=st.T.dtype, device=st.T.device)
    i = torch.zeros((1,), dtype=torch.int32, device=st.T.device)
    t0 = st.t
    worst_act = worst_all = 0.0
    flag_diffs = conv_diffs = n = 0
    for _ in range(steps):
        new = pcol.march_step(st, ft, i, t0, fn, p_int, t_end=t_end,
                              **conv_kw)
        ref = pcol.march_step(st.map(cpu), ft.cpu(), i.cpu(), t0.cpu(), fn_c,
                              p_int.cpu(), t_end=t_end, **conv_c)
        dT = (new[0].T.cpu() - ref[0].T).abs()[0, :, 0]
        worst_act = max(worst_act, float(dT[act].max()))
        worst_all = max(worst_all, float(dT.max()))
        flag_diffs += int(sum(bool((a.cpu() != b).any())
                              for a, b in zip(new[3:], ref[3:])))
        conv_diffs += int((new[0].tsi.convective.cpu()
                           != ref[0].tsi.convective).sum())
        n += 1
        st, ft = new[0], new[1]
        i = i + 1
        if bool((new[3] | new[4] | new[5] | new[6]).any()):
            break
    return worst_act, worst_all, flag_diffs, conv_diffs, n


def phase_rg_card_vs_cpu(prg, pcol, main):
    """The earth column, 20 steps on the card and on the CPU from a shared
    carry (phase 4e): the largest per-step |dT| on the active cells must
    stay within 1e-3 K (f32); all cells reported."""
    gas, state0 = main[0], main[1]
    act, allc, flags, _, n = rg_lockstep_card_vs_cpu(
        prg, pcol, gas, state0, RG_CARD_CPU['steps'], RG_MAIN['t_end'],
        RG_MAIN['flux_thresh'])
    emit('rg_card_vs_cpu', steps=n, max_dT_active_K=act, max_dT_all_K=allc,
         flag_diffs=flags, bound_K=RG_CARD_CPU['bound_K'])
    check(act <= RG_CARD_CPU['bound_K'],
          f'real-gas card and CPU steps differ by {act} K on active cells')


def phase_rg_convective(prg, phum, pcol, mods):
    """The convective single-line column on the card with each adjustment
    method (phase 3j): one march by evolve_to_equilibrium, launch counts
    read per method (K4 only on the isotonic march), the same march on the
    CPU, and up to 200 steps of it held card vs CPU from a shared carry.
    Each march must end within 0.1 K of its CPU counterpart on the active
    cells, or — the march being chaotic in its last bit — stay within 0.1 K
    at every step from the shared carry.  Returns the isotonic launches and
    the column's cell count."""
    import numpy as np
    import torch
    res, out = {}, {}
    for method in METHODS:
        kw = dict(flux_thresh=RG_SINGLE['flux_thresh'],
                  convective_adjust=True, conv_method=method)
        gas = single_line_gas(prg, phum)
        state0 = gas.state
        reset_counts(mods)
        row = march_row(gas, state0, **kw)
        launches = read_counts(mods)
        cpu = single_line_gas(prg, phum, device='cpu')
        cpu.evolve_to_equilibrium(**kw)
        act = np.asarray(gas.tau_interface).max(axis=1)[1:] > 0.03
        end_dT = float(np.abs(gas.T[:, 0] - cpu.T[:, 0])[act].max())
        l_act, l_all, flags, conv, n = rg_lockstep_card_vs_cpu(
            prg, pcol, gas, state0, RG_CONV['lockstep_steps'], 4.0,
            RG_SINGLE['flux_thresh'], conv_kw=dict(convective_adjust=True, conv_method=method,
                         p_descending=False))
        res[method] = dict(row, nz=gas.nz, launches=launches,
                           cpu_steps=int(cpu._equilibrium_info.steps),
                           endpoint_max_dT_active_K=end_dT,
                           lockstep_steps=n, lockstep_max_dT_active_K=l_act,
                           lockstep_max_dT_all_K=l_all,
                           lockstep_flag_diffs=flags,
                           lockstep_convective_flag_diffs=conv,
                           convective_levels=int(
                               gas.state.tsi.convective.sum()))
        out[method] = launches['iso_fit']
    emit('rg_convective', **res)
    check(out['isotonic'] > 0, 'K4 never launched on the real-gas isotonic '
          'march')
    check(out['reference'] == 0, 'K4 launched on the real-gas reference '
          'march')
    for method in METHODS:
        r = res[method]
        check(not r['failed'] and not r['nan'],
              f'{method}: convective real-gas march failed')
        check(r['endpoint_max_dT_active_K'] <= T_BOUND_K
              or r['lockstep_max_dT_active_K'] <= T_BOUND_K,
              f'{method}: convective real-gas card and CPU differ by '
              f'{r["endpoint_max_dT_active_K"]} K at the end and '
              f'{r["lockstep_max_dT_active_K"]} K a step')
    return out['isotonic'], res['isotonic']['nz'] - 1


def phase_rg_profile(prg, main):
    """Where an earth-column step's time goes (phase 4f): rg_main's march
    from its initial state, cut at RG_PROFILE_STEPS steps, under
    ``torch.profiler`` (CUDA activity only): wall, device busy time,
    device operations a step, the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    gas, state0 = main[0], main[1]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, info = prg._real_gas_evolve(
            state0, *gas._march_args(), RG_MAIN['flux_thresh'],
            t_end=RG_MAIN['t_end'], max_steps=RG_PROFILE_STEPS,
            cache=gas.transmission())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    steps = int(info.steps[0])
    emit('rg_profile', wall_s=wall, steps=steps,
         ms_per_step=1e3 * wall / steps, device_busy_s=busy,
         device_idle_share=1 - busy / wall if busy > 0 else None,
         device_ms_per_step=1e3 * busy / steps,
         device_ops_per_step=sum(r[1] for r in rows) / steps,
         top_kernels_ms=[[kernel_label(k), round(t / 1e3, 3), c]
                         for t, c, k in sorted(rows, reverse=True)[:10]])


# The README's commands through the port's CLI (README.md:431-435), at
# full width, f32 on the card; each record's launches are its own (counts
# set to 0 before the command, read after).  ice-albedo is cut to 3 values
# (ebm_sweep runs the 13-point sweep).
CLI_RUNS = [
    ('grey_thermosphere', ['grey', '--world', 'thermosphere', '--convective']),
    ('grey_thermosphere_isotonic', ['grey', '--world', 'thermosphere',
                                    '--convective', '--conv-method',
                                    'isotonic', '--nz', '150']),
    ('real_gas_earth', ['real-gas', '--molecules', 'earth', '--n-bands',
                        '200']),
    ('real_gas_earth_sweep', ['real-gas', '--molecules', 'earth', '--sweep',
                              '16', '--find-tg']),
    ('shallow_el_nino', ['shallow', '--scenario', 'el_nino']),
    ('shallow_el_nino_fused', ['shallow', '--scenario', 'el_nino',
                               '--solver', 'richtmyer_pallas']),
    ('ice_albedo', ['ice-albedo', '--n-values', '3']),
    ('grey_sensitivity', ['grey', '--world', 'scale_height',
                          '--sensitivity']),
    ('grey_convective_sensitivity', ['grey', '--world', 'scale_height',
                                     '--convective', '--sensitivity']),
]
# the JAX CLI's record of `shallow --scenario el_nino` on the CPU
# (`python -m climatemodel_tpu shallow --scenario el_nino`): 26 snapshots
EL_NINO_SNAPSHOTS = 26
# the sweep's solved T_g: the largest fall between neighbouring members
# that the secant's noise may leave (the JAX CLI on the CPU: 1.69 K, member
# 0 above member 1; the port on the CPU: 1.89 K, the same member)
SWEEP_TG_SLACK_K = 2.5
# card vs CPU at the same state, f32 (f32 vs f64 on the CPU: 5.0e-4 grey;
# 3.8e-5 / 1.0e-4 on the earth column's active cells)
SENS_GREY_REL = 2e-3
SENS_RG_REL = 1e-3
RESUME_AT = 200


def cli_record(cli, argv):
    """Run ``cli.main(argv)`` in process: (its JSON record, stdout lines,
    wall)."""
    import contextlib
    import io
    import torch
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    recs = [json.loads(x) for x in lines if x.startswith('{')]
    check(len(recs) == 1, f'cli {argv}: {len(recs)} JSON records')
    return recs[0], lines, wall


def phase_cli(cli, mods, csl, F_sun, out_dir):
    """The port's CLI on the card (phase 6): each of CLI_RUNS in process,
    its record on a line of its own with the launches of K1, K4 and K6 it
    made and its wall; the JAX tests' physical checks.  Returns (the
    launches summed over the commands, the path of the grey state that
    --out wrote)."""
    import numpy as np
    allm = tuple(mods) + (csl,)
    total = {}
    out_path = os.path.join(out_dir, 'grey_scale_height')
    for name, argv in CLI_RUNS:
        if name == 'grey_sensitivity':
            argv = argv + ['--out', out_path]
        reset_counts(allm)
        rec, lines, wall = cli_record(cli, argv)
        launches = read_counts(allm)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        res = dict(command=' '.join(argv), record=rec, wall_s=wall,
                   launches={'lw_walk': launches['lw_walk'],
                             'iso_fit': launches['iso_fit'],
                             'richtmyer_step': launches['richtmyer_step_bc']
                             + launches['richtmyer_step_interior']})
        k1, k4, k6 = (res['launches'][k] for k in
                      ('lw_walk', 'iso_fit', 'richtmyer_step'))
        if name.startswith('grey'):
            check(k1 > 0, f'{name}: K1 never launched')
            check(np.isfinite(rec['T_surface']) and
                  150 < rec['T_surface'] < 400, f'{name}: T_surface '
                  f'{rec["T_surface"]}')
            check((k4 > 0) == name.endswith('isotonic'),
                  f'{name}: K4 launched {k4} times')
        if name == 'grey_thermosphere':
            check(400 < rec['nz'] < 800, f'thermosphere nz {rec["nz"]}')
        if name.endswith('sensitivity'):
            oracle = rec['T_surface'] / (4.0 * F_sun)
            res['oracle_T_over_4F'] = oracle
            res['ratio_to_oracle'] = rec['dT_surface_dF_stellar'] / oracle
            if name == 'grey_sensitivity':
                check(abs(res['ratio_to_oracle'] - 1) < 0.02,
                      f'grey sensitivity {res["ratio_to_oracle"]} x T/(4F)')
                res['state_file'] = os.path.basename(out_path) + '.npz'
            else:
                check(0 < res['ratio_to_oracle'] < 10,
                      f'RCE sensitivity {res["ratio_to_oracle"]} x T/(4F)')
        if name == 'real_gas_earth':
            check(rec['nz'] == RG_MAIN['nz_expected'] and
                  np.isfinite(rec['T_surface_air']),
                  f'real-gas earth record {rec}')
        if name == 'real_gas_earth_sweep':
            tg = np.asarray(rec['T_g'])
            falls = [i + 1 for i in range(len(tg) - 1) if tg[i + 1] < tg[i]]
            res.update(n_members=len(tg), non_monotone_members=falls,
                       largest_fall_K=float(max(0.0, -np.diff(tg).min())),
                       T_g_slope_K_per_scale=float(
                           np.polyfit(rec['sweep'], tg, 1)[0]))
            check(rec['converged'] == rec['tg_converged'] == 16,
                  f'sweep converged {rec["converged"]}, T_g solved '
                  f'{rec["tg_converged"]} of 16')
            check(np.isfinite(tg).all() and
                  res['T_g_slope_K_per_scale'] > 0 and
                  res['largest_fall_K'] < SWEEP_TG_SLACK_K,
                  f'T_g does not rise with the insolation scale: {tg}')
        if name.startswith('shallow'):
            kw, run = cli.shallow_scenario('el_nino')
            steps = int(np.fix(run['n_days'] * 86400.0 / kw['dt']) + 1)
            res['steps'] = steps
            check(rec['snapshots'] == EL_NINO_SNAPSHOTS,
                  f'{name}: {rec["snapshots"]} snapshots, the JAX CLI '
                  f'{EL_NINO_SNAPSHOTS}')
            check(abs(rec['final_t_days'] - 25.0) < 0.01,
                  f'{name}: ended at {rec["final_t_days"]} days')
            want = steps if name.endswith('fused') else 0
            check(k6 == want, f'{name}: K6 launched {k6} times, {want} '
                  'expected')
        if name == 'ice_albedo':
            check(all(0.0 <= x <= 90.0 for x in rec['ice_latitude']) and
                  len(rec['F_values']) == 5,
                  f'ice-albedo record {rec}')
            check(k1 > 0, 'ice-albedo: K1 never launched')
        emit('cli_' + name, **res)
    return total, out_path + '.npz'


def grey_march_raw(pcol, world, state, ft, **kw):
    net_fn, p_int, p_c = world._march_inputs(world.forcing)
    return pcol.evolve_to_equilibrium(state, net_fn, p_int, p_c,
                                      flux_thresh=ft, **kw)


def phase_checkpoint(cli, GreyGas, pcol, pck, sens, state_file, mods,
                     out_dir):
    """Checkpoints on the card (phase 7): the state the CLI's --out wrote
    on the card loads into a card world and a CPU world, whose grey
    sensitivities must agree within SENS_GREY_REL; then a march
    checkpointed at step RESUME_AT (the state with its step count and
    tightened threshold) and resumed in a fresh world must end bit-equal
    to the march never interrupted."""
    import numpy as np
    import torch
    kw = dict(nz='auto', ny=1, **cli.grey_world_kwargs('scale_height'))
    card = GreyGas(**kw)
    host = GreyGas(device='cpu', **kw)
    card._state = pck.load_pytree(state_file, card.state)
    host._state = pck.load_pytree(state_file, host.state)
    check(torch.equal(card.state.T.cpu(), host.state.T),
          'the state file loaded differently on the card and the CPU')
    t0 = time.perf_counter()
    d_card = sens.grey_equilibrium_sensitivity(card)
    wall_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    d_host = sens.grey_equilibrium_sensitivity(host)
    wall_host = time.perf_counter() - t0
    rel = float(np.abs(d_card - d_host).max() / np.abs(d_host).max())
    res = dict(nz=card.nz, state_file=os.path.basename(state_file),
               sensitivity_wall_card_s=wall_card,
               sensitivity_wall_cpu_s=wall_host,
               card_vs_cpu_rel=rel, bound_rel=SENS_GREY_REL,
               dT_surface_card=float(d_card[0].max()),
               dT_surface_cpu=float(d_host[0].max()))
    # resume
    reset_counts(mods)
    w = GreyGas(**kw)
    ft = 1e-3
    full, info = grey_march_raw(pcol, w, w.state, ft)
    half, info1 = grey_march_raw(pcol, w, w.state, ft, max_steps=RESUME_AT,
                                 final_reset=False)
    path = os.path.join(out_dir, 'resume')
    pck.save_pytree(path, (half, info1.steps, info1.flux_thresh))
    w2 = GreyGas(**kw)
    st, i0, ft2 = pck.load_pytree(path, (w2.state,
                                         torch.zeros_like(info1.steps),
                                         torch.zeros_like(info1.flux_thresh)))
    end, info2 = grey_march_raw(pcol, w2, st, ft2, i0=i0)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in
               zip(pck.tree_flatten(end)[0], pck.tree_flatten(full)[0]))
    same_info = all(torch.equal(a, b) for a, b in zip(info2, info))
    res.update(resume=dict(steps=int(info.steps[0]), at=int(info1.steps[0]),
                           equilibrium=bool(info.equilibrium[0]),
                           bit_equal=same, info_equal=same_info,
                           launches=read_counts(mods)))
    emit('checkpoint', **res)
    check(rel <= SENS_GREY_REL, f'grey sensitivity card vs CPU {rel}')
    check(bool(info.equilibrium[0]) and int(info1.steps[0]) == RESUME_AT,
          'the resume march did not run as planned')
    check(same and same_info, 'the resumed march differs from the march '
          'never interrupted')
    return res['resume']['launches']


def phase_sensitivity_rg(prg, sens, main):
    """The real-gas sensitivity on the card (phase 8): the earth column
    (nz 121, 200 bands) marched to equilibrium, then
    real_gas_equilibrium_sensitivity with d_F_scale=0.01 and with a tau
    direction (1% of tau: the jvp through the [L, nz, nz, K] exponent),
    each with its wall and the tau jvp's peak memory; held to the CPU's at
    the same state on the active cells (tau > 0.03 at some wavenumber)
    within SENS_RG_REL, all cells reported."""
    import numpy as np
    import torch
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          'f32 matmuls would run in TF32')
    gas, state0 = main[0], main[1]
    gas._state = state0
    gas.evolve_to_equilibrium(flux_thresh=RG_MAIN['flux_thresh'],
                              t_end=RG_MAIN['t_end'])
    host = earth_gas(prg, 'auto', device='cpu')
    host.T = gas.T
    d_tau = 0.01 * gas.tau_interface
    act = (np.abs(np.diff(gas.tau_interface, axis=0)) > 0.03).any(axis=1)
    res = dict(nz=gas.nz, n_active=int(act.sum()),
               equilibrium=bool(gas._equilibrium_info.equilibrium))
    for name, kw in (('F_scale', dict(d_F_scale=0.01)),
                     ('tau', dict(d_tau_interface=d_tau))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        d_card = sens.real_gas_equilibrium_sensitivity(gas, **kw)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        t0 = time.perf_counter()
        d_host = sens.real_gas_equilibrium_sensitivity(host, **kw)
        wall_host = time.perf_counter() - t0
        diff = np.abs(d_card - d_host)
        res[name] = dict(
            wall_card_s=wall, wall_cpu_s=wall_host, peak_extra_MB=peak / 2**20,
            finite=bool(np.isfinite(d_card).all()),
            rel_active=float(diff[act].max() / np.abs(d_host[act]).max()),
            rel_all=float(diff.max() / np.abs(d_host).max()),
            dT_surface_K=float(d_card[-1]), max_abs_dT_K=float(
                np.abs(d_card).max()))
    gas._state = state0
    emit('sensitivity_rg', bound_rel=SENS_RG_REL, **res)
    check(res['equilibrium'], 'the earth column did not reach equilibrium')
    for name in ('F_scale', 'tau'):
        check(res[name]['finite'], f'real-gas sensitivity ({name}) not '
              'finite')
        check(res[name]['rel_active'] <= SENS_RG_REL,
              f'real-gas sensitivity ({name}) card vs CPU '
              f'{res[name]["rel_active"]}')


# --------------------------------------------------------------------------
# the line-accumulation backends, the example scripts, gradients
# --------------------------------------------------------------------------

#: the synthetic line list of the hitran_backends phase: 1e5 lines, the
#: size docs/hitran_dropin.md:43-45 names for a real HITRAN list
HITRAN_SYNTH = dict(lines=100_000, nu=(0.0, 5000.0), gamma_air=(0.02, 0.12),
                    n_air=(0.4, 0.9), log10_sw=(-4.0, 2.0), seed=2026)
#: 'torch' against 'native', of each table's largest entry (index_add_ on
#: the card adds with atomics, in no fixed order)
HITRAN_TORCH_REL = 1e-12
#: 'native' against 'numpy' on one temperature row, of the row's largest
#: entry: the same sums in the same line order, but NumPy's vectorised pow
#: and exp may round an ulp from libm's (CPU tests: within 5e-16)
HITRAN_NUMPY_REL = 1e-14


def synthetic_lines(np, n, nu, gamma_air, n_air, log10_sw, seed):
    rng = np.random.default_rng(seed)
    return {'nu': rng.uniform(*nu, n), 'sw': 10.0 ** rng.uniform(*log10_sw, n),
            'gamma_air': rng.uniform(*gamma_air, n),
            'n_air': rng.uniform(*n_air, n)}


def write_headed_lines(np, path, lines):
    """``lines`` as a headed whitespace line file (the shipped
    ``HitranData/*.txt`` layout: molec_id 2, the main isotopologue)."""
    n = len(lines['nu'])
    cols = ('molec_id', 'local_iso_id', 'nu', 'sw', 'elower', 'gamma_air',
            'n_air')
    body = np.column_stack([np.full(n, 2.0), np.ones(n), lines['nu'],
                            lines['sw'], np.zeros(n), lines['gamma_air'],
                            lines['n_air']])
    np.savetxt(path, body, fmt='%.6E', header=' '.join(cols), comments='')


def phase_hitran_backends(ph, pet, dev):
    """The line accumulation's backends on the four earth tables at the
    default grid (200 pressures x 6 temperatures, dnu = 10) and on a
    synthetic list of 1e5 lines: make_table with 'native' (the C++ library
    built from the checkout) and with 'torch' on the card, 'torch' held to
    'native'.  On the earth gases one temperature row with 'numpy', held to
    the same row from 'native' (NumPy is not timed on the 1e5 list: no
    'auto' path takes it).  The 1e5 list is also written as a headed .txt
    and parsed both ways load_molecule_data can (the native parser and
    np.genfromtxt), to weigh the parse against the table build.  Walls on
    the host clock, the card's name and power limit beside them."""
    import numpy as np
    import torch
    from climatemodel_tpu_torch import native
    check(native.available(), 'the native HITRAN library did not build')
    # CUDA context, allocator and the first kernels off the clock
    ph.get_absorption_coefficient(ph.table_p_values[:2], np.full(2, 250.0),
                                  np.arange(0.0, 50.0, 10.0),
                                  {'nu': np.array([20.0]),
                                   'sw': np.array([1.0]),
                                   'gamma_air': np.array([0.1]),
                                   'n_air': np.array([0.7])},
                                  backend='torch', device=dev)
    torch.cuda.synchronize()
    fixtures = pet.fixture_folder()
    cases = {}
    for name in ('CO2', 'CH4', 'H2O', 'O3'):
        nu_min, nu_max = pet._NU_RANGE[name]
        wn = np.arange(nu_min, nu_max + ph.table_dnu / 2, ph.table_dnu)
        lines = ph.update_molecule_data(ph.load_molecule_data(name, fixtures),
                                        wn)
        cases[name] = (name, wn, lines)
    synth = synthetic_lines(np, HITRAN_SYNTH['lines'], HITRAN_SYNTH['nu'],
                            HITRAN_SYNTH['gamma_air'], HITRAN_SYNTH['n_air'],
                            HITRAN_SYNTH['log10_sw'], HITRAN_SYNTH['seed'])
    cases['synthetic_1e5'] = (synth, np.arange(0.0, 5000.0 + 5.0, 10.0), synth)
    p, T0 = ph.table_p_values, float(ph.table_T_values[0])
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for case, (what, wn, lines) in cases.items():
            tables, walls = {}, {}
            for backend in ('native', 'torch'):
                t0 = time.perf_counter()
                tab = ph.make_table(what, wavenumber_array=wn,
                                    data_folder=fixtures,
                                    output_folder=os.path.join(tmp, backend),
                                    overwrite=True, backend=backend,
                                    device=dev)
                walls[backend] = time.perf_counter() - t0
                tables[backend] = tab['absorption_coef']
            nat, tor = tables['native'], tables['torch']
            check(nat.shape == tor.shape and nat.shape[:2] == (200, 6),
                  f'hitran {case}: table shapes {nat.shape} {tor.shape}')
            rel_torch = float(np.abs(tor - nat).max() / np.abs(nat).max())
            rows[case] = dict(
                lines=int(len(lines['nu'])), shape=list(nat.shape),
                native_wall_s=walls['native'], torch_wall_s=walls['torch'],
                torch_vs_native_rel=rel_torch)
            check(np.isfinite(tor).all() and rel_torch <= HITRAN_TORCH_REL,
                  f'hitran {case}: torch vs native {rel_torch:.3g} > '
                  f'{HITRAN_TORCH_REL}')
            if case == 'synthetic_1e5':
                continue
            t0 = time.perf_counter()
            row_np = ph.get_absorption_coefficient(p, np.full(p.size, T0), wn,
                                                   lines, backend='numpy')
            numpy_row_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            row_nat = ph.get_absorption_coefficient(p, np.full(p.size, T0),
                                                    wn, lines,
                                                    backend='native')
            native_row_s = time.perf_counter() - t0
            rel_np = float(np.abs(row_np - row_nat).max()
                           / np.abs(row_nat).max())
            rows[case].update(
                numpy_one_row_wall_s=numpy_row_s,
                native_one_row_wall_s=native_row_s,
                numpy_vs_native_rel=rel_np,
                numpy_row_bit_equal=bool(np.array_equal(row_np, row_nat)))
            check(rel_np <= HITRAN_NUMPY_REL,
                  f'hitran {case}: numpy vs native {rel_np:.3g} > '
                  f'{HITRAN_NUMPY_REL}')
        path = os.path.join(tmp, 'CO2.txt')
        write_headed_lines(np, path, synth)
        t0 = time.perf_counter()
        body = native.parse_numeric_table(path, skip_lines=1)
        parse_native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gen = np.genfromtxt(path, names=True)
        parse_genfromtxt_s = time.perf_counter() - t0
        same = all(np.array_equal(body[:, k], gen[name])
                   for k, name in enumerate(gen.dtype.names))
        check(body.shape == (HITRAN_SYNTH['lines'], 7) and same,
              f'hitran parse: native {body.shape} differs from genfromtxt')
    emit('hitran_backends', nvidia_smi=nvidia_smi_line(),
         native_library=os.path.relpath(native.build(), ROOT),
         grid='200 p x 6 T, dnu 10', torch_device=str(dev),
         numpy_timed='one temperature row (T = 250 K) of each earth gas',
         cases=rows,
         parse_1e5_lines={'native_s': parse_native_s,
                          'genfromtxt_s': parse_genfromtxt_s,
                          'bit_equal': same},
         bounds={'torch_vs_native_rel': HITRAN_TORCH_REL,
                 'numpy_vs_native_rel': HITRAN_NUMPY_REL})


#: what the examples phase cuts from each script's own configuration
#: (``<script>.MAIN`` over the ``run_*`` defaults): depth only, never a
#: width (nz, ny, bands, grid) or the dtype.  The ice-albedo walkthrough
#: runs one of its two hysteresis sweeps (tau_lw_surface 4.6) on every
#: third of its stellar constants (dF 150 instead of 50: 21 marches of its
#: 142); radiation_script's ice-albedo sweep takes the top 2 of its 11
#: values.  Coarser sweeps are no cut but another experiment: at dF 350 the
#: walkthrough's snowball marches fall below 0 K, and at dF 150 the
#: tau 4.0 sweep tops out at 2100 W/m^2, under its deglaciation at 2150
#: (ny 30, f32, the card).  The walkthrough's own configuration ran on the
#: card as ``python -m climatemodel_tpu_torch.examples.walkthrough_ice_albedo
#: --device cuda --no-figures`` (PERF.md).
EXAMPLES_CUTS = {
    'walkthrough_ice_albedo': dict(tau_surfaces=(4.6,), dF=150.0),
    'radiation_script': dict(sweep_values=(1950.0, 2100.0)),
}


def examples_ice_albedo(device='cuda'):
    """The examples phase's ice-albedo walkthrough (``MAIN`` with its
    EXAMPLES_CUTS) on the card, for a process of its own: the transition
    fluxes of each sweep, its wall and its launches (counted from 0 in the
    fresh process)."""
    import torch
    sys.path.insert(0, str(ROOT))
    from climatemodel_tpu_torch.examples import walkthrough_ice_albedo as w
    from climatemodel_tpu_torch.ops import cuda_convection as ccv
    from climatemodel_tpu_torch.ops import cuda_two_stream as cts
    mods = (cts, ccv)
    cfg = {**w.MAIN, **EXAMPLES_CUTS['walkthrough_ice_albedo']}
    reset_counts(mods)
    t0 = time.perf_counter()
    out = w.run_walkthrough(**cfg, save_png=False, verbose=False,
                            device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    num = lambda x: None if x is None else float(x)  # noqa: E731
    return dict(wall_s=wall, launches=read_counts(mods),
                transitions={float(k): (num(v['F_snow']), num(v['F_degl']))
                             for k, v in out.items()})


def phase_examples(mods, dev, ice_albedo):
    """The nine example scripts (``climatemodel_tpu_torch.examples``) on
    the card, each at the configuration its ``main()`` runs (``MAIN``), in
    its default dtype (float32), with the depth cuts of EXAMPLES_CUTS and
    no figures (the card's machine has no matplotlib); the claims of the
    CPU tests (tests/test_torch_walkthroughs.py,
    test_torch_walkthrough_ice_albedo.py, test_torch_examples.py).  The
    ice-albedo walkthrough, the longest, runs in a process of its own
    (:func:`examples_ice_albedo`, started before the CLI phases); its
    result comes from the future ``ice_albedo``.  Launch counts cover this
    phase and that process: the grey, ice-albedo and staged-ramp marches
    run K1."""
    import numpy as np
    import torch
    from climatemodel_tpu_torch.examples import (
        centa_presentation, radiation_script, real_gas_script,
        shallow_script, staged_tau_ramp, walkthrough_arctic_amplification,
        walkthrough_convective_adjustment, walkthrough_ice_albedo,
        walkthrough_real_gas)
    walls, claims, configs = {}, {}, {}
    reset_counts(mods)

    def run(mod, fn, **kw):
        name = mod.__name__.rsplit('.', 1)[1]
        cfg = {**mod.MAIN, **EXAMPLES_CUTS.get(name, {})}
        configs[name] = {k: (list(v) if isinstance(v, tuple) else v)
                         for k, v in cfg.items()}
        t0 = time.perf_counter()
        out = fn(**cfg, **kw, device=dev)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    quiet = dict(verbose=False)
    out = run(walkthrough_convective_adjustment,
              walkthrough_convective_adjustment.run_walkthrough,
              save_png=False, **quiet)
    claims['convective_adjustment'] = dict(
        nz=int(out['world'].nz),
        H_drift=abs(out['H_adj'] / out['H0'] - 1), beta=out['beta'],
        T_surface=[float(out['T0'][0]), float(out['T_adj'][0])])
    check(abs(out['H_adj'] / out['H0'] - 1) < 1e-5 and 0 < out['beta'] < 1
          and out['T_adj'][0] < out['T0'][0],
          f'convective walkthrough claims: {claims["convective_adjustment"]}')

    world, data = run(staged_tau_ramp, staged_tau_ramp.run_staged_tau_ramp,
                      save_gif=False, n_plot_frames=0)
    T = np.asarray(world.T)
    claims['staged_tau_ramp'] = dict(nz=int(world.nz), frames=len(data['t']),
                                     T_surface=float(T[0, 0]))
    check(world.tau_lw_func_args[1] == 6.0
          and world.tau_sw_func_args[2] == 0.0 and np.isfinite(T).all()
          and 150 < float(T[0, 0]) < 500 and len(data['t']) > 10
          and (np.diff(np.asarray(data['t'], float)) >= 0).all()
          and float(T[0, 0]) > float(np.asarray(data['T'][0])[0, 0]),
          f'staged ramp claims: {claims["staged_tau_ramp"]}')

    out = run(radiation_script, radiation_script.run_radiation_script,
              save_figures=False, **quiet)
    claims['radiation_script'] = dict(
        nz=int(out['world'].nz),
        sensitivity_rel_err=out['sensitivity_rel_err'],
        ice_latitude=[float(x) for x in out['ice_latitude']])
    check(out['sensitivity_rel_err'] < 0.1
          and np.isfinite(np.asarray(out['world'].T)).all()
          and out['ramp_world'].tau_sw_func_args[2] == 0.0,
          f'radiation_script claims: {claims["radiation_script"]}')

    out = run(walkthrough_real_gas, walkthrough_real_gas.run_walkthrough,
              save_png=False, **quiet)
    a = out['areas']
    dco2, dch4 = a['CO2'][0] - a['CO2'][1], a['CH4'][0] - a['CH4'][1]
    claims['real_gas'] = dict(dco2=dco2, dch4=dch4)
    check(dco2 > 0 and dch4 > dco2 and a['CO2'][2] < a['CO2'][1] < a['CO2'][0],
          f'real-gas walkthrough claims: {a}')

    with tempfile.TemporaryDirectory() as tmp:
        out = run(walkthrough_arctic_amplification,
                  walkthrough_arctic_amplification.run_walkthrough,
                  table_folder=os.path.join(tmp, 'arctic'), save_png=False,
                  **quiet)
        scales = walkthrough_arctic_amplification.H2O_SCALES
        claims['arctic_amplification'] = out['amplification']
        for mol in ('CO2', 'CH4'):
            last = [-out['curves'][(mol, s)][-1]
                    for s in sorted(scales, reverse=True)]
            check(all(v > 0 for v in last) and last == sorted(last)
                  and out['amplification'][mol] > 1.3,
                  f'arctic walkthrough claims: {mol} {last} '
                  f'{out["amplification"]}')
        out = run(centa_presentation, centa_presentation.run_centa,
                  table_folder=os.path.join(tmp, 'centa'), save_png=False,
                  **quiet)
    last = [-out['curves'][s][-1] for s in sorted(out['curves'],
                                                  reverse=True)]
    claims['centa'] = last
    check(last == sorted(last) and last[-1] > 1.5 * last[0]
          and np.isfinite(out['activity'][1]).all(),
          f'centa claims: {last}')

    out = run(real_gas_script, real_gas_script.run_real_gas_script,
              save_figures=False, **quiet)
    eq = out['earth_info']
    claims['real_gas_script'] = dict(
        nz=int(out['earth'].nz), equilibrium=bool(eq.equilibrium),
        sweep_converged=int(out['sweep_converged'].sum()),
        members=int(out['sweep_converged'].size))
    check(bool(eq.equilibrium) and out['sweep_converged'].all()
          and np.isfinite(np.asarray(out['gas'].T)).all(),
          f'real_gas_script claims: {claims["real_gas_script"]}')

    sw_world_, sw_data = run(shallow_script, shallow_script.run_shallow_script,
                             save_png=False, **quiet)
    h = sw_data['h'][-1]
    nx = h.shape[0]
    west, east = float(h[1:nx // 4, 1:-1].mean()), float(h[3 * nx // 4:-1,
                                                          1:-1].mean())
    claims['shallow_script'] = dict(grid=list(h.shape),
                                    days=float(sw_data['t'][-1]) / 86400.0,
                                    west=west, east=east)
    check(np.isfinite(sw_data['h']).all() and west > east,
          f'shallow_script claims: {claims["shallow_script"]}')

    ice = ice_albedo.result()
    trans = ice['transitions']
    configs['walkthrough_ice_albedo'] = {
        k: (list(v) if isinstance(v, tuple) else v)
        for k, v in {**walkthrough_ice_albedo.MAIN,
                     **EXAMPLES_CUTS['walkthrough_ice_albedo']}.items()}
    walls['walkthrough_ice_albedo'] = ice['wall_s']
    claims['ice_albedo'] = {str(k): v for k, v in trans.items()}
    taus = sorted(trans)
    # the faint-young-sun claim needs both sweeps (the script asserts it
    # itself when it has them)
    check(all(s is not None and d is not None and d > s
              for s, d in trans.values())
          and (len(taus) < 2 or trans[taus[1]][1] <= trans[taus[0]][1]),
          f'ice-albedo walkthrough claims: {trans}')

    launches = read_counts(mods)
    for k, v in ice['launches'].items():
        launches[k] += v
    emit('examples', dtype='float32 (the scripts\' default)', configs=configs,
         cuts=list(EXAMPLES_CUTS), walls_s=walls, claims=claims,
         launches=launches, ice_albedo_process_launches=ice['launches'])
    check(launches['lw_walk'] > 0, 'the examples launched no K1')
    return launches


#: the world of tests/test_differentiability.py:35-40, 5 plain steps
GRAD_SW = dict(nx=18, ny=12, dx=100e3, dy=100e3, dt=60.0, f_0=1e-4,
               beta=1.6e-11,
               initial_info={'type': 'height_gaussian',
                             'min_h_surface': 9750.0,
                             'max_h_surface': 10750.0, 'x0': 0.0, 'y0': 0.0,
                             'x_std': 400e3, 'y_std': 400e3,
                             'add_noise': False})
GRAD_REL = 1e-9


def phase_grad(psw, cts, ccv, csl, dev):
    """Reverse mode on the card: torch.autograd.grad through sw_simulate
    (solver='richtmyer', f64) against the CPU within GRAD_REL of the
    gradient's largest entry; then each CUDA wrapper, given a card input
    that requires grad, raises RuntimeError and launches nothing, and under
    torch.no_grad() the same call launches."""
    import torch
    f64 = torch.float64

    def grad_on(device):
        w = psw.ShallowWater(**GRAD_SW, dtype=f64, device=device)
        kw = w._step_kwargs()
        h_mean = w.state.h.mean()
        h0 = w.state.h.clone().requires_grad_()
        out = psw.sw_simulate(w.state.replace(h=h0), w.params, 5, **kw)
        loss = ((out.h[1:-1, 1:-1] - h_mean) ** 2).sum() / h0.numel()
        (g,) = torch.autograd.grad(loss, h0)
        return kw['solver'], g.double().cpu()
    solver, g_card = grad_on(dev)
    _, g_cpu = grad_on(torch.device('cpu'))
    rel = float((g_card - g_cpu).abs().max() / g_cpu.abs().max())
    check(solver == 'richtmyer', f'grad world solver {solver}')
    check(bool(torch.isfinite(g_card).all()) and rel <= GRAD_REL,
          f'grad card vs CPU {rel:.3g} > {GRAD_REL}')

    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa
    one = torch.ones((), dtype=torch.float32, device=dev)
    calls = {
        'lw_walk': (cts.lw_walk, cts.launch_counts, 'lw_walk',
                    (z(4, 2) + 250, z(4, 2) + 0.1, z(2) + 240)),
        'net_stats_walk': (cts.net_stats_walk, cts.launch_counts,
                           'net_stats_walk',
                           (z(2, 4) + 250, z(2, 4) + 0.1, z(2, 5), z(2, 5),
                            z(2) + 240, z(2, 5), 2)),
        'iso_fit': (ccv.iso_fit, ccv.launch_counts, 'iso_fit',
                    (z(2, 4) + 300, z(4) + 1)),
        'div_probe': (ccv.div_probe, ccv.launch_counts, 'div_probe',
                      (z(4) + 1, z(4) + 3)),
        'group_blend': (ccv.group_blend, ccv.launch_counts, 'group_blend',
                        (z(2, 4) + 300, z(4) + 1, z(4) + 1, z(2) + 1e9, 3,
                         16)),
        'richtmyer_step': (csl.richtmyer_step, csl.launch_counts,
                           'richtmyer_step_interior',
                           (z(5, 5) + 100, z(5, 5), z(5, 5), z(3, 3),
                            z(3, 3), None, None, one,
                            torch.ones((), dtype=torch.bool, device=dev),
                            one, one * 1e5, one * 1e5)),
    }
    refused = {}
    for name, (fn, counts, key, args) in calls.items():
        graded = (args[0].clone().requires_grad_(),) + tuple(args[1:])
        before = counts[key]
        try:
            fn(*graded)
            refused[name] = None
        except RuntimeError as e:
            refused[name] = str(e)
        check(refused[name] is not None and 'no backward' in refused[name],
              f'{name} under grad did not refuse: {refused[name]}')
        check(counts[key] == before, f'{name} launched under grad')
        with torch.no_grad():
            fn(*graded)
        torch.cuda.synchronize()
        check(counts[key] == before + 1, f'{name} did not launch under '
              f'no_grad')
    emit('grad', world='tests/test_differentiability.py:35-40, 5 steps, '
         "solver='richtmyer', f64", card_vs_cpu_rel=rel, bound=GRAD_REL,
         refused={k: v.split(';')[0] for k, v in refused.items()})


# the port's bench on its smoke list (bench.py:769-785), in a process of
# its own: the limit of that process; the phase is budgeted at 60 s
BENCH_SMOKE_TIMEOUT_S = 180
# the kernel each smoke row must launch on the card (the shallow-water smoke
# row steps the plain richtmyer, as bench.py's does)
BENCH_SMOKE_KERNELS = {'grey_rce': 'net_stats_walk',
                       'grey_rce_single_column': 'lw_walk'}
BENCH_FLAGS = ('converged_fraction', 'equilibrium', 'timed_out', 'failed',
               'nan')


def phase_bench(pbench):
    """``python -m climatemodel_tpu_torch.bench --smoke`` on the card, in a
    process of its own (phase 10): rc 0, one last line under the bench's
    limit saying platform cuda, no row in error or broken, every march's
    flags reported and none failed or non-finite, each smoke row's kernel
    launched.  Returns the kernels' launches in that process."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / 'bench.json'
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'climatemodel_tpu_torch.bench', '--smoke',
             '--out', str(out)], cwd=ROOT, capture_output=True, text=True,
            timeout=BENCH_SMOKE_TIMEOUT_S)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f'bench --smoke exited '
              f'{proc.returncode}: {proc.stdout[-600:]} {proc.stderr[-600:]}')
        lines = proc.stdout.strip().splitlines()
        check(len(lines) > 0 and len(lines[-1]) < pbench.LINE_LIMIT,
              'bench --smoke: no last line, or one over the limit')
        rec = json.loads(lines[-1])
        full = json.loads(out.read_text())['extra']
    rows = {key: full.get(key) for key, _ in pbench.SMOKE_ROWS}
    marches = {'grey_rce': [rows['grey_rce']],
               'grey_rce_single_column': [
                   (rows['grey_rce_single_column'] or {}).get(k) for k in
                   ('per_step', 'check_every_8', 'check_every_8_dip')]}
    launches = {}
    for row in rows.values():
        for k, v in (row or {}).get('launches', {}).items():
            launches[k] = launches.get(k, 0) + v
    emit('bench', command='python -m climatemodel_tpu_torch.bench --smoke',
         wall_s=wall, value=rec['value'], vs_baseline=rec['vs_baseline'],
         line_chars=len(lines[-1]), platform=rec['extra'].get('platform'),
         config_wall_s=full['config_wall_s'], broken=full['broken'],
         headlines={k: v for k, v in rec['extra'].items() if k in rows},
         launches={k: (row or {}).get('launches') for k, row in rows.items()})
    check(rec['extra'].get('platform') == 'cuda', 'bench --smoke did not run '
          'on the card')
    check(rec['vs_baseline'] is None and (rec['value'] or 0) > 0,
          f'bench --smoke value {rec["value"]}, vs_baseline '
          f'{rec["vs_baseline"]}')
    for key, row in rows.items():
        check(isinstance(row, dict) and 'error' not in row,
              f'bench --smoke row {key}: {row}')
    check(full['broken'] == [], f'bench --smoke broke {full["broken"]}')
    for key, runs in marches.items():
        for r in runs:
            check(isinstance(r, dict) and all(f in r for f in BENCH_FLAGS),
                  f'bench --smoke row {key}: flags missing in {r}')
            check(not r['nan'] and not r['failed'],
                  f'bench --smoke row {key}: a march failed: {r}')
    sw = rows['shallow_water']
    check(sw.get('ok') is True and sw.get('no_wind_ok') is True,
          f'bench --smoke shallow water ok: {sw}')
    for key, kernel in BENCH_SMOKE_KERNELS.items():
        check(rows[key]['launches'].get(kernel, 0) > 0,
              f'bench --smoke row {key} never launched {kernel}')
    return launches


def kernel_label(name):
    """A profiler kernel name without its namespaces and launch-bound
    template arguments, cut to 120 characters: enough to tell one
    elementwise functor from another."""
    for junk in ('void ', 'at::native::', '(anonymous namespace)::',
                 'at::', 'c10::', 'std::'):
        name = name.replace(junk, '')
    return name[:120]


SW = dict(nx=2050, ny=1026, nt=400)
SW_SMOKE = dict(nx=258, ny=130, nt=400)
SW_RAGGED = (37, 29)
# Shapes that break the fused step's strips (R = 12 rows a warp, 30
# columns a warp, 4 warps a block: kRows, kOut, kWarps in stencils.cu):
# nx = 3 and ny = 3; nx - 2 not a multiple of R and ny - 2 not a multiple of 30
# (SW_RAGGED, 51 x 95); one strip of one band (12 x 20); bands spread over
# blocks with warps left idle (20 x 250)
SW_EDGE = [(3, 3), (3, 40), (40, 3), (12, 20), (51, 95), (20, 250)]
# The fused step against its plain version on the card, in ulp.  Both take
# the same +, -, *, / in the same order, each one IEEE rounding (no FMA in
# the kernel's build, div.rn for the divisions; PyTorch's elementwise CUDA
# ops round each op once too), and max2 is an exact max: bit-equal.
SW_ULP_BOUND = 0
# Card vs CPU over a free run: every elementwise op rounds identically on
# both; only the wind's two masked sums (f32, ~1e5 cells) are reduced in
# another order, so the wind differs in its last bits and the flow carries
# that.  Measured on the H100: 1.5e-5 m (2 ulp of h ~ 100 m) and 2.2e-7 m/s
# after 400 steps at 258 x 130, 0 m and 4.7e-10 m/s after 20 steps at full
# width; the bounds leave a factor of 5 or more.
SW_DH_BOUND_M = 1e-4
SW_DU_BOUND = 1e-6
# operations per interior cell of the flat step: the conservative form and
# fluxes (9), the two faces' half-step states and fluxes (2 x 23), the
# update (18), the source (7), 1 / h and r dt (2), damping (6), u^2 + v^2 (3)
SW_OPS_FLAT = 91


def sw_world(psw, Omega, R_earth, nx, ny, el_nino=True, **kw):
    """bench_sw's worlds (bench.py:148-172): the El Nino forced-wind world
    (walls, y sponge), or the wind-free height_gaussian world (periodic x,
    walls y), with the fused kernel."""
    import numpy as np
    if el_nino:
        h_mean, g_use = 100.0, 0.05
        c = np.sqrt(g_use * h_mean)
        beta = 2 * Omega / R_earth
        L_def = np.sqrt(c / beta)
        dx = L_def / 5
        dt = 0.01 * dx / c
        r = 1 / (10 * 30 * 24 * 3600)
        return psw.ShallowWater(
            nx=nx, ny=ny, dx=dx, dy=dx, dt=dt, f_0=0.0, beta=beta, r=r,
            g=g_use, numerical_solver='richtmyer_pallas',
            boundary_type={'x': 'walls', 'y': 'walls',
                           'y_walls_damp': {'dist_thresh': (ny / 2) * dx
                                            - 6 * dx, 'r': r * 100}},
            initial_info={'type': 'el_nino', 'max_h_surface': 110.0,
                          'min_h_surface': 90.0, 'y_std': L_def,
                          'add_noise': False, 'wind': {'type': 'forced'}},
            **kw)
    return psw.ShallowWater(
        nx=nx, ny=ny, dx=100e3, dy=100e3, dt=60.0, f_0=1e-4, beta=1.6e-11,
        numerical_solver='richtmyer_pallas',
        initial_info={'type': 'height_gaussian', 'min_h_surface': 9750.0,
                      'max_h_surface': 10750.0, 'x0': 0.0, 'y0': 0.0,
                      'x_std': 4000e3, 'y_std': 4000e3, 'add_noise': False},
        **kw)


def sw_inputs(gen, nx, ny, dtype, dev, flat, rows):
    """Random fields of the fused step: h ~ 100 m, u, v ~ 0.1 m/s, f and r
    of the El Nino world's size, orography gradients ~ 1e-5, scalars as
    0-d tensors on the card."""
    import torch
    r = lambda *s: torch.rand(*s, generator=gen, dtype=torch.float64)  # noqa
    n = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)  # noqa
    nr = 1 if rows else nx - 2
    t = lambda x: x.to(dtype).to(dev)  # noqa: E731
    return dict(
        h=t(100 + 5 * n(nx, ny)), u=t(0.1 * n(nx, ny)), v=t(0.1 * n(nx, ny)),
        f=t(2.3e-11 * 1e5 * (r(nr, ny - 2) - 0.5)), r=t(4e-7 * r(nr, ny - 2)),
        dhbx=None if flat else t(1e-5 * n(nx - 2, ny - 2)),
        dhby=None if flat else t(1e-5 * n(nx - 2, ny - 2)),
        dt=t(torch.tensor(279.5)), ok=torch.tensor(True, device=dev),
        g=t(torch.tensor(0.05)), dx=t(torch.tensor(62500.0)),
        dy=t(torch.tensor(62500.0)))


def sw_args(x):
    return (x['h'], x['u'], x['v'], x['f'], x['r'], x['dhbx'], x['dhby'],
            x['dt'], x['ok'], x['g'], x['dx'], x['dy'])


SW_MODES = [(None, None)] + [(bx, by) for bx in ('walls', 'periodic', 'given')
                             for by in ('walls', 'periodic')]


def phase_sw_kernels(csl, pst, dev):
    """The fused Richtmyer step (K5 and K6) against its plain version on the
    card: f32 and f64, the interior mode and every boundary mode, flat
    orography with row f and r and orography with full fields, a ragged
    grid, the edge shapes SW_EDGE, one shard of the sharded run ([514,
    1026], where ``sharded_sw`` launches the ``given`` mode) and 2050 x 1026;
    then ok False and a NaN in u (phase 2d)."""
    import torch
    at_main = {}
    shard = ((SW['nx'] - 2) // SHARDS + 2, SW['ny'])
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator().manual_seed(40)
        for nx, ny in [SW_RAGGED, *SW_EDGE, shard, (SW['nx'], SW['ny'])]:
            for flat, rows in ((True, True), (False, False)):
                x = sw_inputs(gen, nx, ny, dtype, dev, flat, rows)
                for bx, by in SW_MODES:
                    if bx is None:
                        k = csl.richtmyer_step(*sw_args(x))
                        p = pst.richtmyer_step_interior_plain(*sw_args(x))
                    else:
                        k = csl.richtmyer_step(*sw_args(x), bx=bx, by=by)
                        p = pst.richtmyer_step_bc_plain(*sw_args(x), bx, by)
                    torch.cuda.synchronize()
                    # 'given' leaves the x ghost rows to the caller
                    keep = slice(1, -1) if bx == 'given' else slice(None)
                    ulps = {n: ulp_diff(a[keep], b[keep]) for n, a, b in
                            zip('huv', k[:3], p[:3])}
                    err = max(max_abs(a[keep], b[keep])
                              for a, b in zip(k[:3], p[:3]))
                    max2_equal = bool(k[3] == p[3])
                    emit('kernel_vs_plain', kernel='richtmyer_step',
                         dtype=str(dtype), nx=nx, ny=ny, bx=bx, by=by,
                         flat=flat, row_f_r=rows, max_ulp=ulps,
                         max_abs_err=err, max2_equal=max2_equal,
                         max2=float(k[3]))
                    check(max(ulps.values()) <= SW_ULP_BOUND and max2_equal,
                          f'richtmyer_step {nx}x{ny} {dtype} ({bx}, {by}) '
                          f'flat={flat}: {ulps} ulp, max2 equal {max2_equal}')
                    # the main paths' shapes and modes: the whole grid's
                    # walls/walls and a shard's given/walls
                    if ((nx, ny, bx, by, flat) in (
                            (SW['nx'], SW['ny'], 'walls', 'walls', True),
                            (*shard, 'given', 'walls', True))
                            and dtype == torch.float32):
                        at_main['richtmyer_step'] = max(
                            err, at_main.get('richtmyer_step', 0.0))
        # ok False freezes the step; a NaN in u makes max2 NaN
        x = sw_inputs(gen, *SW_RAGGED, dtype, dev, False, False)
        x['u'][5, 7] = float('nan')
        for ok in (True, False):
            x['ok'] = torch.tensor(ok, device=dev)
            k = csl.richtmyer_step(*sw_args(x), bx='walls', by='periodic')
            p = pst.richtmyer_step_bc_plain(*sw_args(x), 'walls', 'periodic')
            ulps = {n: ulp_diff(a, b) for n, a, b in zip('huv', k[:3], p[:3])}
            frozen = all(torch.equal(a[1:-1, 1:-1].nan_to_num(7.0),
                                     b[1:-1, 1:-1].nan_to_num(7.0))
                         for a, b in zip(k[:3], (x['h'], x['u'], x['v'])))
            emit('kernel_vs_plain', kernel='richtmyer_step', dtype=str(dtype),
                 case='nan_in_u', ok=ok, max_ulp=ulps,
                 max2_nan=bool(torch.isnan(k[3])), frozen=frozen)
            check(max(ulps.values()) <= SW_ULP_BOUND
                  and bool(torch.isnan(k[3])) and bool(torch.isnan(p[3])),
                  f'richtmyer_step NaN case ok={ok} {dtype}: {ulps}')
            check(frozen == (not ok), f'richtmyer_step ok={ok}: frozen '
                  f'{frozen}')
    return at_main


def phase_sw_max2_reset(psw, Omega, R_earth, csl, pst, dev):
    """max2 is reduced inside the step's one launch through a per-stream
    accumulator and block ticket that every launch must leave at zero
    (phase 2e): three back-to-back steps on the same inputs, an f64 step
    between f32 ones, and a step between two ``sw_simulate`` runs all give
    the plain version's max2."""
    import torch
    gen = torch.Generator().manual_seed(42)
    x = sw_inputs(gen, SW['nx'], SW['ny'], torch.float32, dev, True, True)
    x64 = sw_inputs(gen, *SW_RAGGED, torch.float64, dev, False, False)
    want = pst.richtmyer_step_bc_plain(*sw_args(x), 'walls', 'walls')[3]
    want64 = pst.richtmyer_step_bc_plain(*sw_args(x64), 'periodic',
                                         'walls')[3]

    def step():
        return csl.richtmyer_step(*sw_args(x), bx='walls', by='walls')[3]
    got = [step() for _ in range(3)]
    got64 = csl.richtmyer_step(*sw_args(x64), bx='periodic', by='walls')[3]
    got.append(step())
    world = sw_world(psw, Omega, R_earth, *SW_RAGGED, device=dev)
    kw = world._step_kwargs()
    psw.sw_simulate(world.state, world.params, 20, **kw)
    got.append(step())
    psw.sw_simulate(world.state, world.params, 20, **kw)
    got.append(step())
    torch.cuda.synchronize()
    same = [bool(g == want) for g in got]
    emit('sw_max2_reset', max2=float(want), steps_equal_plain=same,
         f64_equal_plain=bool(got64 == want64))
    check(all(same) and bool(got64 == want64),
          f'max2 of repeated steps differs from the plain version: {same}')


def phase_sw_main(psw, Omega, R_earth, csl, dev):
    """The shallow-water main path on the card (phase 3c): bench_sw's El
    Nino world at 2050 x 1026, f32, 400 steps of ``sw_simulate`` (a warm
    run, then the best of 3, each from the initial state), then one
    ``ShallowWater.run`` of 400 steps with snapshots; the wind-free world
    the same way.  The K6 count covers this phase and must equal the steps
    taken.  Checked: ok, finite fields, t equal to the sum of the dts (400
    one-step runs in f32 against one 400-step run, bit for bit)."""
    import numpy as np
    import torch
    nt = SW['nt']
    cells = (SW['nx'] - 2) * (SW['ny'] - 2)
    res = {}
    steps = 0
    csl.reset_launch_counts()
    for el_nino in (True, False):
        # built without naming a device: the card
        world = sw_world(psw, Omega, R_earth, SW['nx'], SW['ny'], el_nino)
        check(world.state.h.is_cuda, 'ShallowWater did not default to the '
              'card')
        kw = world._step_kwargs()
        params = world.params
        state = psw.sw_simulate(world.state, params, nt, **kw)
        torch.cuda.synchronize()
        wall = float('inf')
        for _ in range(3):
            # each run from the initial state: the El Nino world turns
            # unstable near its x-wall/sponge corners after ~500 steps, in
            # the JAX package too, so chained runs would time frozen steps
            t0 = time.perf_counter()
            state = psw.sw_simulate(world.state, params, nt, **kw)
            torch.cuda.synchronize()
            wall = min(wall, time.perf_counter() - t0)
        steps += 4 * nt
        r = dict(cell_updates_per_sec=cells * nt / wall, wall_s=wall,
                 ms_per_step=1e3 * wall / nt, steps=nt,
                 grid=[SW['nx'], SW['ny']], row_geometry=kw['row_geometry'],
                 flat_orography=kw['flat_orography'],
                 ok=bool(state.ok), t_days=float(state.t) / 86400.0)
        check(r['ok'], f'el_nino={el_nino}: the run aborted (dt < 10 s)')
        check(all(bool(torch.isfinite(x).all())
                  for x in (state.h, state.u, state.v)), 'non-finite fields')
        # t is the f32 sum of the dts: 400 one-step runs, then one run
        st = world.state
        t_sum = st.t.clone()
        for _ in range(nt):
            st = psw.sw_simulate(st, params, 1, **kw)
            t_sum = t_sum + st.dt
        one = psw.sw_simulate(world.state, params, nt, **kw)
        steps += 2 * nt
        same = all(torch.equal(getattr(one, k), getattr(st, k))
                   for k in ('h', 'u', 'v', 't'))
        r.update(t_equals_sum_of_dts=bool(one.t == t_sum),
                 one_step_runs_equal_one_run=same)
        check(r['t_equals_sum_of_dts'], 't differs from the sum of the dts')
        check(same, '400 one-step runs differ from one 400-step run')
        if el_nino:
            t0 = time.perf_counter()
            data = world.run(nt=nt, save_every=(nt // 4) * world.dt_0)
            steps += nt
            h_e, h_w = world.get_average_east_west_boundary_thickness(
                data['h'], *(world.initial_info['wind'][k] for k in
                             ('x_average_width', 'y_average_width')))
            r.update(run_wall_s=time.perf_counter() - t0,
                     run_snapshots=int(len(data['t'])),
                     run_t_days=float(data['t'][-1]) / 86400.0,
                     h_east_m=[float(x) for x in h_e[[0, -1]]],
                     h_west_m=[float(x) for x in h_w[[0, -1]]])
            check(len(data['t']) == 5 and all(np.isfinite(data[k]).all()
                                              for k in 'huv'),
                  'ShallowWater.run: wrong snapshots or non-finite fields')
            # reported, not checked: the world past the bench's 400 steps
            # (f dt ~ 0.2 at its y edges grows inertial oscillations), from
            # where run() left it, step nt
            probe, st = [], world.state
            for k in range(1, 7):
                st = psw.sw_simulate(st, params, nt // 4, **kw)
                probe.append([nt + k * (nt // 4), bool(st.ok), float(
                    torch.sqrt(torch.max(st.u * st.u + st.v * st.v)))])
            steps += 6 * (nt // 4)
            r['stability_probe_step_ok_max_speed'] = probe
            res['el_nino'] = r
        else:
            res['no_wind_cell_updates_per_sec'] = r['cell_updates_per_sec']
            res['no_wind_ms_per_step'] = r['ms_per_step']
            res['no_wind'] = r
    launches = dict(csl.launch_counts)
    res.update(launches=launches, steps_taken=steps,
               cell_updates_per_sec=res['el_nino']['cell_updates_per_sec'],
               wall_s=res['el_nino']['wall_s'],
               ms_per_step=res['el_nino']['ms_per_step'], steps=nt,
               grid=[SW['nx'], SW['ny']])
    emit('sw_main', **res)
    check(launches['richtmyer_step_bc'] == steps,
          f'K6 launched {launches["richtmyer_step_bc"]} times for {steps} '
          f'steps')
    check(launches['richtmyer_step_interior'] == 0, 'K5 launched on the run '
          'path')
    return launches['richtmyer_step_bc']


def phase_sw_step_path(psw, Omega, R_earth, csl, dev, n=5):
    """``ShallowWater.time_step`` at 2050 x 1026 goes through K5 plus the
    plain BCs and wind; step by step it equals the run path (K6) from the
    same state, bit for bit (phase 3d)."""
    import torch
    world = sw_world(psw, Omega, R_earth, SW['nx'], SW['ny'], device=dev)
    kw = world._step_kwargs()
    st = world.state
    csl.reset_launch_counts()
    t = 0.0
    worst = 0.0
    for _ in range(n):
        t, _ = world.time_step(t, save_every=1e18)
        k5 = csl.launch_counts['richtmyer_step_interior']
        st = psw.sw_simulate(st, world.params, 1, **kw)
        worst = max([worst] + [max_abs(getattr(world.state, k), getattr(st, k))
                               for k in ('h', 'u', 'v')])
        check(all(torch.equal(getattr(world.state, k), getattr(st, k))
                  for k in ('h', 'u', 'v', 't')),
              'time_step (K5) differs from the run path (K6)')
    launches = dict(csl.launch_counts)
    emit('sw_step_path', steps=n, launches=launches, max_abs_diff=worst,
         bit_equal=worst == 0.0)
    check(k5 > 0, 'K5 never launched on the time_step path')
    return k5


# The sharded phases (parallel/): SHARDS shards of the one card, the way
# JAX's shard_map runs its shards from one controller
SHARDS = 4
SW_2D = dict(nx=SW_SMOKE['nx'], ny=SW_SMOKE['ny'], nt=50, mesh=(2, 2))
# bench_grey's scale-height column at nz=61: 60 layers, which SHARDS divide
LEVEL_SCAN = dict(nz=61, members=4096)
# The level-sharded scan against the unsharded scan and the walk, as the
# largest |difference| over the largest |flux| of each stream.  The f32
# recurrence's own rounding is the bound's scale: on the CPU (4 shards, 4096
# members) the unsharded scan and the walk differ by 1.1e-5 of the largest
# up flux, the sharded scan by 6.0e-6 and 1.1e-5 from them; 5e-5 leaves a
# factor of 4.  f64: 2.3e-14 and below.
LEVEL_SCAN_REL_BOUND = {'torch.float32': 5e-5, 'torch.float64': 1e-12}


def level_scan_inputs(GreyGas, p_surface_earth, members, dtype, dev):
    """The level scan's inputs: the bench_grey world at nz=61 (its |dtau|,
    shared by the members), its analytic radiative-equilibrium T scaled to
    each member's insolation F in HEADLINE['F'] (T ~ F^(1/4)), and the TOA
    boundary (1 - albedo) F / 4."""
    import numpy as np
    import torch
    world = build_world(GreyGas, p_surface_earth, LEVEL_SCAN['nz'], 'cpu')
    _, _, T_eqb, *_ = world.equilibrium_sol()
    F = np.linspace(*HEADLINE['F'], members)
    T = np.asarray(T_eqb)[:, :1] * (F / world.F_stellar_constant) ** 0.25
    t = lambda a: torch.tensor(a).to(dtype).to(dev)  # noqa: E731
    return (t(T), t(world.dtau[:, 0]),
            t((1.0 - world.albedo[0]) * F / 4.0))


def phase_sharded_sw(psw, phalo, pmesh, Omega, R_earth, csl, dev,
                     devices=None):
    """The x-sharded shallow-water world on the card (phase 3e): bench_sw's
    El Nino world and its wind-free world at 2050 x 1026, f32,
    richtmyer_pallas, through ``ShardedShallowWater(world, mesh).run`` on
    SHARDS shards of the one card: per shard the fused kernel in its
    'given' mode (K6), the halo rows, the pmax'd CFL and the psum'd wind.
    400 steps from the initial state, a warm run then the best of 3, in
    turns with the unsharded ``sw_simulate`` from the same state.  The K6
    count covers the sharded runs only and must be SHARDS x their steps;
    K5 0.  Checked: the wind-free world bit-equal to the unsharded run in
    h, u, v, t and dt; each shard's max2 its own; El Nino within the card
    vs CPU bounds of the unsharded run, ok and finite.  ``devices``: the
    shards' devices (default SHARDS x ``dev``; ``chip_sharded.py`` passes
    one card each); the world and the unsharded runs stay on ``dev``."""
    import torch
    nt = SW['nt']
    cells = (SW['nx'] - 2) * (SW['ny'] - 2)
    devices = devices or [dev] * SHARDS
    mesh = pmesh.make_mesh(('x',), devices=devices)
    res = {}
    sharded_steps = 0
    k6 = k5 = 0
    for el_nino in (True, False):
        world = sw_world(psw, Omega, R_earth, SW['nx'], SW['ny'], el_nino,
                         device=dev)
        st0 = world.state
        kw = world._step_kwargs()
        params = world.params
        sh = phalo.ShardedShallowWater(world, mesh)
        check(sh.use_kernel, f'el_nino={el_nino}: the sharded world is not '
              f'on the kernel path')
        walls, plain_walls = [], []
        for rep in range(4):
            # each run from the initial state (F7: the El Nino world turns
            # unstable near its x-wall/sponge corners after ~500 steps)
            world._state = st0
            csl.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sh.run(nt)                 # reads ok at its end
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k6 += csl.launch_counts['richtmyer_step_bc']
            k5 += csl.launch_counts['richtmyer_step_interior']
            sharded_steps += nt
            t0 = time.perf_counter()
            ref = psw.sw_simulate(st0, params, nt, **kw)
            torch.cuda.synchronize()
            plain_wall = time.perf_counter() - t0
            if rep:                    # the first of each is the warm run
                walls.append(wall)
                plain_walls.append(plain_wall)
        state = world.state
        wall, plain_wall = min(walls), min(plain_walls)
        r = dict(use_kernel=sh.use_kernel, wall_s=wall,
                 ms_per_step=1e3 * wall / nt,
                 cell_updates_per_sec=cells * nt / wall,
                 unsharded_wall_s=plain_wall,
                 unsharded_ms_per_step=1e3 * plain_wall / nt,
                 unsharded_cell_updates_per_sec=cells * nt / plain_wall,
                 runs_s=walls, unsharded_runs_s=plain_walls,
                 local_grid=[sh.local_nx + 2, SW['ny']],
                 ok=bool(state.ok), t_days=float(state.t) / 86400.0,
                 max_dh_m=max_abs(state.h, ref.h),
                 max_du=max_abs(state.u, ref.u),
                 max_dv=max_abs(state.v, ref.v))
        check(r['ok'], f'el_nino={el_nino}: the sharded run aborted')
        check(all(bool(torch.isfinite(x).all())
                  for x in (state.h, state.u, state.v)),
              'sharded run: non-finite fields')
        if el_nino:
            check(r['max_dh_m'] < SW_DH_BOUND_M and r['max_du'] < SW_DU_BOUND
                  and r['max_dv'] < SW_DU_BOUND,
                  f'sharded El Nino vs unsharded: {r}')
            res['el_nino'] = r
        else:
            same = {k: bool(torch.equal(getattr(state, k), getattr(ref, k)))
                    for k in ('h', 'u', 'v', 't', 'dt')}
            own = []
            for i, m in enumerate(sh.max2):
                rows = slice(1 + i * sh.local_nx, 1 + (i + 1) * sh.local_nx)
                u, v = state.u[rows, 1:-1], state.v[rows, 1:-1]
                own.append(bool(m.to(dev) == torch.max(u * u + v * v)))
            r.update(bit_equal=same, max2_per_shard_own=own)
            check(all(same.values()), f'sharded wind-free world differs from '
                  f'the unsharded run: {same}')
            check(all(own), f'a shard\'s max2 is not its own: {own}')
            res['no_wind'] = r
    launches = {'richtmyer_step_bc': k6, 'richtmyer_step_interior': k5}
    res.update(shards=len(devices), devices=[str(d) for d in devices],
               steps=nt, grid=[SW['nx'], SW['ny']],
               launches=launches, sharded_steps_taken=sharded_steps,
               wall_s=res['el_nino']['wall_s'],
               ms_per_step=res['el_nino']['ms_per_step'],
               cell_updates_per_sec=res['el_nino']['cell_updates_per_sec'],
               bound_dh_m=SW_DH_BOUND_M, bound_du=SW_DU_BOUND)
    emit('sharded_sw', **res)
    check(k6 == len(devices) * sharded_steps,
          f'K6 launched {k6} times for {sharded_steps} sharded steps on '
          f'{len(devices)} shards')
    check(k5 == 0, 'K5 launched on the sharded path')
    return k6


def phase_sharded_2d(psw, phalo, pmesh, Omega, R_earth, csl, dev,
                     devices=None):
    """``ShardedShallowWater2D`` on a (2, 2) mesh of the card (phase 3f):
    bench_sw's worlds at the smoke size, richtmyer_pallas, SW_2D['nt']
    steps.  The swap to the plain richtmyer must warn (the kernel has no
    halo mode in y); the wind-free world is bit-equal to the unsharded
    plain richtmyer run, El Nino within the card vs CPU bounds; no
    Richtmyer kernel launches."""
    import warnings
    import torch
    nt = SW_2D['nt']
    mesh = pmesh.make_mesh(('x', 'y'), shape=SW_2D['mesh'],
                           devices=devices or [dev] * SHARDS)
    res = {}
    csl.reset_launch_counts()
    for el_nino in (True, False):
        world = sw_world(psw, Omega, R_earth, SW_2D['nx'], SW_2D['ny'],
                         el_nino, device=dev)
        st0 = world.state
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            sh = phalo.ShardedShallowWater2D(world, mesh)
        warned = any(issubclass(w.category, UserWarning)
                     and 'richtmyer_pallas' in str(w.message) for w in caught)
        t0 = time.perf_counter()
        sh.run(nt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ref = psw.sw_simulate(st0, world.params, nt,
                              **dict(world._step_kwargs(), solver='richtmyer'))
        state = world.state
        r = dict(warned=warned, solver=sh.solver, wall_s=wall,
                 ok=bool(state.ok), max_dh_m=max_abs(state.h, ref.h),
                 max_du=max_abs(state.u, ref.u),
                 max_dv=max_abs(state.v, ref.v))
        check(warned and sh.solver == 'richtmyer',
              'ShardedShallowWater2D swapped richtmyer_pallas without a '
              'UserWarning')
        check(r['ok'] and all(bool(torch.isfinite(x).all())
                              for x in (state.h, state.u, state.v)),
              f'2-D sharded run (el_nino={el_nino}) aborted or non-finite')
        if el_nino:
            check(r['max_dh_m'] < SW_DH_BOUND_M and r['max_du'] < SW_DU_BOUND
                  and r['max_dv'] < SW_DU_BOUND, f'2-D El Nino: {r}')
            res['el_nino'] = r
        else:
            same = {k: bool(torch.equal(getattr(state, k), getattr(ref, k)))
                    for k in ('h', 'u', 'v', 't', 'dt')}
            r['bit_equal'] = same
            check(all(same.values()), f'2-D wind-free world differs from '
                  f'the unsharded run: {same}')
            res['no_wind'] = r
    launches = dict(csl.launch_counts)
    emit('sharded_2d', mesh=list(SW_2D['mesh']), steps=nt,
         grid=[SW_2D['nx'], SW_2D['ny']], launches=launches, **res)
    check(sum(launches.values()) == 0, 'a Richtmyer kernel launched on the '
          '2-D path')


def phase_level_scan(GreyGas, p_surface_earth, pls, pmesh, ts, dev,
                     devices=None):
    """``lw_flux_level_sharded`` on SHARDS shards of the card (phase 3g):
    bench_grey's column at nz=61, LEVEL_SCAN['members'] members, f32,
    against the unsharded scan (``lw_flux_plain``) and the walk
    (``lw_flux``: K1 at [60, members]) within LEVEL_SCAN_REL_BOUND; call
    times of the three by CUDA events."""
    import torch
    dtype = torch.float32
    T, dtau, toa = level_scan_inputs(GreyGas, p_surface_earth,
                                     LEVEL_SCAN['members'], dtype, dev)
    mesh = pmesh.make_mesh(('lev',), devices=devices or [dev] * SHARDS)
    bound_rel = LEVEL_SCAN_REL_BOUND[str(dtype)]
    got = pls.lw_flux_level_sharded(T, dtau, toa, mesh, 'lev')
    res = dict(shape=list(T.shape), shards=mesh.size, dtype=str(dtype),
               bound_rel=bound_rel)
    for name, fn in (('plain_scan', ts.lw_flux_plain), ('walk', ts.lw_flux)):
        ref = fn(T, dtau, toa)
        res[f'rel_err_vs_{name}'] = [
            float((g.double() - r.double()).abs().max()
                  / r.double().abs().max()) for g, r in zip(got, ref)]
    res['finite'] = all(bool(torch.isfinite(g).all()) for g in got)
    res['call_ms'] = {
        'sharded': time_ms(lambda: pls.lw_flux_level_sharded(
            T, dtau, toa, mesh, 'lev'), reps=20),
        'plain_scan': time_ms(lambda: ts.lw_flux_plain(T, dtau, toa),
                              reps=20),
        'walk': time_ms(lambda: ts.lw_flux(T, dtau, toa), reps=20)}
    emit('level_scan', **res)
    check(res['finite'], 'level scan: non-finite fluxes')
    for name in ('plain_scan', 'walk'):
        check(max(res[f'rel_err_vs_{name}']) <= bound_rel,
              f'level scan vs {name}: {res[f"rel_err_vs_{name}"]}')


# parallel/ensemble.py and the dp x sp step (phases 3j-3o) on SHARDS shards
# of the card (chip_sharded.py: one shard a card), each against the
# unsharded run in the same phase.  Bounds, relative to the largest |value|
# (the JAX package's multi-chip dry run, ``__graft_entry__.py``): a dp march
# bit-equal, or 90% of the members at the unsharded step and those within
# DP_REL_BOUND; the band-sharded net flux within RG_TP_REL_BOUND; the real-
# gas marches over the dry run's RG_WINDOW steps within RG_DP_REL_BOUND (dp)
# and RG_DP_TP_REL_BOUND (dp x tp: the psum reassociates the band sum) on
# the active cells (tau > 0.03 at some wavenumber, as RG_CARD_CPU holds the
# card to the CPU); dp x sp within the sharded El Nino bounds.
DP_REL_BOUND = 1e-5
RG_TP_REL_BOUND = 1e-5
RG_DP_REL_BOUND = 1e-5
RG_DP_TP_REL_BOUND = 1e-4
RG_WINDOW = 30
DP_SW = dict(members=4, mesh=(2, SHARDS // 2), steps=20, dh=1e-3)


def device_counts(mods, kernel):
    """Launches of ``kernel`` per device since the last reset."""
    out = {}
    for m in mods:
        for (k, d), n in m.device_launch_counts.items():
            if k == kernel:
                out[d] = out.get(d, 0) + n
    return out


def per_device(devices, counts):
    """Sum per-shard counts over the shards of each device."""
    out = {}
    for d, n in zip(devices, counts):
        out[str(d)] = out.get(str(d), 0) + n
    return out


def march_compare(fs, info, ref, ref_info):
    """Bit-equality and the dp bound's figures of a sharded march against
    the unsharded one."""
    import numpy as np
    import torch
    bit_equal = {
        'T': bool(torch.equal(fs.T, ref.T)),
        't': bool(torch.equal(fs.t, ref.t)),
        'info': all(bool(torch.equal(a, b)) for a, b in zip(info, ref_info))}
    same = (info.steps == ref_info.steps).cpu().numpy()
    T, T_ref = fs.T.double().cpu().numpy(), ref.T.double().cpu().numpy()
    scale = np.abs(T_ref).max()
    err_all = float(np.abs(T - T_ref).max() / scale)
    err_same = (float(np.abs(T[same] - T_ref[same]).max() / scale)
                if same.any() else None)
    return dict(bit_equal=bit_equal, step_agreement=float(same.mean()),
                max_rel_err_step_matched=err_same, max_rel_err=err_all)


def dp_ok(cmp):
    return all(cmp['bit_equal'].values()) or (
        cmp['step_agreement'] >= 0.9
        and cmp['max_rel_err_step_matched'] < DP_REL_BOUND)


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_dp_grey(ens, pens, pmesh, GreyGas, p_surface_earth, mods, cts, ts,
                  dev, devices=None):
    """bench_grey's headline (4096 members, nz 60, F 800-1600 W/m^2) with
    the members on 'data' = SHARDS (phase 3j): the unsharded march, then
    ``grey_evolve_ensemble_sharded``, then each one's f64 finish
    (``grey_finish_unconverged_f64`` and its sharded form).  K3 launches
    once per shard and iteration on the shard's device; the sharded march
    is held to the unsharded one (bit-equal expected: K3 is a warp a
    member).  Then K3 timed at a shard's 59 x 1024 against its plain twin,
    and held to it."""
    import numpy as np
    import torch
    devices = devices or [dev] * SHARDS
    mesh = pmesh.make_mesh(('data',), devices=devices)
    world = build_world(GreyGas, p_surface_earth, HEADLINE['nz'], dev)
    F = np.linspace(*HEADLINE['F'], HEADLINE['members'])
    states, forcings, p_int, p_c = ens.grey_ensemble(world, F)
    ft, kw = HEADLINE['flux_thresh'], dict(max_steps=HEADLINE['max_steps'])
    (ref, ref_info), wall_1 = timed(lambda: ens.grey_evolve_ensemble(
        states, forcings, p_int, p_c, ft, **kw))
    reset_counts(mods)
    tel = {}
    (fs, info), wall = timed(lambda: pens.grey_evolve_ensemble_sharded(
        mesh, states, forcings, p_int, p_c, ft, telemetry=tel, **kw))
    k3_dev = device_counts(mods, 'net_stats_walk')
    want_dev = per_device(devices, tel['iterations'])
    (fin_1, fin_info_1, finished_1), f64_wall_1 = timed(
        lambda: ens.grey_finish_unconverged_f64(ref, ref_info, forcings,
                                                p_int, p_c, ft, **kw))
    reset_counts(mods)
    (fin, fin_info, finished), f64_wall = timed(
        lambda: pens.grey_finish_unconverged_f64_sharded(
            mesh, fs, info, forcings, p_int, p_c, ft, **kw))
    k3_f64_dev = device_counts(mods, 'net_stats_walk')
    cmp = march_compare(fs, info, ref, ref_info)
    days = float(fs.t.double().sum()) / 86400.0
    days_1 = float(ref.t.double().sum()) / 86400.0
    # K3 at a shard's width against its plain twin, timed
    gen = torch.Generator().manual_seed(13)
    n, b = HEADLINE['nz'] - 1, HEADLINE['members'] // SHARDS
    args = stats_rows(gen, n, b, torch.float32, dev)
    L = ts.topk_depth(n + 1, 95)
    got, want = cts.net_stats_walk(*args, L), ts.net_stats_rows_plain(*args, L)
    ulp = max(ulp_diff(g, w) for g, w in zip(got, want))
    k3_time = dict(timed_pair(lambda: cts.net_stats_walk(*args, L),
                              lambda: ts.net_stats_rows_plain(*args, L)),
                   n=n, b=b, L=L, max_ulp=ulp,
                   bound=bound(4 * (2 * n * b + 3 * (n + 1) * b + b
                                    + (n + 1) * b + 4 * b),
                               13 * n * b + (n + 1) * b * (7 + L)))
    res = dict(members=HEADLINE['members'], nz=world.nz, shards=mesh.size,
               devices=[str(d) for d in devices], wall_s=wall,
               unsharded_wall_s=wall_1, model_days_per_sec=days / wall,
               unsharded_model_days_per_sec=days_1 / wall_1,
               sharded_over_unsharded=days / wall / (days_1 / wall_1),
               iterations=tel['iterations'],
               unsharded_iterations=int(ref_info.steps.max()),
               ms_per_iteration=1e3 * wall / max(tel['iterations']),
               total_steps=int(info.steps.sum()),
               launches_k3_per_device=k3_dev,
               iterations_per_device=want_dev,
               launches_k3_f64_finish_per_device=k3_f64_dev,
               converged_fraction_f32=float(info.equilibrium.double().mean()),
               unsharded_converged_fraction_f32=float(
                   ref_info.equilibrium.double().mean()),
               f64_wall_s=f64_wall, unsharded_f64_wall_s=f64_wall_1,
               f64_finished=int(len(finished)),
               converged_fraction=float(fin_info.equilibrium.double().mean()),
               unsharded_converged_fraction=float(
                   fin_info_1.equilibrium.double().mean()),
               finished_equal=bool(np.array_equal(finished, finished_1)),
               finish_bit_equal=bool(torch.equal(fin.T, fin_1.T)),
               bound_rel=DP_REL_BOUND, k3_at_shard=k3_time, **cmp)
    emit('dp_grey', **res)
    check(k3_dev == want_dev, f'K3 launches per device {k3_dev} != the '
          f'shards\' iterations {want_dev}')
    check(set(k3_f64_dev) <= {str(d) for d in devices},
          f'f64 finish launched K3 off the mesh: {k3_f64_dev}')
    check(dp_ok(cmp), f'grey dp vs unsharded: {cmp}')
    check(res['converged_fraction'] == 1.0
          and res['unsharded_converged_fraction'] == 1.0,
          'grey dp: not every member converged after the f64 finish')
    check(int(info.nan.sum()) == 0 and int(info.failed.sum()) == 0,
          'grey dp: nan or failed members')
    check(ulp == 0, f'K3 at {n} x {b}: {ulp} ulp from its twin')
    return dict(k3=sum(k3_dev.values()) + sum(k3_f64_dev.values()),
                times=k3_time)


def phase_dp_conv(ens, pens, pmesh, GreyGas, p_surface_earth, mods, ccv, pc,
                  dev, devices=None):
    """bench_rce_conv_ensemble (512 members, nz 150, F 1200-1500 W/m^2,
    flux_thresh 0.1) with the members on 'data' = SHARDS, each adjustment
    method (phase 3k): the unsharded march, then the sharded one.  K3
    launches once per shard and iteration, K4 too on isotonic, K8 on
    reference.  Both are held bit-equal (or the dp bound): K8 blends each
    column alone.  Then K4 timed at a shard's 128 x 149 against its
    plain version, and held to it on CPU copies."""
    import numpy as np
    import torch
    devices = devices or [dev] * SHARDS
    mesh = pmesh.make_mesh(('data',), devices=devices)
    world = GreyGas(nz=CONV['nz'], ny=1, device=dev,
                    **thermosphere_kwargs(p_surface_earth))
    F = np.linspace(*CONV['F'], CONV['members'])
    states, forcings, p_int, p_c = ens.grey_ensemble(world, F)
    ft = CONV['flux_thresh']
    out, launches = {}, {'net_stats_walk': 0, 'iso_fit': 0, 'group_blend': 0}
    for method in METHODS:
        kw = dict(convective_adjust=True, conv_method=method,
                  max_steps=CONV['max_steps'])
        (ref, ref_info), wall_1 = timed(lambda: ens.grey_evolve_ensemble(
            states, forcings, p_int, p_c, ft, **kw))
        reset_counts(mods)
        tel = {}
        (fs, info), wall = timed(lambda: pens.grey_evolve_ensemble_sharded(
            mesh, states, forcings, p_int, p_c, ft, telemetry=tel, **kw))
        k3_dev = device_counts(mods, 'net_stats_walk')
        k4_dev = device_counts(mods, 'iso_fit')
        k8_dev = device_counts(mods, 'group_blend')
        want_dev = per_device(devices, tel['iterations'])
        for k in launches:
            launches[k] += read_counts(mods)[k]
        days = float(fs.t.double().sum()) / 86400.0
        days_1 = float(ref.t.double().sum()) / 86400.0
        cmp = march_compare(fs, info, ref, ref_info)
        r = dict(wall_s=wall, unsharded_wall_s=wall_1,
                 model_days_per_sec=days / wall,
                 unsharded_model_days_per_sec=days_1 / wall_1,
                 sharded_over_unsharded=days / wall / (days_1 / wall_1),
                 iterations=tel['iterations'],
                 unsharded_iterations=int(ref_info.steps.max()),
                 launches_k3_per_device=k3_dev,
                 launches_k4_per_device=k4_dev,
                 launches_k8_per_device=k8_dev,
                 iterations_per_device=want_dev,
                 converged_fraction_f32=float(
                     info.equilibrium.double().mean()),
                 unsharded_converged_fraction_f32=float(
                     ref_info.equilibrium.double().mean()), **cmp)
        out[method] = r
        check(k3_dev == want_dev, f'{method}: K3 launches per device '
              f'{k3_dev} != the shards\' iterations {want_dev}')
        check(k4_dev == (want_dev if method == 'isotonic' else {}),
              f'{method}: K4 launches per device {k4_dev}, iterations '
              f'{want_dev}')
        check(k8_dev == (want_dev if method == 'reference' else {}),
              f'{method}: K8 launches per device {k8_dev}, iterations '
              f'{want_dev}')
        check(dp_ok(cmp), f'{method} dp vs unsharded: {cmp}')
        check(int(info.nan.sum()) == 0 and int(info.failed.sum()) == 0,
              f'{method} dp: nan or failed members')
    gen = torch.Generator().manual_seed(14)
    b, n = CONV['members'] // SHARDS, CONV['nz'] - 1
    theta, v = iso_inputs(gen, b, n, torch.float32)
    got = ccv.iso_fit(theta.to(dev), v.to(dev)).cpu()
    ulp = ulp_diff(got, pc.iso_rows_plain(theta, v))
    theta, v = theta.to(dev), v.to(dev)
    k4_time = dict(timed_pair(lambda: ccv.iso_fit(theta, v),
                              lambda: pc.iso_rows_plain(theta, v)),
                   b=b, n=n, max_ulp_vs_cpu=ulp,
                   bound=bound(4 * (2 * b * n + n),
                               2 * b * n + n + 5 * b * n * (n + 1) // 2))
    emit('dp_conv', members=CONV['members'], nz=world.nz, shards=mesh.size,
         devices=[str(d) for d in devices], bound_rel=DP_REL_BOUND,
         k4_at_shard=k4_time, **out)
    check(ulp == 0, f'K4 at {b} x {n}: {ulp} ulp from its plain version')
    return dict(launches=launches, times=k4_time)


def rg_tp_case(prg, pens, pmesh, gas, devices, cache=None):
    """One band-sharded net flux against the unsharded one: the column's
    initial T, every band shard's partial on its device, psum'd."""
    import torch
    mesh = pmesh.make_mesh(('x',), devices=devices)
    tau, ba, F, delta = gas.tau_device, gas.band_arrays, gas._F_star_factor, \
        gas._geom_device[0]
    if cache is None:
        cache = prg.precompute_transmission(tau, ba)
    T = gas.state.T
    T_g = torch.full((1,), float(gas.T_g), dtype=T.dtype, device=T.device)
    bas, caches, Fs, deltas = pens.shard_bands(mesh, 'x', ba, cache, F, delta)
    fn = pens.real_gas_net_fn_band_sharded(
        mesh, 'x', [T_g.to(d) for d in mesh.flat_devices], caches, bas, Fs,
        deltas)
    net, diff = fn(T)
    net1, diff1 = prg.real_gas_net_and_diff_cached(T[..., 0], T_g, cache,
                                                   ba, F, delta)

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())
    return dict(
        nz=gas.nz, n_bands=int(ba.idx.shape[0]),
        lw_bands_per_shard=[int(b.lw_list.numel()) for b in bas],
        rel_err_net=rel(net[..., 0], net1),
        rel_err_net_diff=rel(diff[..., 0], diff1),
        finite=bool(torch.isfinite(net).all()),
        call_ms=time_ms(lambda: fn(T), reps=20),
        unsharded_call_ms=time_ms(lambda: prg.real_gas_net_and_diff_cached(
            T[..., 0], T_g, cache, ba, F, delta), reps=20))


def phase_rg_tp(prg, pens, pmesh, dev, devices=None, hires=None):
    """The real-gas net flux with the bands on 'x' = SHARDS (phase 3l):
    bench_real_gas_earth's column (nz 'auto', 200 bands) and
    bench_real_gas_hires's (nz 400, its f32 cache), each band shard's
    partial summed by psum, against the one-device band sum within
    RG_TP_REL_BOUND; the call times of both.  ``hires``: an nz 400 gas
    already built (its host build takes seconds)."""
    devices = devices or [dev] * SHARDS
    res = {'earth': rg_tp_case(prg, pens, pmesh, earth_gas(prg, 'auto'),
                               devices)}
    res['hires'] = rg_tp_case(prg, pens, pmesh, hires or earth_gas(
        prg, RG_HIRES['nz']), devices)
    emit('rg_tp', shards=len(devices), devices=[str(d) for d in devices],
         bound_rel=RG_TP_REL_BOUND, **res)
    for key, r in res.items():
        check(r['finite'] and r['rel_err_net'] < RG_TP_REL_BOUND,
              f'rg_tp {key}: {r}')


def rg_march_compare(fs, info, ref, ref_info, active):
    """A real-gas march against the unsharded one: the largest relative
    difference of the final T over all cells and over the ``active`` ones
    (tau > 0.03 at some wavenumber: the thin TOA cells' f32 tendency is
    rounding noise, RG_CARD_CPU), and the flags."""
    import numpy as np
    import torch
    T, T_ref = fs.T.double().cpu().numpy(), ref.T.double().cpu().numpy()
    same = (info.steps == ref_info.steps).cpu().numpy()
    scale = np.abs(T_ref).max()
    return dict(bit_equal=bool(torch.equal(fs.T, ref.T)),
                step_agreement=float(same.mean()),
                max_rel_err=float(np.abs(T - T_ref).max() / scale),
                max_rel_err_active=float(
                    np.abs(T - T_ref)[:, active].max() / scale),
                converged_fraction=float(info.equilibrium.double().mean()),
                unsharded_converged_fraction=float(
                    ref_info.equilibrium.double().mean()),
                failed=int(info.failed.sum()), nan=int(info.nan.sum()))


def rg_batch_probe(prg, states, sc, T_gs, args, n_blocks):
    """Whether the real-gas step's products give a member the same bits in
    a batch of B as in a block of B / n_blocks: the interface spline
    ``T @ S.T``, the band product ``_band_matvec`` and the whole
    ``real_gas_net_and_diff_cached``, at ``states``' T."""
    import torch
    tau, ba, F0, delta = args[:4]
    cache = prg.precompute_transmission(tau, ba)
    T, F = states.T[..., 0], F0[None, :] * sc[:, None]
    m = T.shape[0] // n_blocks
    blocks = [slice(k * m, (k + 1) * m) for k in range(n_blocks)]

    def same(fn):
        whole = fn(slice(None))
        return all(bool(torch.equal(whole[b], fn(b))) for b in blocks)
    return dict(
        spline_matmul=same(lambda b: torch.matmul(T[b], ba.S.T)),
        band_matvec=same(lambda b: prg._band_matvec(
            cache.M_sum, prg._planck_terms(T[b], T_gs[b], ba)[0])),
        net_and_diff=same(lambda b: prg.real_gas_net_and_diff_cached(
            T[b], T_gs[b], cache, ba, F[b], delta)[0]))


def phase_rg_dp(prg, ens, pens, pmesh, dev, devices=None):
    """bench_real_gas_earth_ensemble (64 members of the earth column,
    temp_change 0.5, one shared cache) with the members on 'data' = SHARDS
    (dp, phase 3m) and on ('data', 'x') = (2, SHARDS / 2) with the bands
    on 'x' (dp x tp, phase 3n), each beside the unsharded march: the whole
    march (walls; every member must converge), and the first RG_WINDOW
    steps, whose T on the active cells is held to the unsharded window's
    within RG_DP_REL_BOUND (dp) / RG_DP_TP_REL_BOUND (dp x tp) with 90% of
    the members at its step.  A whole march is compared but not bounded:
    a last-bit difference part a free-running f32 march from the unsharded
    one, and the controller's frozen levels keep where each path left
    them.  ``batch_invariant``: which of the step's products give a member
    the same bits in a shard's block as in the whole batch."""
    import numpy as np
    devices = devices or [dev] * SHARDS
    gas = earth_gas(prg, 'auto', temp_change=RG_ENSEMBLE['temp_change'])
    scales = np.linspace(*RG_ENSEMBLE['F'], RG_ENSEMBLE['members'])
    states, sc, T_gs, args = ens.real_gas_ensemble(gas, F_scales=scales)
    kw = dict(t_end=RG_ENSEMBLE['t_end'], max_steps=RG_ENSEMBLE['max_steps'])
    win = dict(kw, max_steps=RG_WINDOW)
    ft = RG_ENSEMBLE['flux_thresh']
    active = np.asarray(gas.tau_interface).max(axis=1)[1:] > 0.03
    (ref, ref_info), wall_1 = timed(lambda: ens.real_gas_evolve_ensemble(
        states, sc, T_gs, *args, ft, **kw))
    ref_w, ref_w_info = ens.real_gas_evolve_ensemble(states, sc, T_gs, *args,
                                                     ft, **win)
    days_1 = float(ref.t.double().sum()) / 86400.0
    meshes = {
        'rg_dp': (pmesh.make_mesh(('data',), devices=devices), None,
                  RG_DP_REL_BOUND),
        'rg_dp_tp': (pmesh.make_mesh(('data', 'x'), shape=(
            2, len(devices) // 2), devices=devices), 'x',
            RG_DP_TP_REL_BOUND)}
    for phase, (mesh, band_axis, bound_rel) in meshes.items():
        tel = {}

        def run(march_kw):
            return pens.real_gas_evolve_ensemble_sharded(
                mesh, states, sc, T_gs, *args, ft, band_axis=band_axis,
                telemetry=tel, **march_kw)
        (fs, info), wall = timed(lambda: run(kw))
        iterations = tel['iterations']
        days = float(fs.t.double().sum()) / 86400.0
        whole = rg_march_compare(fs, info, ref, ref_info, active)
        window = rg_march_compare(*run(win), ref_w, ref_w_info, active)
        emit(phase, members=len(scales), nz=gas.nz, mesh=mesh.shape,
             devices=[str(d) for d in devices], wall_s=wall,
             unsharded_wall_s=wall_1, model_days_per_sec=days / wall,
             unsharded_model_days_per_sec=days_1 / wall_1,
             sharded_over_unsharded=days / wall / (days_1 / wall_1),
             iterations=iterations,
             unsharded_iterations=int(ref_info.steps.max()),
             whole_march=whole, window_steps=RG_WINDOW, window=window,
             bound_rel_window_active=bound_rel,
             batch_invariant=rg_batch_probe(prg, ref, sc, T_gs, args,
                                            mesh.shape['data']))
        check(whole['converged_fraction'] == 1.0
              and whole['unsharded_converged_fraction'] == 1.0
              and whole['failed'] == 0 and whole['nan'] == 0,
              f'{phase}: not every member converged: {whole}')
        check(window['step_agreement'] >= 0.9
              and window['max_rel_err_active'] < bound_rel,
              f'{phase} window: {window}')


def phase_sw_dp_sp(psw, phalo, pmesh, Omega, R_earth, csl, dev,
                   devices=None):
    """bench_sw's El Nino world (2050 x 1026, f32) as an ensemble of
    DP_SW['members'] members (h scaled by 1 + k dh) on ('data', 'x') =
    DP_SW['mesh'] (dp x sp, phase 3o): each data row x-shards its members
    with the plain richtmyer stencils, each member with its own dt, ok and
    wind.  DP_SW['steps'] steps against each member's unsharded plain
    richtmyer run (``sw_simulate``) within the El Nino bounds; no Richtmyer
    kernel launches."""
    import torch
    devices = devices or [dev] * SHARDS
    mesh = pmesh.make_mesh(('data', 'x'), shape=DP_SW['mesh'],
                           devices=devices)
    world = sw_world(psw, Omega, R_earth, SW['nx'], SW['ny'], device=dev)
    st0 = world.state
    kw = dict(world._step_kwargs(), solver='richtmyer')
    n, nt = DP_SW['members'], DP_SW['steps']
    members = [psw.apply_boundary_conditions(
        st0.h * (1 + DP_SW['dh'] * k), st0.u, st0.v, 'walls', 'walls')
        for k in range(n)]
    h, u, v = (torch.stack(f) for f in zip(*members))
    csl.reset_launch_counts()
    ensemble = phalo.ShardedShallowWaterEnsemble(world, mesh, h, u, v)
    out, wall = timed(lambda: ensemble.run(nt))
    launches = dict(csl.launch_counts)
    refs, wall_1 = timed(lambda: [psw.sw_simulate(
        st0.replace(h=m[0], u=m[1], v=m[2]), world.params, nt, **kw)
        for m in members])
    err = {name: max(max_abs(out[i][k], getattr(r, name))
                     for k, r in enumerate(refs))
           for i, name in enumerate(('h', 'u', 'v'))}
    cells = (SW['nx'] - 2) * (SW['ny'] - 2) * n * nt
    res = dict(members=n, mesh=list(DP_SW['mesh']),
               devices=[str(d) for d in devices], steps=nt,
               grid=[SW['nx'], SW['ny']], solver=ensemble.solver,
               wall_s=wall, unsharded_wall_s=wall_1,
               cell_updates_per_sec=cells / wall,
               unsharded_cell_updates_per_sec=cells / wall_1,
               sharded_over_unsharded=wall_1 / wall,
               dt_per_member=[float(x) for x in out[4]],
               ok=[bool(x) for x in out[5]],
               max_dh_m=err['h'], max_du=err['u'], max_dv=err['v'],
               bound_dh_m=SW_DH_BOUND_M, bound_du=SW_DU_BOUND,
               launches=launches)
    emit('sw_dp_sp', **res)
    check(all(res['ok']) and all(bool(torch.isfinite(x).all())
                                 for x in out[:3]),
          'dp x sp: a member aborted or went non-finite')
    check(err['h'] < SW_DH_BOUND_M and err['u'] < SW_DU_BOUND
          and err['v'] < SW_DU_BOUND, f'dp x sp vs unsharded: {err}')
    check(sum(launches.values()) == 0, 'a Richtmyer kernel launched on the '
          'dp x sp path')


# The ranks phase: one process a card (parallel/launch.run_ranks, NCCL), on
# 4, 2 or 1 of the cards, the most that divide bench_sw's interior nx and the
# headline's members
RANKS_PHASE_MAX = 4
RANKS_TIMEOUT_S = 300


def rank_count(n_cards):
    """The ranks of the ranks phase on ``n_cards`` cards: 4, 2 or 1."""
    return max(r for r in (1, 2, RANKS_PHASE_MAX) if r <= n_cards)


def rank_headline(mesh):
    """The ranks phase in each rank (``run_ranks``; ``mesh`` the ranks on
    'x'): bench_grey's headline with the members on the ranks ('data'),
    then bench_sw's El Nino world at 2050 x 1026 x-sharded on K6's 'given'
    mode, 400 steps, each after a warm run; the kernel counts set to 0
    before each timed run and read after it."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from climatemodel_tpu_torch.constants import Omega, R_earth, \
        p_surface_earth
    from climatemodel_tpu_torch.models import ensemble as ens
    from climatemodel_tpu_torch.models import shallow_water as psw
    from climatemodel_tpu_torch.models.grey import GreyGas
    from climatemodel_tpu_torch.parallel import ensemble as pens
    from climatemodel_tpu_torch.parallel import halo as phalo
    from climatemodel_tpu_torch.parallel import launch
    from climatemodel_tpu_torch.parallel import mesh as pmesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    data = pmesh.ProcessMesh(('data',), device=dev)
    world = build_world(GreyGas, p_surface_earth, HEADLINE['nz'], dev)
    states, forcings, p_int, p_c = ens.grey_ensemble(
        world, np.linspace(*HEADLINE['F'], HEADLINE['members']))

    def grey(max_steps, tel=None):
        return pens.grey_evolve_ensemble_sharded(
            data, states, forcings, p_int, p_c, HEADLINE['flux_thresh'],
            telemetry=tel, max_steps=max_steps)

    def timed_run(fn):
        torch.cuda.synchronize()
        dist.barrier()
        launch.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, launch.launch_counts()

    grey(20)                                               # warm
    tel = {}
    (fs, info), grey_wall, counts = timed_run(
        lambda: grey(HEADLINE['max_steps'], tel))
    sw = sw_world(psw, Omega, R_earth, SW['nx'], SW['ny'], True, device=dev)
    st0 = sw.state
    sh = phalo.ShardedShallowWater(sw, mesh)
    sh.run(SW['nt'])                                       # warm
    sw._state = st0
    _, sw_wall, sw_counts = timed_run(lambda: sh.run(SW['nt']))
    st = sw.state
    return dict(grey=dict(T=fs.T, t=fs.t, steps=info.steps,
                          equilibrium=info.equilibrium),
                sw=dict(h=st.h, u=st.u, v=st.v, t=st.t, dt=st.dt, ok=st.ok),
                iterations=tel['iterations'][0], grey_wall_s=grey_wall,
                k3=counts['net_stats_walk'], sw_wall_s=sw_wall,
                k6=sw_counts['richtmyer_step_bc'],
                k5=sw_counts['richtmyer_step_interior'],
                use_kernel=sh.use_kernel, card=str(dev),
                name=torch.cuda.get_device_name(dev))


def phase_ranks(ens, pens, phalo, pmesh, launch, psw, GreyGas,
                p_surface_earth, Omega, R_earth):
    """The compositions SPMD (phase 3l): ``run_ranks(rank_headline, n)``
    on n = 4, 2 or 1 of the cards, one NCCL rank each, against the same
    compositions on the single-controller mesh of the same cards in this
    process: the grey headline's T, t, steps and equilibrium flags, and El
    Nino's h, u, v, t, dt and ok bit-equal; K3 once per rank and
    iteration, K6 once per rank and step (K5 never), each on its rank's
    card.  Walls of the timed runs, the ranks' beside the
    single-controller's."""
    import numpy as np
    import torch
    n = rank_count(torch.cuda.device_count())
    devices = [torch.device('cuda', i) for i in range(n)]
    t0 = time.perf_counter()
    out = launch.run_ranks(rank_headline, n, timeout_s=RANKS_TIMEOUT_S)
    ranks_wall = time.perf_counter() - t0
    # the same compositions on the single-controller mesh of the same cards
    world = build_world(GreyGas, p_surface_earth, HEADLINE['nz'], devices[0])
    states, forcings, p_int, p_c = ens.grey_ensemble(
        world, np.linspace(*HEADLINE['F'], HEADLINE['members']))
    (fs, info), grey_wall = timed(lambda: pens.grey_evolve_ensemble_sharded(
        pmesh.make_mesh(('data',), devices=devices), states, forcings, p_int,
        p_c, HEADLINE['flux_thresh'], max_steps=HEADLINE['max_steps']))
    sw = sw_world(psw, Omega, R_earth, SW['nx'], SW['ny'], True,
                  device=devices[0])
    st0 = sw.state
    sh = phalo.ShardedShallowWater(sw, pmesh.make_mesh(('x',),
                                                       devices=devices))
    sh.run(SW['nt'])                                       # warm
    sw._state = st0
    _, sw_wall = timed(lambda: sh.run(SW['nt']))
    want = dict(grey=dict(T=fs.T, t=fs.t, steps=info.steps,
                          equilibrium=info.equilibrium),
                sw={k: getattr(sw.state, k) for k in ('h', 'u', 'v', 't',
                                                      'dt', 'ok')})
    equal = []
    for r, (got, _) in enumerate(out):
        equal.append({f'{part}.{k}': bool(np.array_equal(
            got[part][k], w.cpu().numpy()))
            for part in ('grey', 'sw') for k, w in want[part].items()})
    res = dict(
        ranks=n, cards=[g['card'] for g, _ in out],
        names=sorted({g['name'] for g, _ in out}),
        run_ranks_wall_s=ranks_wall,
        grey_wall_s=[g['grey_wall_s'] for g, _ in out],
        single_controller_grey_wall_s=grey_wall,
        iterations=[g['iterations'] for g, _ in out],
        launches_k3=[g['k3'] for g, _ in out],
        sw_steps=SW['nt'], sw_ms_per_step=[1e3 * g['sw_wall_s'] / SW['nt']
                                           for g, _ in out],
        single_controller_sw_ms_per_step=1e3 * sw_wall / SW['nt'],
        launches_k6=[g['k6'] for g, _ in out],
        launches_k5=[g['k5'] for g, _ in out],
        bit_equal=[all(e.values()) for e in equal],
        not_equal=[[k for k, v in e.items() if not v] for e in equal])
    emit('ranks', **res)
    check(all(res['bit_equal']), f'ranks vs the single-controller mesh: '
          f'{res["not_equal"]}')
    check(all(g['use_kernel'] for g, _ in out), 'a rank is not on K6')
    check(res['launches_k3'] == res['iterations']
          and all(k > 0 for k in res['launches_k3']),
          f'K3 per rank {res["launches_k3"]} != its iterations '
          f'{res["iterations"]}')
    check(res['launches_k6'] == [SW['nt']] * n and not any(
        res['launches_k5']), f'K6/K5 per rank {res["launches_k6"]}, '
        f'{res["launches_k5"]}')
    check(int(info.nan.sum()) == 0 and int(info.failed.sum()) == 0,
          'ranks: nan or failed members')
    print(f'ranks: {n}', flush=True)
    return dict(k3=sum(res['launches_k3']), k6=sum(res['launches_k6']))


def phase_sw_card_vs_cpu(psw, Omega, R_earth, dev, full_steps=20):
    """The card against the port's plain path on the CPU from one shared
    state, free running: the full-width El Nino world for ``full_steps``
    steps and the bench's CPU smoke size 258 x 130 for all 400 (phase 4d)."""
    res = {}
    for name, nx, ny, nt in (('full', SW['nx'], SW['ny'], full_steps),
                             ('smoke', SW_SMOKE['nx'], SW_SMOKE['ny'],
                              SW_SMOKE['nt'])):
        world = sw_world(psw, Omega, R_earth, nx, ny, device=dev)
        kw = world._step_kwargs()
        card = psw.sw_simulate(world.state, world.params, nt, **kw)
        cpu_state = world.state.map(lambda x: x.cpu())
        cpu_params = world.params.map(lambda x: x.cpu())
        cpu = psw.sw_simulate(cpu_state, cpu_params, nt, **kw)
        res[name] = dict(grid=[nx, ny], steps=nt,
                         max_dh_m=max_abs(card.h.cpu(), cpu.h),
                         max_du=max_abs(card.u.cpu(), cpu.u),
                         max_dv=max_abs(card.v.cpu(), cpu.v),
                         t_card=float(card.t), t_cpu=float(cpu.t))
    emit('sw_card_vs_cpu', bound_dh_m=SW_DH_BOUND_M, bound_du=SW_DU_BOUND,
         **res)
    for name, r in res.items():
        check(r['max_dh_m'] < SW_DH_BOUND_M and r['max_du'] < SW_DU_BOUND
              and r['max_dv'] < SW_DU_BOUND,
              f'shallow water card vs CPU ({name}): {r}')


def phase_sw_profile(psw, Omega, R_earth, dev, nt=100):
    """Where an El Nino step's time goes (phase 4e): ``nt`` steps of
    ``sw_simulate`` at 2050 x 1026 under ``torch.profiler`` (CUDA activity):
    device operations per step, the device's idle share, and the fused
    kernel's device time against the rest (the wind's masked means, the max2 recompute, the
    scalar controller, the ghost re-zero)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    world = sw_world(psw, Omega, R_earth, SW['nx'], SW['ny'], device=dev)
    kw = world._step_kwargs()
    psw.sw_simulate(world.state, world.params, 5, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        psw.sw_simulate(world.state, world.params, nt, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    fused = sum(r[0] for r in rows if 'richtmyer_kernel' in r[2]) / 1e6
    res = dict(steps=nt, wall_s=wall, ms_per_step=1e3 * wall / nt,
               device_busy_s=busy,
               device_idle_share=1 - busy / wall if busy > 0 else None,
               device_ops_per_step=sum(r[1] for r in rows) / nt,
               fused_kernel_ms_per_step=1e3 * fused / nt,
               rest_ms_per_step=1e3 * (busy - fused) / nt,
               top_kernels_ms=[[k[:60], round(t / 1e3, 3), c] for t, c, k in
                               sorted(rows, reverse=True)[:8]])
    emit('sw_profile', **res)
    return res


def phase_sharded_profile(psw, phalo, pmesh, Omega, R_earth, dev, nt=100):
    """Where a sharded El Nino step's time goes (phase 4f): ``nt`` steps of
    ``ShardedShallowWater.run`` on SHARDS shards of the card under
    ``torch.profiler``: device operations per step, the device's idle share,
    the fused kernel's device time a step (SHARDS launches) against the rest
    (halo copies, collectives, the wind, the max2 recompute)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    world = sw_world(psw, Omega, R_earth, SW['nx'], SW['ny'], device=dev)
    st0 = world.state
    sh = phalo.ShardedShallowWater(world, pmesh.make_mesh(
        ('x',), devices=[dev] * SHARDS))
    sh.run(5)
    world._state = st0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sh.run(nt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    fused = sum(r[0] for r in rows if 'richtmyer_kernel' in r[2]) / 1e6
    fused_n = sum(r[1] for r in rows if 'richtmyer_kernel' in r[2])
    res = dict(steps=nt, shards=SHARDS, wall_s=wall,
               ms_per_step=1e3 * wall / nt, device_busy_s=busy,
               device_idle_share=1 - busy / wall if busy > 0 else None,
               device_ops_per_step=sum(r[1] for r in rows) / nt,
               fused_kernel_ms_per_step=1e3 * fused / nt,
               fused_kernel_ms_per_launch=(1e3 * fused / fused_n
                                           if fused_n else None),
               fused_launches_recorded=fused_n,
               rest_ms_per_step=1e3 * (busy - fused) / nt,
               top_kernels_ms=[[k[:60], round(t / 1e3, 3), c] for t, c, k in
                               sorted(rows, reverse=True)[:8]])
    emit('sharded_profile', **res)
    return res


def phase_sw_times(csl, pst, dev):
    """The fused step at 2050 x 1026 f32 against its plain version (phase
    5b): K6 walls/walls with row f and r and flat orography (the bench
    world's configuration, outputs double-buffered as the run does) and K5
    with the same inputs.  Bound: the bytes the function must move (h, u, v
    read once, the f and r rows, the outputs written once) over the card's
    memory rate, and its operations (``SW_OPS_FLAT`` a cell) over its f32
    rate.  No single PyTorch call computes the step, so no library time."""
    import torch
    gen = torch.Generator().manual_seed(41)
    nx, ny = SW['nx'], SW['ny']
    x = sw_inputs(gen, nx, ny, torch.float32, dev, True, True)
    bufs = tuple(torch.empty_like(x['h']) for _ in range(3))
    args = sw_args(x)
    cells = (nx - 2) * (ny - 2)
    read = 4 * (3 * nx * ny + 2 * (ny - 2))
    res = {
        'richtmyer_step_bc': dict(timed_pair(
            lambda: csl.richtmyer_step(*args, bx='walls', by='walls',
                                       out=bufs),
            lambda: pst.richtmyer_step_bc_plain(*args, 'walls', 'walls')),
            grid=[nx, ny], mode='walls/walls',
            bound=bound(read + 4 * (3 * nx * ny + 1), SW_OPS_FLAT * cells)),
        'richtmyer_step_interior': dict(timed_pair(
            lambda: csl.richtmyer_step(*args),
            lambda: pst.richtmyer_step_interior_plain(*args)),
            grid=[nx, ny], mode='interior',
            bound=bound(read + 4 * (3 * cells + 1), SW_OPS_FLAT * cells)),
    }
    # one shard of the sharded run: K6 'given' on [lnx + 2, ny]; it writes
    # no x ghost row
    sx = (nx - 2) // SHARDS + 2
    xs = sw_inputs(gen, sx, ny, torch.float32, dev, True, True)
    sbufs = tuple(torch.empty_like(xs['h']) for _ in range(3))
    sargs = sw_args(xs)
    scells = (sx - 2) * (ny - 2)
    res['richtmyer_step_given'] = dict(timed_pair(
        lambda: csl.richtmyer_step(*sargs, bx='given', by='walls', out=sbufs),
        lambda: pst.richtmyer_step_bc_plain(*sargs, 'given', 'walls')),
        grid=[sx, ny], mode='given/walls',
        bound=bound(4 * (3 * sx * ny + 2 * (ny - 2))
                    + 4 * (3 * (sx - 2) * ny + 1), SW_OPS_FLAT * scells))
    emit('kernel_times', **res)
    return res


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """(ms, 'bytes' | 'operations'): the least time the card could take to
    move ``nbytes`` and do ``ops`` operations at its published peaks (f32
    unless ``ops_per_s`` names another rate)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / ops_per_s * 1e3
    return (t_b, 'bytes') if t_b >= t_o else (t_o, 'operations')


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


def device_ms(fn, reps=20):
    """Device time per call of ``fn``: the kernels' time summed over a
    ``torch.profiler`` (CUPTI) window of ``reps`` calls, host gaps
    excluded; None if the profiler saw no device time.

    After a session of ~10^5 kernels in the same process, later sessions
    can record fewer launches than ran (measured on the H100: 14 of 20),
    so a sum over ``reps`` would read low.  Where the launches recorded are
    not a multiple of ``reps``, a function of one kernel takes the mean of
    the launches recorded, and any other returns None (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if not rows:
        return None
    us = sum(r[0] for r in rows)
    if sum(r[1] for r in rows) % reps == 0:
        return us / reps / 1e3
    return us / rows[0][1] / 1e3 if len(rows) == 1 else None


def timed_pair(kern, plain):
    """Kernel and plain version: CUDA events around 50 back-to-back calls,
    in turns plain, kernel, kernel, plain (``call_ms``: what a call costs,
    the wrapper's host work included), and the device time of each from the
    profiler.  ``ms`` is the kernel's device time where the profiler gives
    one."""
    p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                      time_ms(plain))
    k_dev, p_dev = device_ms(kern), device_ms(plain)
    return dict(ms=k_dev if k_dev is not None else min(k1, k2),
                plain_ms=min(p1, p2), call_ms=min(k1, k2),
                device_ms=k_dev, plain_device_ms=p_dev,
                runs_ms=[p1, k1, k2, p2])


def phase_times(cts, ts, ccv, pc, dev, probe, rg_iso_shape):
    """Every kernel against its plain version, CUDA events (phase 5): K1 at
    the single world's [99, 1] (where the main path launches it), the
    headline's [59, 4096] and the EBM's [39, 64]; K3 at 4096 x 59, at the
    convective ensemble's 512 x 149 and at the EBM ensemble's 64 x 39 in
    f32 and f64; K4 at 512 x 149, at 4096 x 59 and at the real-gas
    convective column's 1 x n, K7 on the probe's inputs
    beside the PyTorch function of the same three quotients.  Each entry
    carries its bound: the larger of the bytes the function must move (each
    input read once, each output written once) over the card's memory rate
    and its operations (a division or an exp counted as one) over the
    card's rate for their dtype."""
    import torch
    gen = torch.Generator().manual_seed(5)
    res = {}
    ebm = (EBM['nz'] - 1, EBM['ny'])
    for n, b in (K1_MAIN, (59, HEADLINE['members']), ebm):
        T, dtau, toa = walk_inputs(gen, n, b, torch.float32, dev)
        key = 'lw_walk' if (n, b) == K1_MAIN else f'lw_walk_{n}x{b}'
        res[key] = dict(timed_pair(
            lambda: cts.lw_walk(T, dtau, toa),
            lambda: ts.lw_flux_sequential(T, dtau, toa)), n=n, b=b,
            # per level: T^2, T^4, sigma*, 2 exp, 2 x (mul, sub, mul, add)
            bound=bound(4 * (2 * n * b + b + 2 * (n + 1) * b), 13 * n * b))
    n, b = 59, HEADLINE['members']
    for n_, b_, dtype in ((n, b, torch.float32),
                          (CONV['nz'] - 1, CONV['members'], torch.float32),
                          ebm + (torch.float32,), ebm + (torch.float64,)):
        args = stats_rows(gen, n_, b_, dtype, dev)
        L = ts.topk_depth(n_ + 1, 95)
        key = ('net_stats_walk' if b_ == b else f'net_stats_walk_{n_}x{b_}'
               + ('_f64' if dtype == torch.float64 else ''))
        size, rate = ((8, F64_OPS_PER_S) if dtype == torch.float64 else
                      (4, F32_OPS_PER_S))
        res[key] = dict(timed_pair(
            lambda: cts.net_stats_walk(*args, L),
            lambda: ts.net_stats_rows_plain(*args, L)), n=n_, b=b_, L=L,
            dtype=str(dtype),
            # the walk, + per interface: the net (3), |net - prev| (2),
            # |net| and its max (2), a comparison with each of the L kept
            bound=bound(size * (2 * n_ * b_ + 3 * (n_ + 1) * b_ + b_
                                + (n_ + 1) * b_ + 4 * b_),
                        13 * n_ * b_ + (n_ + 1) * b_ * (7 + L), rate))
    gen = torch.Generator().manual_seed(6)
    for b_, n_ in ISO_SHAPES[:2] + [rg_iso_shape]:
        theta, v = (x.to(dev) for x in iso_inputs(gen, b_, n_, torch.float32))
        res[f'iso_fit_{b_}x{n_}'] = dict(timed_pair(
            lambda: ccv.iso_fit(theta, v), lambda: pc.iso_rows_plain(theta, v)),
            b=b_, n=n_,
            # theta and v read, the fit written; the products v * theta and
            # the prefix sums' adds, and per (s <= t) pair two subtractions,
            # the division, min, max
            bound=bound(4 * (2 * b_ * n_ + n_),
                        2 * b_ * n_ + n_ + 5 * b_ * n_ * (n_ + 1) // 2))
    a, bb = probe['a'], probe['b']
    C = torch.tensor(pc.DIV_PROBE_C, dtype=torch.float32, device=dev)

    def library():
        return (torch.div(a, bb), torch.div(C * a, bb),
                torch.div(a, bb.abs()))
    res['div_probe'] = dict(
        timed_pair(lambda: ccv.div_probe(a, bb),
                   lambda: pc.div_probe_plain(a, bb)),
        library_fn='torch.div(a, b), torch.div(C * a, b), '
                   'torch.div(a, b.abs())',
        library_ms=time_ms(library), library_device_ms=device_ms(library),
        shape=list(a.shape),
        # three divisions, one product, one |b| per element
        bound=bound(4 * 5 * a.numel(), 5 * a.numel()))
    emit('kernel_times', **res)
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
    from climatemodel_tpu_torch import bench as pbench
    from climatemodel_tpu_torch import cli as pcli
    from climatemodel_tpu_torch.constants import F_sun, Omega, R_earth, \
        p_surface_earth
    from climatemodel_tpu_torch.diagnostics import sensitivity as psens
    from climatemodel_tpu_torch.models import ensemble as ens
    from climatemodel_tpu_torch.models import column as pcol
    from climatemodel_tpu_torch.models import ice_albedo as pice
    from climatemodel_tpu_torch.models import real_gas as prg
    from climatemodel_tpu_torch.models import shallow_water as psw
    from climatemodel_tpu_torch.models.grey import GreyGas
    from climatemodel_tpu_torch.ops import convection as pc
    from climatemodel_tpu_torch.ops import cuda_convection as ccv
    from climatemodel_tpu_torch.ops import cuda_stencils as csl
    from climatemodel_tpu_torch.ops import cuda_two_stream as cts
    from climatemodel_tpu_torch.ops import stencils as pst
    from climatemodel_tpu_torch.ops import two_stream as ts
    from climatemodel_tpu_torch.parallel import halo as phalo
    from climatemodel_tpu_torch.parallel import ensemble as pens
    from climatemodel_tpu_torch.parallel import launch
    from climatemodel_tpu_torch.parallel import level_scan as pls
    from climatemodel_tpu_torch.parallel import mesh as pmesh
    from climatemodel_tpu_torch.spectral import earth_tables as pet
    from climatemodel_tpu_torch.spectral import hitran as ph
    from climatemodel_tpu_torch.spectral import humidity as phum
    from climatemodel_tpu_torch.utils import checkpoint as pck
    mods = (cts, ccv)

    dev = torch.device('cuda', 0)
    smi = nvidia_smi_line()
    emit('device', name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ptx_text = build_all()
    cts.library()
    ccv.library()
    csl.library()
    emit('limits', max_topk=cts.max_topk(), iso_fit_max_levels=ccv.max_levels())

    at_main = phase_kernels(cts, ts, dev)
    at_main.update(phase_conv_kernels(ccv, pc, dev))
    blend_times = phase_group_blend(GreyGas, p_surface_earth, ccv, pc, dev)
    at_main.update(phase_sw_kernels(csl, pst, dev))
    phase_sw_max2_reset(psw, Omega, R_earth, csl, pst, dev)
    probe = phase_div_probe(pc, mods, dev, ptx_text)
    main_res = phase_main(ens, GreyGas, p_surface_earth, mods, dev)
    launches = main_res[5]
    conv_res, conv_state = phase_conv_main(ens, GreyGas, p_surface_earth,
                                           mods, dev)
    more = [phase_ebm_main(ens, GreyGas, p_surface_earth, mods),
            phase_ebm_sweep(pice, p_surface_earth, mods),
            phase_march_options(GreyGas, p_surface_earth, mods)]
    # each path's launches, its counts set to 0 before it and read after
    launches = {k: launches[k] + sum(m[k] for m in more) for k in launches}
    phase_rg_tables(pet, ph)
    rg_main = phase_rg_main(prg, phum, mods)
    phase_rg_ensemble(prg, ens, mods)
    rg_hires = phase_rg_hires(prg)
    rg_iso_launches, rg_iso_n = phase_rg_convective(prg, phum, pcol, mods)
    k6_launches = phase_sw_main(psw, Omega, R_earth, csl, dev)
    k5_launches = phase_sw_step_path(psw, Omega, R_earth, csl, dev)
    # parallel/: the x-sharded world on K6's given mode, the 2-D
    # decomposition and the level-sharded flux scan
    k6_sharded = phase_sharded_sw(psw, phalo, pmesh, Omega, R_earth, csl,
                                  dev)
    phase_sharded_2d(psw, phalo, pmesh, Omega, R_earth, csl, dev)
    phase_level_scan(GreyGas, p_surface_earth, pls, pmesh, ts, dev)
    # parallel/ensemble.py and the dp x sp step: the member- and
    # band-sharded compositions; their K3/K4 launches join their kernels'
    dp_grey = phase_dp_grey(ens, pens, pmesh, GreyGas, p_surface_earth,
                            mods, cts, ts, dev)
    dp_conv = phase_dp_conv(ens, pens, pmesh, GreyGas, p_surface_earth,
                            mods, ccv, pc, dev)
    phase_rg_tp(prg, pens, pmesh, dev, hires=rg_hires)
    phase_rg_dp(prg, ens, pens, pmesh, dev)
    phase_sw_dp_sp(psw, phalo, pmesh, Omega, R_earth, csl, dev)
    # the same compositions SPMD: one NCCL rank a card, each rank's K3 and
    # K6 launches join their kernels'
    ranks = phase_ranks(ens, pens, phalo, pmesh, launch, psw, GreyGas,
                        p_surface_earth, Omega, R_earth)
    phase_card_vs_cpu(ens, GreyGas, p_surface_earth, main_res, dev)
    phase_conv_card_vs_cpu(ens, conv_state, dev)
    phase_sw_card_vs_cpu(psw, Omega, R_earth, dev)
    phase_rg_card_vs_cpu(prg, pcol, rg_main)
    # the kernel times before the profiled marches (see device_ms)
    times = phase_times(cts, ts, ccv, pc, dev, probe, (1, rg_iso_n))
    times.update(phase_sw_times(csl, pst, dev))
    phase_sw_profile(psw, Omega, R_earth, dev)
    phase_sharded_profile(psw, phalo, pmesh, Omega, R_earth, dev)
    phase_conv_profile(ens, conv_state)
    phase_ebm_profile(GreyGas, p_surface_earth)
    phase_rg_profile(prg, rg_main)
    # the examples' ice-albedo walkthrough in a process of its own, beside
    # the phases from here to the examples (every march is host-bound;
    # nothing after this point is a kernel timing or a profile)
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context('spawn')) as pool:
        ice_albedo = pool.submit(examples_ice_albedo)
        # the port's CLI, its checkpoints and the real-gas sensitivity
        # (phases 6-8); their launches join their kernels'
        with tempfile.TemporaryDirectory() as out_dir:
            cli_launches, state_file = phase_cli(pcli, mods, csl, F_sun,
                                                 out_dir)
            ck_launches = phase_checkpoint(pcli, GreyGas, pcol, pck, psens,
                                           state_file, mods, out_dir)
        phase_sensitivity_rg(prg, psens, rg_main)
        for k, v in ck_launches.items():
            cli_launches[k] += v
        # the line-accumulation backends, the example scripts (their
        # launches join their kernels') and reverse mode with the
        # kernels' grad guard
        phase_hitran_backends(ph, pet, dev)
        ex_launches = phase_examples(mods, dev, ice_albedo)
    for k, v in ex_launches.items():
        cli_launches[k] += v
    phase_grad(psw, cts, ccv, csl, dev)
    # the port's bench on its smoke rows, in a process of its own; its
    # launches join their kernels'
    for k, v in phase_bench(pbench).items():
        cli_launches[k] = cli_launches.get(k, 0) + v

    def entry(name, source, replaces, n_launch, err, t, library_ms=None):
        return {'name': name, 'route': 'cuda',
                'source': f'climatemodel_tpu_torch/ops/csrc/{source}',
                'replaces': replaces, 'launches': n_launch,
                'max_abs_err': err, 'ms': t['ms'], 'plain_ms': t['plain_ms'],
                'bound_ms': t['bound'][0], 'bound_by': t['bound'][1],
                'library_ms': library_ms}
    iso_main = f'iso_fit_{ISO_SHAPES[0][0]}x{ISO_SHAPES[0][1]}'
    print(json.dumps({'kernels': [
        entry('lw_walk', 'two_stream.cu',
              'climatemodel_tpu/ops/pallas_two_stream.py:120 (_lw_kernel, '
              'K1) and :38 (_lw_kernel_packed, K2)',
              launches['lw_walk'] + cli_launches['lw_walk'],
              at_main['lw_walk'], times['lw_walk']),
        entry('net_stats_walk', 'two_stream.cu',
              'climatemodel_tpu/ops/pallas_two_stream.py:64 '
              '(_net_stats_kernel, K3)',
              launches['net_stats_walk'] + cli_launches['net_stats_walk']
              + dp_grey['k3'] + dp_conv['launches']['net_stats_walk']
              + ranks['k3'],
              at_main['net_stats_walk'], times['net_stats_walk']),
        entry('iso_fit', 'convection.cu',
              'climatemodel_tpu/ops/pallas_isotonic.py:41 (_iso_kernel, K4)',
              conv_res['isotonic']['launches']['iso_fit'] + rg_iso_launches
              + cli_launches['iso_fit'] + dp_conv['launches']['iso_fit'],
              at_main['iso_fit'], times[iso_main]),
        entry('group_blend', 'convection.cu',
              'none (K8; the JAX package retired its blend kernel in r05, '
              'climatemodel_tpu/ops/convection.py:211-217)',
              conv_res['reference']['launches']['group_blend']
              + cli_launches['group_blend']
              + dp_conv['launches']['group_blend'], 0.0,
              blend_times[f'group_blend_{BLEND_TIMED[0][0]}x'
                          f'{BLEND_TIMED[0][1] - 1}']),
        entry('div_probe', 'convection.cu',
              'tools/probe_mosaic_div.py:28 (_kernel of via_pallas, K7)',
              probe['launches'], probe['err'], times['div_probe'],
              # device time beside a device time; the call's CUDA-event
              # time where the profiler dropped the library's launches
              library_ms=(times['div_probe']['library_device_ms']
                          if times['div_probe']['device_ms'] is not None
                          and times['div_probe']['library_device_ms']
                          is not None
                          else times['div_probe']['library_ms'])),
        entry('richtmyer_step', 'stencils.cu',
              'climatemodel_tpu/ops/pallas_stencils.py:158 (_kernel_body, '
              'K5) and :304 (_kernel_frame_body, K6; its bx=given mode '
              ':397, :450)',
              k6_launches + k5_launches + k6_sharded + ranks['k6']
              + cli_launches['richtmyer_step_bc']
              + cli_launches['richtmyer_step_interior'],
              at_main['richtmyer_step'],
              times['richtmyer_step_bc']),
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
