"""A forcing sweep of grey columns on one card: the program's ensemble
march (``models/ensemble.grey_evolve_ensemble``) and its f64 finish of the
members the f32 noise floor blocked (``grey_finish_unconverged_f64``).

One march is one user request: the sweep's forcings in an order drawn from
the seed and the march's index, the f32 march, the finish, and the result
read back to the host.  Every march of a run does the same work.
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from core.yardstick import days, flags

#: members kept per march for the comparison, besides the finished ones
SAMPLE = 8192


def forcings(traffic, seed):
    """[B] stellar constants of the sweep: evenly spaced over the range,
    each moved by up to ``jitter`` of a spacing, drawn from the seed."""
    B = int(traffic['members'])
    lo, hi = traffic['F_range']
    F = np.linspace(lo, hi, B)
    step = (hi - lo) / max(B - 1, 1)
    rng = np.random.default_rng(seed)
    return F + rng.uniform(-0.5, 0.5, B) * step * float(traffic['jitter'])


def order(seed, j, B):
    """The members' order in march ``j``."""
    return np.random.default_rng([seed, j]).permutation(B)


def read_back(fs, info):
    """The user's result of a march, read back to the host: T and the held
    net flux [B, n(+1)], the simulated time and the outcome [B]."""
    host = dict(T=fs.T[:, :, 0], net=fs.net_flux[:, :, 0], t=fs.t,
                equilibrium=info.equilibrium, timed_out=info.timed_out,
                failed=info.failed, nan=info.nan, steps=info.steps)
    return {k: v.cpu().numpy() for k, v in host.items()}


def record(host, finished, F, seed, j, sample=True):
    """The record of march ``j`` from its result on the host (after its
    wall): days, outcome and, with ``sample``, the members kept for the
    comparison: a seeded sample, every member the f64 finish took and the
    longest-marching one."""
    eq, failed, nan = host['equilibrium'], host['failed'], host['nan']
    rec = dict(days=days(host['t']), finished=len(finished), members=len(F),
               unsettled=int((~eq | failed | nan).sum()),
               flags=flags(eq, host['timed_out'], failed, nan))
    if sample:
        keep = np.unique(np.concatenate([
            np.random.default_rng([seed, j, 1]).choice(
                len(F), min(SAMPLE, len(F)), replace=False),
            np.asarray(finished, np.int64), [int(host['steps'].argmax())]]))
        rec['sample'] = dict(F=F[keep], **{
            k: host[k][keep] for k in ('T', 'net', 'equilibrium', 'failed',
                                       'nan', 'steps')})
    return rec


def next_march(t0, seconds, marches, trace):
    """What follows ``marches``: 'done' where the window ends, else what
    the next march is traced for ('device', 'host' or None).  A run marches
    unprofiled until ``seconds`` have passed since ``t0``: those marches
    time the host-clock metrics, since once the profiler has run the
    process's host work runs slower.  A traced run then marches once with
    the card's operations recorded alone (the device metrics) and once with
    the host's operations too (the idle gaps of the breakdown, under the
    host profiler's own cost)."""
    if time.perf_counter() - t0 < seconds:
        return None
    if not trace:
        return 'done'
    return {None: 'device', 'device': 'host'}.get(marches[-1]['traced'],
                                                  'done')


def tracer(kind, device_traces, host_traces):
    """The profiler of a march traced for ``kind`` (see
    :func:`next_march`), or None."""
    from core.trace import profiled
    if kind is None:
        return None
    return (profiled(device_traces) if kind == 'device'
            else profiled(host_traces, host=True))


def program_world(cfg, device):
    """The program's world of a configuration file."""
    from climatemodel_tpu_torch.models.grey import GreyGas
    w = cfg['world']
    kw = {k: w[k] for k in ('tau_lw_func', 'tau_lw_func_args', 'tau_sw_func',
                            'tau_sw_func_args', 'albedo', 'temp_change',
                            'delta_temp_change') if w.get(k) is not None}
    return GreyGas(nz=int(w['nz']), ny=1, device=device,
                   dtype=getattr(torch, cfg['dtype']), **kw)


def march_options(cfg, traffic):
    """(flux threshold, march keywords, finish keywords, warm-up steps)."""
    m = cfg['march']
    kw = dict(max_steps=int(m['max_steps']), t_end=float(m['t_end']))
    if m.get('convective_adjust'):
        kw.update(convective_adjust=True, conv_method=traffic['conv_method'])
    fin = dict(finish_repeats=int(m['finish_repeats']),
               finish_max_steps=int(m['finish_max_steps']))
    return float(m['flux_thresh']), kw, fin, int(m['warm_steps'])


class Sweep:
    """The program's world and the cell's inputs, built and warmed."""

    def __init__(self, cfg, traffic, seed, device):
        clock = [time.perf_counter()]
        self.setup = {}

        def mark(phase):
            clock.append(time.perf_counter())
            self.setup[phase] = clock[-1] - clock[-2]
        from climatemodel_tpu_torch.models import ensemble
        from climatemodel_tpu_torch.ops import (cuda_convection,
                                                cuda_two_stream)
        self.ens = ensemble
        mark('program_import')
        if device.type == 'cuda':
            torch.zeros(1, device=device)
            torch.cuda.synchronize(device)
            mark('cuda_context')
            cuda_two_stream.library()
            cuda_convection.library()
            mark('kernels')
        self.world = program_world(cfg, device)
        self.ft, self.march_kw, self.finish_kw, warm = march_options(
            cfg, traffic)
        self.seed = seed
        self.F = forcings(traffic, seed)
        self.device = device
        mark('world_inputs')
        self._warm(warm)
        mark('warm_up')

    def _warm(self, steps):
        """Every shape of a march: the f32 step at the full member count,
        capped, and an f64 finish of a few of its members."""
        states, fo, p_int, p_c = self.ens.grey_ensemble(self.world, self.F)
        kw = dict(self.march_kw, max_steps=steps)
        fs, info = self.ens.grey_evolve_ensemble(states, fo, p_int, p_c,
                                                 self.ft, **kw)
        few = slice(0, 64)
        sub = (fs.map(lambda x: x[few]), type(info)(*(x[few] for x in info)),
               fo.map(lambda x: x[few]))
        self.ens.grey_finish_unconverged_f64(
            *sub, p_int, p_c, self.ft, finish_repeats=1,
            finish_max_steps=steps, **kw)
        fs.T.cpu()
        self._sync()

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def march(self, j, traced=None):
        """Run march ``j``; ``traced`` wraps its f32 call (a context
        manager) in a traced run.  Returns its record."""
        perm = order(self.seed, j, len(self.F))
        F = self.F[perm]
        t0 = time.perf_counter()
        states, fo, p_int, p_c = self.ens.grey_ensemble(self.world, F)
        with traced or contextlib.nullcontext():
            fs, info = self.ens.grey_evolve_ensemble(
                states, fo, p_int, p_c, self.ft, **self.march_kw)
            self._sync()
        t1 = time.perf_counter()
        iterations = int(info.steps.max())
        fs, info, finished = self.ens.grey_finish_unconverged_f64(
            fs, info, fo, p_int, p_c, self.ft, **self.finish_kw,
            **self.march_kw)
        host = read_back(fs, info)
        t2 = time.perf_counter()
        return dict(wall=t2 - t0, f32_wall=t1 - t0, finish_wall=t2 - t1,
                    iterations=iterations,
                    **record(host, finished, F, self.seed, j))

    def close(self):
        del self.world


def window(c, seed, seconds, trace, device, start_epoch):
    """Set-up and window of one card in this process; ``start_epoch`` is
    the process's start (``time.time``)."""
    before = time.time() - start_epoch
    sweep = Sweep(c['config'], c['traffic'], seed, device)
    cuda = device.type == 'cuda'
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - start_epoch
    traces, host_traces, marches = [], [], []
    t0 = time.perf_counter()
    kind = None
    while kind != 'done':
        rec = sweep.march(len(marches), tracer(kind, traces, host_traces))
        marches.append(dict(rec, traced=kind))
        kind = next_march(t0, seconds, marches, trace)
    window_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    sweep_setup = sweep.setup
    sweep.close()
    del sweep
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return dict(setup_s=setup_s, marches=marches, peak_bytes=peak,
                window_wall=window_wall, traces=traces,
                host_trace=host_traces[0] if host_traces else None,
                setup=dict(imports_and_cuda_init=before, **sweep_setup))
