"""A forcing sweep of grey columns spread over the cards of one host, one
process a card: the program's member-sharded march
(``parallel/ensemble.grey_evolve_ensemble_sharded``) and its f64 finish
(``grey_finish_unconverged_f64_sharded``) under ``parallel/launch.run_ranks``
(NCCL on the cards, gloo on the CPU), with the results gathered onto every
rank.

Every rank builds the whole sweep's inputs from the seed; the program cuts
them into a block of ``members`` a rank.  After each march the ranks agree,
through one broadcast of rank 0's decision, on what follows: the next
march, traced or not, or the window's end.  Rank 0's records, trace and
span log (``utils/timing``) stand for the run's, with every rank's
iterations, traces and peaks beside them.
"""
from __future__ import annotations

import contextlib
import time
import types

import torch

from drivers.column_sweep import (forcings, march_options, next_march,
                                   order, program_world, read_back, record,
                                   tracer)

#: what follows a march, as rank 0 broadcasts it (``next_march``)
NEXT = (None, 'device', 'host', 'done')


def rank_window(mesh, cfg, traffic, seed, seconds, trace):
    """One rank's set-up, window and records (run by ``run_ranks``)."""
    import torch.distributed as dist

    from climatemodel_tpu_torch.models import ensemble
    from climatemodel_tpu_torch.parallel import ensemble as pens
    from core import guard

    dev = mesh.device
    cuda = dev.type == 'cuda'
    axis = mesh.axis_names[0]
    world = program_world(cfg, dev)
    ft, march_kw, fin_kw, warm = march_options(cfg, traffic)
    B = int(traffic['members']) * mesh.size
    F = forcings(dict(traffic, members=B), seed)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # warm-up: the f32 step at the full member count, capped, and an f64
    # finish of a few members a rank
    st, fo, p_int, p_c = ensemble.grey_ensemble(world, F)
    fs, info = pens.grey_evolve_ensemble_sharded(
        mesh, st, fo, p_int, p_c, ft, axis_name=axis,
        **dict(march_kw, max_steps=warm))
    few = slice(0, 16 * mesh.size)
    pens.grey_finish_unconverged_f64_sharded(
        mesh, fs.map(lambda x: x[few]), type(info)(*(x[few] for x in info)),
        fo.map(lambda x: x[few]), p_int, p_c, ft, axis_name=axis,
        finish_repeats=1, finish_max_steps=warm,
        **dict(march_kw, max_steps=warm))
    fs.T.cpu()
    del st, fo, fs, info
    sync()
    dist.barrier()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    start_epoch = time.time()
    traces, host_traces, marches = [], [], []
    t0 = time.perf_counter()
    kind = None
    while kind != 'done':
        j = len(marches)
        Fj = F[order(seed, j, B)]
        ta = time.perf_counter()
        st, fo, p_int, p_c = ensemble.grey_ensemble(world, Fj)
        tel = {}
        with tracer(kind, traces, host_traces) or contextlib.nullcontext():
            fs, info = pens.grey_evolve_ensemble_sharded(
                mesh, st, fo, p_int, p_c, ft, axis_name=axis, telemetry=tel,
                **march_kw)
            sync()
        tb = time.perf_counter()
        iterations = int(info.steps.max())
        fs, info, finished = pens.grey_finish_unconverged_f64_sharded(
            mesh, fs, info, fo, p_int, p_c, ft, axis_name=axis,
            **fin_kw, **march_kw)
        host = read_back(fs, info)
        tc = time.perf_counter()
        marches.append(dict(
            wall=tc - ta, f32_wall=tb - ta, finish_wall=tc - tb,
            iterations=iterations, own_iterations=int(tel['iterations'][0]),
            traced=kind,
            **record(host, finished, Fj, seed, j, sample=mesh.rank == 0)))
        del st, fo, fs, info
        # rank 0's clock decides for every rank
        code = torch.tensor([NEXT.index(
            next_march(t0, seconds, marches, trace))], device=dev)
        dist.broadcast(code, src=0)
        kind = NEXT[int(code.item())]
    window_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    spans = None
    if mesh.rank == 0:
        from climatemodel_tpu_torch.utils import timing
        if hasattr(timing, 'spans'):
            # as dicts: the rank's result travels as plain data
            spans = [s._asdict() for s in timing.spans()]
    return dict(rank=mesh.rank, marches=marches, peak_bytes=peak,
                spans=spans,
                window_wall=window_wall, start_epoch=start_epoch,
                trace=traces[0] if traces else None,
                host_trace=host_traces[0] if host_traces else None,
                forbidden=guard.forbidden_loaded())


def window(c, seed, seconds, trace, device, start_epoch):
    """The window of every rank, run from this process; the record of
    rank 0 with every rank's traces, iterations, peaks and forbidden
    modules beside it."""
    from climatemodel_tpu_torch.parallel.launch import run_ranks
    ranks = int(c['traffic']['ranks'])
    out = run_ranks(rank_window, ranks, device=device.type,
                    args=(c['config'], c['traffic'], seed, seconds, trace),
                    timeout_s=int(seconds) + 900)
    recs = [r for r, _counts in out]
    head = recs[0]
    return dict(
        setup_s=head['start_epoch'] - start_epoch,
        marches=head['marches'], window_wall=head['window_wall'],
        peak_bytes=max(r['peak_bytes'] for r in recs),
        traces=[r['trace'] for r in recs if r['trace'] is not None],
        host_trace=head['host_trace'],
        spans=(None if head['spans'] is None else
               [types.SimpleNamespace(**s) for s in head['spans']]),
        rank_marches=[r['marches'] for r in recs],
        forbidden=sorted({m for r in recs for m in r['forbidden']}))
