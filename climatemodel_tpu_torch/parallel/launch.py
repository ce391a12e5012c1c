"""Run a function on a process mesh: one spawned process a shard.

``run_ranks(fn, world)`` starts ``world`` processes with the ``spawn``
start method, forms their group through a ``file://`` rendezvous in a
fresh temporary directory (no TCP port to race for), builds each rank's
:class:`~.mesh.ProcessMesh` with :func:`~.mesh.init_process_mesh` and calls
``fn(mesh, *args)`` in it.  ``fn`` is defined at module level in an
importable module (``spawn`` pickles it by name).  A script run under
``torchrun --nproc-per-node N`` calls ``init_process_mesh()`` itself
instead.

Every wait carries a limit: the group's own timeout, the result queue's
and the processes' joins.  A rank's exception, a rank that dies, or a run
past ``timeout_s`` raises here, after every rank has been stopped.
"""
from __future__ import annotations

import multiprocessing
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import torch

from . import mesh as pmesh
from .collectives import tree_map

#: the kernel modules whose launch counters a rank reports
_KERNEL_MODULES = ('cuda_two_stream', 'cuda_convection', 'cuda_stencils')


class RankError(RuntimeError):
    """A rank raised, died, or did not finish in time."""


def to_host(x):
    """Tensors (in dicts, lists, tuples and dataclasses) to numpy."""
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_host(v) for v in x]
    if isinstance(x, torch.Tensor) or hasattr(x, '__dataclass_fields__') \
            or (isinstance(x, tuple) and hasattr(x, '_fields')):
        return tree_map(lambda t: t.detach().cpu().numpy(), x)
    if isinstance(x, tuple):
        return tuple(to_host(v) for v in x)
    return x


def launch_counts():
    """Every kernel wrapper's launch count in this process, by kernel."""
    import importlib
    out = {}
    for name in _KERNEL_MODULES:
        mod = importlib.import_module(f'climatemodel_tpu_torch.ops.{name}')
        out.update(mod.launch_counts)
    return out


def reset_launch_counts():
    """Set every kernel wrapper's launch count in this process to 0."""
    import importlib
    for name in _KERNEL_MODULES:
        importlib.import_module(
            f'climatemodel_tpu_torch.ops.{name}').reset_launch_counts()


def _rank_main(fn, rank, world, device, init_method, args_path, timeout_s,
               results):
    import torch.distributed as dist
    try:
        if torch.device(device).type == 'cpu':
            torch.set_num_threads(1)
        with open(args_path, 'rb') as f:
            args = pickle.load(f)
        mesh = pmesh.init_process_mesh(
            device=device, init_method=init_method, rank=rank,
            world_size=world, timeout_s=timeout_s)
        try:
            out = fn(mesh, *args)
            results.put((rank, True, (to_host(out), launch_counts())))
        finally:
            dist.destroy_process_group()
    except BaseException:           # reported, then the rank exits non-zero
        results.put((rank, False, traceback.format_exc()))
        raise


def _stop(procs):
    procs = [p for p in procs if p.pid is not None]      # started
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def run_ranks(fn, world, *, device='cuda', args=(), timeout_s=600):
    """Run ``fn(mesh, *args)`` on ``world`` spawned ranks, one shard each:
    ``mesh`` is the 1-D process mesh ``('x',)`` of every rank, and ``fn``
    builds any other mesh shape over the same ranks itself
    (``ProcessMesh(axis_names, shape, device=mesh.device)``).

    :param device: 'cuda' (one card a rank, NCCL; raises unless there are
        ``world`` cards) or 'cpu' (gloo ranks, one torch thread each).
    :param timeout_s: the limit on the whole run, start-up included, and
        on each collective.
    :return: one ``(result, launch_counts)`` a rank in rank order: ``fn``'s
        return value with every tensor as a numpy array, and the rank's
        kernel launch counts (:func:`launch_counts`).
    :raises RankError: a rank raised or died (every rank is stopped
        first), or the run passed ``timeout_s`` (likewise).
    """
    if torch.device(device).type == 'cuda':
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < world:
            raise ValueError(
                f'run_ranks: {world} ranks on {n} CUDA device(s): NCCL takes '
                f'one rank a card.  To put several shards on one card, use '
                f'the single-controller mesh, make_mesh(axis_names, '
                f'devices=[torch.device("cuda", 0)] * shards)')
    ctx = multiprocessing.get_context('spawn')
    tmp = Path(tempfile.mkdtemp(prefix='run_ranks_'))
    # the arguments go by file: through the start pipe, a large pickle
    # would hold each start until the rank before has imported its modules
    with open(tmp / 'args.pkl', 'wb') as f:
        pickle.dump(tuple(args), f)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world, device, f'file://{tmp / "rendezvous"}',
        str(tmp / 'args.pkl'), timeout_s, results))
        for r in range(world)]
    out = [None] * world
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        left = world
        exited = None
        while left:
            try:
                # a rank that exited may still have a message in the pipe:
                # wait a little longer for it before calling it dead
                rank, ok, payload = results.get(
                    timeout=1.0 if exited is None else 5.0)
            except queue.Empty:
                if exited is not None:
                    raise RankError(f'run_ranks: rank {exited} exited with '
                                    f'code {procs[exited].exitcode} and no '
                                    f'result') from None
                dead = [r for r, p in enumerate(procs)
                        if out[r] is None and p.exitcode is not None]
                exited = dead[0] if dead else None
                if exited is None and time.monotonic() > deadline:
                    raise RankError(f'run_ranks: {left} of {world} ranks '
                                    f'not done after {timeout_s} s') from None
                continue
            if not ok:
                raise RankError(f'run_ranks: rank {rank} raised:\n{payload}')
            out[rank] = payload
            left -= 1
            exited = None
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        return out
    finally:
        _stop(procs)
        results.close()
        results.join_thread()
        shutil.rmtree(tmp, ignore_errors=True)
