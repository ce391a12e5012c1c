#!/usr/bin/env python3
"""The benchmark of ``climatemodel_tpu_torch`` on NVIDIA H100 cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

One run of one cell, from the root of a checkout: set-up (imports, the
card, the program's kernels, the world, the seeded inputs and a warm-up of
the cell's shapes), then whole marches back to back until ``--seconds``
have passed, then the comparison with the plain reference.  The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, and with ``--trace 1`` ``breakdown``);
the numbers compared, each beside its limit, close standard error.

Everything is found by name from ``BENCHMARK.json``: the cell's entry
names its configuration (``benchmark/configs/<config>.json``, which names
its comparison, ``benchmark/reference/<compare>.py``) and traffic
(``benchmark/traffic/<traffic>.json``, which names its driver in
``benchmark/drivers/``); ``benchmark/cells/<cell>.json`` holds the cell's
limits; each metric is read by ``benchmark/metrics/<metric>.py``.

Exit codes: 0 a result; 2 no card, or fewer than the cell asks for; 3 a
module of JAX or of the JAX package was loaded; 1 anything else.
"""
import time

T_START_EPOCH = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# one host thread for the CPU-side libraries: the marches are dispatched
# by one thread, and idle worker threads spinning beside it make the host
# clock swing (the ranks of a cell inherit this)
for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
    os.environ[var] = '1'
# build and kernel caches at fixed paths inside the checkout
os.environ['TORCH_EXTENSIONS_DIR'] = str(ROOT / 'build' / 'torch_extensions')
os.environ['TRITON_CACHE_DIR'] = str(ROOT / 'build' / 'triton')
os.environ['USE_FLAX'] = '0'
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from core import guard  # noqa: E402


def load_cell(name, root=ROOT, entry=None):
    """The cell's entry, configuration, traffic, limits and metrics.
    ``entry``: the cell's entry where ``BENCHMARK.json`` has none (a cell
    whose files wait for a later manifest).  A configuration file names
    its comparison (``compare``)."""
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in bench['workloads']}
    if entry is not None:
        cells[name] = entry
    if name not in cells:
        raise SystemExit(f'unknown workload {name!r}; choose from '
                         f'{sorted(cells)}')
    cell = cells[name]
    cfg_file = {c['name']: c
                for c in bench['configs']}[cell['config']]['file']
    config = json.loads((root / cfg_file).read_text())
    if 'compare' not in config:
        raise SystemExit(f'{cfg_file}: no "compare" key naming the '
                         f'comparison (benchmark/reference/<compare>.py)')
    here = root / 'benchmark'

    def wanted(m):
        return name in m.get('workloads', [name])
    return dict(
        cell=cell,
        config=config,
        traffic=json.loads((here / 'traffic' /
                            f"{cell['traffic']}.json").read_text()),
        spec=json.loads((here / 'cells' / f'{name}.json').read_text()),
        end_to_end=[m for m in bench['end_to_end'] if wanted(m)],
        per_layer=[m for m in bench['per_layer'] if wanted(m)])


def metric_reader(name):
    return importlib.import_module(f'metrics.{name}').read


def comparison(c):
    """The configuration's comparison: ``numbers``, ``control``,
    ``FAILED``, ``REQUIRED`` (see ``benchmark/reference/columns.py``)."""
    return importlib.import_module(f"reference.{c['config']['compare']}")


def judge(c, nums):
    """(correct, lines): each compared number beside the cell's limit."""
    from reference.compare import judge as beside_limits
    return beside_limits(nums, c['spec']['limits'])


def measure(c, seed, seconds, trace, device):
    """Set-up, the window and the comparison of one run on ``device``.
    Returns the run's record (see ``benchmark/metrics/``)."""
    driver = importlib.import_module(f"drivers.{c['traffic']['driver']}")
    run = driver.window(c, seed, seconds, trace, device, T_START_EPOCH)
    nums = comparison(c).numbers(run, c, seed, device)
    ok, lines = judge(c, nums)
    for m in run['marches']:
        m.pop('sample', None)
    run.update(correct=ok, compared=nums, lines=lines, config=c['config'],
               traffic=c['traffic'], device=device)
    return run


def result(c, run, trace):
    """The run's result line, as a dict."""
    import torch
    specs = c['per_layer'] if trace else c['end_to_end']
    metrics = {}
    for m in specs:
        v = metric_reader(m['name'])(run)
        if v is not None:
            metrics[m['name']] = {'value': v, 'unit': m['unit']}
    dev = run['device']
    out = dict(
        correct=run['correct'],
        attempted=sum(m['members'] for m in run['marches']),
        failed=run['compared'][comparison(c).FAILED], metrics=metrics,
        device=dict(platform='gpu' if dev.type == 'cuda' else dev.type,
                    kind=(torch.cuda.get_device_name(dev)
                          if dev.type == 'cuda' else 'cpu'),
                    count=int(c['cell']['chips']),
                    memory_peak_bytes=int(run['peak_bytes'])))
    trs = run['traces']
    if trace and trs:
        out['device'].update(
            busy_s=sum(t.busy_s() for t in trs) / len(trs),
            window_s=sum(t.window_s for t in trs) / len(trs))
        gaps = run['host_trace']
        out['breakdown'] = dict(
            device_ops=trs[0].top_kernels(),
            idle_gaps=gaps.idle_gaps() if gaps is not None else [])
    out['compared'] = {k: {'value': v, 'limit': c['spec']['limits'][k]}
                       for k, v in run['compared'].items()}
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    c = load_cell(args.workload)
    import torch
    torch.set_num_threads(1)
    need = int(c['cell']['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'benchmark: the cell needs {need} CUDA device(s), found {n}',
              file=sys.stderr)
        return 2
    run = measure(c, args.seed, args.seconds, args.trace,
                  torch.device('cuda', 0))
    return report(c, run, args.trace)


def report(c, run, trace):
    """Print the run's records and result; 0, or 3 where a module of JAX
    or of the JAX package was loaded here or in a rank (no result)."""
    out = result(c, run, trace)
    bad = sorted(set(guard.forbidden_loaded())
                 | set(run.get('forbidden', ())))
    if bad:
        print(f'benchmark: forbidden modules loaded: {bad}', file=sys.stderr)
        return 3
    if 'setup' in run:
        print(json.dumps({'setup': run['setup']}), file=sys.stderr)
    for m in run['marches']:
        print(json.dumps({'march': m}), file=sys.stderr)
    for line in run['lines']:
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
