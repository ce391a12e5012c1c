#!/usr/bin/env python3
"""The control of a cell: the plain reference march, put in the program's
place and computed in the precision below the configuration's (bfloat16
for float32), judged by the cell's comparison.  It has to come out as not
correct.  The benchmark's own runs do not run it.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \\
        [--dtype bfloat16] [--members N] [--device cuda]

Prints one JSON line a seed: the compared numbers, each beside its limit,
and whether the control was judged correct.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))


def control(c, seed, dtype, device, marched=None):
    """The compared numbers of the reference march in ``dtype`` over the
    cell's seeded inputs, sampled as a run samples the program's.
    ``marched``: a dict that keeps the last march by its inputs, so that
    seeds that draw the same inputs (traffic without jitter) share it."""
    import numpy as np
    import torch

    from drivers.column_sweep import SAMPLE, forcings
    from reference import compare, march, world as ref_world

    cfg, tr = c['config'], c['traffic']
    world = ref_world.grey_world(cfg)
    # the whole sweep: a cell on ranks holds ``members`` a rank
    B = int(tr['members']) * int(tr.get('ranks', 1))
    F = forcings(dict(tr, members=B), seed)
    m = cfg['march']
    marched = {} if marched is None else marched
    key = (F.tobytes(), dtype)
    if key not in marched:
        marched.clear()
        marched[key] = march.march(
            F, world, dtype=getattr(torch, dtype), device=device,
            flux_thresh=float(m['flux_thresh']),
            max_steps=int(m['max_steps']), t_end=float(m['t_end']),
            albedo=float(cfg['world'].get('albedo', .3)),
            convective_adjust=bool(m.get('convective_adjust')))
    out = marched[key]
    host = {k: v.double().cpu().numpy() if v.is_floating_point()
            else v.cpu().numpy() for k, v in out.items()}
    keep = np.unique(np.concatenate([
        np.random.default_rng([seed, 0, 1]).choice(
            len(F), min(SAMPLE, len(F)), replace=False),
        [int(host['steps'].argmax())]]))
    sample = {k: host[k][keep] for k in ('T', 'net', 'equilibrium',
                                          'failed', 'nan', 'steps')}
    sample['F'] = F[keep]
    nums = compare.numbers(sample, world, cfg, seed=seed, device=device)
    nums['unsettled'] = int((~host['equilibrium'].astype(bool)
                             | host['failed'].astype(bool)
                             | host['nan'].astype(bool)).sum())
    return nums, int(host['steps'].max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--dtype', default='bfloat16')
    ap.add_argument('--members', type=int, default=None)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    import torch

    import run
    from reference import compare
    c = run.load_cell(args.workload)
    if args.members:
        c['traffic']['members'] = args.members
    device = torch.device(args.device)
    ok_any, marched = False, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums, steps = control(c, seed, args.dtype, device, marched)
        ok, lines = compare.judge(nums, c['spec']['limits'])
        ok_any |= ok
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              dtype=args.dtype, correct=ok, steps=steps,
                              seconds=time.perf_counter() - t0,
                              compared=nums)), flush=True)
    return 1 if ok_any else 0


if __name__ == '__main__':
    sys.exit(main())
