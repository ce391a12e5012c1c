#!/usr/bin/env python3
"""The control of a cell: the plain reference, put in the program's place
and computed in the precision below the configuration's (bfloat16 for
float32), judged by the cell's limits.  It has to come out as not correct.
The configuration's comparison computes it (``control`` of
``benchmark/reference/<compare>.py``).  The benchmark's own runs do not
run it.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \\
        [--dtype bfloat16] [--members N] [--device cuda]

Prints one JSON line a seed: the compared numbers, each beside its limit,
and whether the control was judged correct; exits 1 if any seed was.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))


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
    c = run.load_cell(args.workload)
    if args.members:
        c['traffic']['members'] = args.members
    device = torch.device(args.device)
    ok_any = False
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = run.comparison(c).control(c, seed, args.dtype, device)
        ok, lines = run.judge(c, nums)
        ok_any |= ok
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              dtype=args.dtype, correct=ok,
                              seconds=time.perf_counter() - t0,
                              compared=nums)), flush=True)
    return 1 if ok_any else 0


if __name__ == '__main__':
    sys.exit(main())
