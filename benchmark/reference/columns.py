"""The comparison of the column configurations (``grey_rce``,
``rce_conv``): a configuration file's ``"compare": "columns"`` names it.

A comparison module of ``benchmark/reference/`` gives the harness
(``benchmark/run.py``) three names:

- ``numbers(run, c, seed, device)``: the compared numbers of a run's record
  (its driver's ``window``), for the cell ``c`` (``run.load_cell``);
- ``control(c, seed, dtype, device)``: the same numbers of the control, the
  plain reference put in the program's place and computed in ``dtype``, the
  precision below the configuration's (``benchmark/control.py``);
- ``FAILED``: the number that counts the answers that failed, the result
  line's ``failed``;
- ``REQUIRED``: the numbers every cell of such a configuration must limit.

Here the answers are the members the column drivers sample from each
march (``drivers/column_sweep.record``), judged by ``compare.numbers`` in
the grey world of the configuration, and ``unsettled`` counts every member
of every march that did not settle.  The control marches the cell's whole
sweep (every rank's members) with the reference march.
"""
from __future__ import annotations

import numpy as np

from . import compare, world as ref_world

FAILED = 'unsettled'
REQUIRED = ('unsettled', 'flux_p95_gap_wm2')


def numbers(run, c, seed, device):
    marches = run['marches']
    sample = {k: np.concatenate([m['sample'][k] for m in marches])
              for k in marches[0]['sample']}
    world = ref_world.grey_world(c['config'])
    nums = compare.numbers(sample, world, c['config'], seed=seed,
                           device=device)
    nums['unsettled'] = sum(m['unsettled'] for m in marches)
    return nums


#: the last control march, by its inputs: seeds that draw the same
#: inputs (traffic without jitter) share it
_MARCHED = {}


def control(c, seed, dtype, device):
    import torch

    from drivers.column_sweep import SAMPLE, forcings
    from . import march

    cfg, tr = c['config'], c['traffic']
    world = ref_world.grey_world(cfg)
    # the whole sweep: a cell on ranks holds ``members`` a rank
    B = int(tr['members']) * int(tr.get('ranks', 1))
    F = forcings(dict(tr, members=B), seed)
    m = cfg['march']
    key = (F.tobytes(), dtype, str(device))
    if key not in _MARCHED:
        _MARCHED.clear()
        _MARCHED[key] = march.march(
            F, world, dtype=getattr(torch, dtype), device=device,
            flux_thresh=float(m['flux_thresh']),
            max_steps=int(m['max_steps']), t_end=float(m['t_end']),
            albedo=float(cfg['world'].get('albedo', .3)),
            convective_adjust=bool(m.get('convective_adjust')))
    out = _MARCHED[key]
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
    return nums
