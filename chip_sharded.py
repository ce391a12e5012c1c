#!/usr/bin/env python3
"""The sharded phases of ``chip_smoke.py`` with one shard on each card:
``sharded_sw`` (bench_sw's El Nino and wind-free worlds at 2050 x 1026 on
the fused kernel's 'given' mode, the halo rows and the collectives crossing
cards), ``sharded_2d`` and ``level_scan``, and the member- and band-sharded
compositions of ``parallel/ensemble.py`` (``dp_grey`` and ``dp_conv``: K3,
and K4 on isotonic, launched on every card, counted per card; ``rg_tp``,
``rg_dp``, ``rg_dp_tp``) and the dp x sp shallow-water ensemble
(``sw_dp_sp``), on a mesh of every CUDA device, against the unsharded runs
on the first card.  Needs exactly
``chip_smoke.SHARDS`` (4) CUDA devices and ``nvcc``; imports no JAX.

    python3 chip_sharded.py

Every phase prints one JSON line; a failed check exits 1 with
``chip_sharded: FAILED: ...`` on stderr.  The last lines are the cards'
names and power limits as nvidia-smi reports them, and ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main():
    try:
        import torch
    except ImportError:
        print('chip_sharded: PyTorch is not installed', file=sys.stderr)
        return 2
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n != cs.SHARDS:
        print(f'chip_sharded: needs {cs.SHARDS} CUDA devices, found {n}',
              file=sys.stderr)
        return 2
    if not (ROOT / 'climatemodel_tpu_torch' / 'ops' / 'csrc').is_dir():
        print('chip_sharded: the climatemodel_tpu_torch package is missing',
              file=sys.stderr)
        return 2
    from climatemodel_tpu_torch.constants import Omega, R_earth, \
        p_surface_earth
    from climatemodel_tpu_torch.models import ensemble as ens
    from climatemodel_tpu_torch.models import real_gas as prg
    from climatemodel_tpu_torch.models import shallow_water as psw
    from climatemodel_tpu_torch.models.grey import GreyGas
    from climatemodel_tpu_torch.ops import convection as pc
    from climatemodel_tpu_torch.ops import cuda_convection as ccv
    from climatemodel_tpu_torch.ops import cuda_stencils as csl
    from climatemodel_tpu_torch.ops import cuda_two_stream as cts
    from climatemodel_tpu_torch.ops import two_stream as ts
    from climatemodel_tpu_torch.parallel import ensemble as pens
    from climatemodel_tpu_torch.parallel import halo as phalo
    from climatemodel_tpu_torch.parallel import level_scan as pls
    from climatemodel_tpu_torch.parallel import mesh as pmesh
    from climatemodel_tpu_torch.spectral import earth_tables as pet
    from climatemodel_tpu_torch.spectral import hitran as ph

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    devices = pmesh.make_mesh(('x',)).flat_devices
    dev = devices[0]
    cs.emit('device', names=[torch.cuda.get_device_name(i) for i in range(n)],
            count=n, nvidia_smi=smi.splitlines(), torch=torch.__version__,
            cuda=torch.version.cuda)
    cs.build_all()
    csl.library()
    cts.library()
    ccv.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    k6 = cs.phase_sharded_sw(psw, phalo, pmesh, Omega, R_earth, csl, dev,
                             devices)
    cs.phase_sharded_2d(psw, phalo, pmesh, Omega, R_earth, csl, dev, devices)
    cs.phase_level_scan(GreyGas, p_surface_earth, pls, pmesh, ts, dev,
                        devices)
    mods = (cts, ccv)
    dp_grey = cs.phase_dp_grey(ens, pens, pmesh, GreyGas, p_surface_earth,
                               mods, cts, ts, dev, devices)
    dp_conv = cs.phase_dp_conv(ens, pens, pmesh, GreyGas, p_surface_earth,
                               mods, ccv, pc, dev, devices)
    cs.phase_rg_tables(pet, ph)
    cs.phase_rg_tp(prg, pens, pmesh, dev, devices)
    cs.phase_rg_dp(prg, ens, pens, pmesh, dev, devices)
    cs.phase_sw_dp_sp(psw, phalo, pmesh, Omega, R_earth, csl, dev, devices)
    cs.emit('sharded_launches', richtmyer_step_bc=k6,
            net_stats_walk=dp_grey['k3']
            + dp_conv['launches']['net_stats_walk'],
            iso_fit=dp_conv['launches']['iso_fit'])
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': n}}), flush=True)
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except cs.Failed as e:
        print(f'chip_sharded: FAILED: {e}', file=sys.stderr)
        sys.exit(1)
