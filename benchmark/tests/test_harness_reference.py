"""The plain reference against the program at a tiny size on the CPU."""
import numpy as np
import pytest
import torch

import run
from reference import compare, march, radiation, world as ref_world

CELLS = ['grey_rce.sweep512k', 'rce_conv.reference32k']


def _program_world(c):
    from climatemodel_tpu_torch.models.grey import GreyGas
    w = c['config']['world']
    kw = {k: v for k, v in w.items() if k != 'nz'}
    return GreyGas(nz=w['nz'], ny=1, device='cpu', dtype=torch.float64, **kw)


@pytest.mark.parametrize('cell', CELLS)
def test_world_and_fluxes_match_the_program(cell):
    from climatemodel_tpu_torch.models import ensemble
    from climatemodel_tpu_torch.models.grey import grey_net_flux
    c = run.load_cell(cell)
    ref = ref_world.grey_world(c['config'])
    prog = _program_world(c)
    assert np.array_equal(prog.p_interface[:, 0], ref.p_interface)
    assert np.array_equal(prog.dtau[:, 0], ref.dtau)
    F = np.linspace(*c['traffic']['F_range'], 5)
    _, fo, _, _ = ensemble.grey_ensemble(prog, F)
    T = torch.as_tensor(np.random.default_rng(0).uniform(
        180, 320, (5, ref.n)))
    want = grey_net_flux(T[:, :, None], fo)[:, :, 0]
    got = radiation.net_flux(T, torch.as_tensor(F), ref)
    assert torch.allclose(got, want, rtol=0, atol=1e-9)


def test_exact_equilibrium_has_no_net_flux():
    c = run.load_cell('grey_rce.sweep512k')
    ref = ref_world.grey_world(c['config'])
    F = torch.linspace(800, 1600, 7, dtype=torch.float64)
    T = radiation.radiative_equilibrium(F, ref)
    assert radiation.net_flux(T, F, ref).abs().max() < 1e-9


@pytest.mark.parametrize('cell', CELLS)
def test_reference_march_passes_its_own_comparison(cell):
    """The f64 reference march put in the program's place is correct;
    it lands as far from the exact equilibrium as the program does."""
    c = run.load_cell(cell)
    cfg = c['config']
    ref = ref_world.grey_world(cfg)
    F = np.linspace(*c['traffic']['F_range'], 6)
    m = cfg['march']
    out = march.march(F, ref, dtype=torch.float64, device='cpu',
                      flux_thresh=m['flux_thresh'], max_steps=m['max_steps'],
                      convective_adjust=m['convective_adjust'])
    host = {k: v.numpy() for k, v in out.items()}
    host['F'] = F
    nums = compare.numbers(host, ref, cfg)
    ok, lines = compare.judge(nums, c['spec']['limits'])
    assert ok, lines
