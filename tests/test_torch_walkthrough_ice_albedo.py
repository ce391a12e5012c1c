"""Port vs JAX: the ice-albedo walkthrough (``climatemodel_tpu_torch/
examples/walkthrough_ice_albedo.py``) at the miniature configuration of
tests/test_walkthroughs.py:28-42 (nz=40, ny=16, dF=150; two hysteresis
sweeps of 23 values each), on the CPU in f64, asserting the same claims.

The sweep is marched, but what it reports is discrete: the ice-edge
latitude after each sweep point and the fluxes at which the branches flip.
Those are held equal to JAX's; the surface temperatures within 2 K (two
free-running marches of one world end 0.4-1.3 K apart, ROADMAP.md at the
end of Queue 3; measured here ~1.07 K).  Its own file: the port's host-driven
sweep takes ~80 s on one CPU thread, the longest of the example tests.
"""
import os
import sys

import numpy as np
import torch

from climatemodel_tpu_torch.examples import walkthrough_ice_albedo as p_ice

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'examples'))


def test_ice_albedo_walkthrough(tmp_path):
    import walkthrough_ice_albedo as jw
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = p_ice.run_walkthrough(nz=40, ny=16, dF=150.0, save_png=True,
                                    verbose=False, out_dir=str(tmp_path),
                                    device='cpu', dtype=torch.float64)
    finally:
        torch.set_num_threads(n)
    for tau_s, r in out.items():
        # hysteresis: deglaciation needs far more flux than ice-over
        assert r['F_degl'] is not None and r['F_snow'] is not None
        assert r['F_degl'] > r['F_snow']
    # faint young sun: more greenhouse deglaciates at lower flux
    taus = sorted(out)
    assert out[taus[1]]['F_degl'] <= out[taus[0]]['F_degl']
    assert (tmp_path / 'walkthrough_ice_albedo.png').exists()

    jout = jw.run_walkthrough(nz=40, ny=16, dF=150.0, save_png=False,
                              verbose=False)
    assert sorted(jout) == taus
    for tau_s in taus:
        r, j = out[tau_s], jout[tau_s]
        assert (r['F_snow'], r['F_degl']) == (j['F_snow'], j['F_degl'])
        np.testing.assert_array_equal(np.asarray(r['ice_lat']),
                                      np.asarray(j['ice_lat']))
        assert np.abs(np.asarray(r['T_surf'])
                      - np.asarray(j['T_surf'])).max() < 2.0
