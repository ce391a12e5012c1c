"""The PyTorch port stands alone: it imports with ``jax`` blocked and never
names the JAX package."""
import pathlib
import re
import subprocess
import sys

import pytest

import climatemodel_tpu_torch

PORT = pathlib.Path(climatemodel_tpu_torch.__file__).parent
MODULES = sorted('climatemodel_tpu_torch.' + '.'.join(
    p.relative_to(PORT).with_suffix('').parts)
    for p in PORT.rglob('*.py') if p.name != '__init__.py') + [
        'climatemodel_tpu_torch.native']
#: the JAX package's example scripts, each ported under its own name
EXAMPLES = ('walkthrough_convective_adjustment', 'walkthrough_ice_albedo',
            'staged_tau_ramp', 'radiation_script', 'walkthrough_real_gas',
            'walkthrough_arctic_amplification', 'centa_presentation',
            'real_gas_script', 'shallow_script')


def test_port_imports_with_jax_blocked():
    code = ('import sys\n'
            "sys.modules['jax'] = None\n"
            "sys.modules['climatemodel_tpu'] = None\n"
            + ''.join(f'import {m}\n' for m in MODULES)
            + "assert not any(k == 'jax' or k.startswith(('jax.', "
              "'climatemodel_tpu.')) for k, v in sys.modules.items() "
              "if v is not None)\n")
    root = PORT.parent
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(MODULES) >= 15
    assert ({'climatemodel_tpu_torch.ops.convection',
            'climatemodel_tpu_torch.ops.cuda_convection',
            'climatemodel_tpu_torch.ops.stencils',
            'climatemodel_tpu_torch.ops.cuda_stencils',
            'climatemodel_tpu_torch.models.shallow_water',
            'climatemodel_tpu_torch.models.ice_albedo',
            'climatemodel_tpu_torch.models.real_gas',
            'climatemodel_tpu_torch.ops.planck',
            'climatemodel_tpu_torch.ops.transmission',
            'climatemodel_tpu_torch.spectral.bands',
            'climatemodel_tpu_torch.spectral.earth_tables',
            'climatemodel_tpu_torch.spectral.hitran',
            'climatemodel_tpu_torch.spectral.humidity',
            'climatemodel_tpu_torch.spectral.temperature_profiles',
            'climatemodel_tpu_torch.cli',
            'climatemodel_tpu_torch.__main__',
            'climatemodel_tpu_torch.diagnostics.sensitivity',
            'climatemodel_tpu_torch.diagnostics.olr',
            'climatemodel_tpu_torch.diagnostics.animation',
            'climatemodel_tpu_torch.utils.checkpoint',
            'climatemodel_tpu_torch.utils.timing',
            'climatemodel_tpu_torch.parallel.mesh',
            'climatemodel_tpu_torch.parallel.collectives',
            'climatemodel_tpu_torch.parallel.halo',
            'climatemodel_tpu_torch.parallel.level_scan',
            'climatemodel_tpu_torch.native',
            } | {f'climatemodel_tpu_torch.examples.{name}'
                 for name in EXAMPLES}) <= set(MODULES)


def test_port_never_loads_the_jax_packages_native_library():
    """The port reads the shipped spectroscopy data by path, but loads
    nothing from the JAX package's ``native/`` folder: its own native
    library is built from the port's copy of the source into
    ``build/native/`` (``tests/test_torch_native.py`` checks the loaded
    libraries of a process that uses it)."""
    from climatemodel_tpu_torch import native
    for p in PORT.rglob('*.py'):
        text = p.read_text()
        for name in ('_hitran_native', "'climatemodel_tpu' / 'native'",
                     'climatemodel_tpu/native/'):
            assert name not in text, (p, name)
    assert native.SRC.parent == PORT / 'native'
    assert native.BUILD_DIR == PORT.parent / 'build' / 'native'


def test_port_sources_never_import_jax():
    pat = re.compile(r'^\s*(import|from)\s+(jax|climatemodel_tpu)\b',
                     re.MULTILINE)
    for p in PORT.rglob('*.py'):
        assert not pat.search(p.read_text()), p


@pytest.mark.parametrize('module', ['mesh', 'collectives', 'halo',
                                    'level_scan'])
def test_parallel_module_imports_alone_with_jax_blocked(module):
    """Each ``parallel`` module on its own, in a fresh interpreter with
    ``jax`` and the JAX package blocked."""
    code = ('import sys\n'
            "sys.modules['jax'] = None\n"
            "sys.modules['climatemodel_tpu'] = None\n"
            f'import climatemodel_tpu_torch.parallel.{module}\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=PORT.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
