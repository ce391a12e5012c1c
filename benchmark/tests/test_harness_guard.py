"""No module a run loads is JAX's or the JAX package's, compared by whole
top-level names; the reference loads nothing of the program."""
import subprocess
import sys

from conftest import HERE, ROOT
from core.guard import forbidden_loaded


def test_names_compare_whole():
    assert forbidden_loaded(['climatemodel_tpu_torch.models.column',
                             'climatemodel_tpu_torchx', 'jaxtyping']) == []
    assert forbidden_loaded(['climatemodel_tpu.ops', 'jax.numpy', 'jaxlib',
                             'flax.linen']) == ['climatemodel_tpu', 'flax',
                                                'jax', 'jaxlib']


def _loaded(code):
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={'PATH': '/usr/bin:/bin', 'PYTHONPATH': ''})
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_a_run_loads_nothing_forbidden():
    mods = _loaded(
        f'import sys; sys.argv = ["run"]; sys.path.insert(0, "{HERE}")\n'
        'import run, control, torch\n'
        'from core import trace, yardstick\n'
        'from drivers import column_sweep\n'
        'from climatemodel_tpu_torch.models import ensemble, grey\n'
        'from climatemodel_tpu_torch.ops import cuda_two_stream, '
        'cuda_convection\n'
        'import json\n'
        'for m in json.load(open("BENCHMARK.json"))["end_to_end"] + '
        'json.load(open("BENCHMARK.json"))["per_layer"]:\n'
        '    run.metric_reader(m["name"])\n'
        'from core.guard import forbidden_loaded\n'
        'print(*forbidden_loaded(), "END")')
    assert mods == ['END']


def test_reference_loads_nothing_of_the_program():
    mods = _loaded(
        f'import sys; sys.path.insert(0, "{HERE}")\n'
        'from reference import compare, convection, march, radiation, world\n'
        'print(*sorted({m.split(".")[0] for m in sys.modules '
        'if m.startswith("climatemodel")}), "END")')
    assert mods == ['END']
