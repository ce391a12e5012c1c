"""BENCHMARK.json against its character and size rules, and every cell's
files found by name."""
import importlib
import json
import re

from conftest import HERE, ROOT

BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def _metrics():
    return BENCH['end_to_end'] + BENCH['per_layer']


def test_names_and_units_use_allowed_characters():
    names = [c['name'] for c in BENCH['configs']]
    for w in BENCH['workloads']:
        names += [w['name'], w['config'], w['traffic']]
    for c in BENCH['configs']:
        names += c['reduced']
    for m in _metrics():
        names.append(m['name'])
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
    for n in names:
        assert NAME.match(n), n
    for text in ([w['why'] for w in BENCH['workloads']]
                 + [m['layer'] for m in BENCH['per_layer']]
                 + [c['source'] for c in BENCH['configs']]
                 + BENCH['command']):
        assert 1 <= len(text) <= 200 and '\n' not in text \
            and '\t' not in text, text


def test_manifest_keys_and_uniqueness():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    for group in ('configs', 'workloads'):
        names = [x['name'] for x in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m['name'] for m in _metrics()]
    assert len(names) == len(set(names))
    assert 'setup_s' in names
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))
    e2e = {m['name'] for m in BENCH['end_to_end']}
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e
    for m in BENCH['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25


def test_each_cell_finds_its_files_by_name():
    import run
    for w in BENCH['workloads']:
        c = run.load_cell(w['name'])
        importlib.import_module(f"drivers.{c['traffic']['driver']}")
        for m in c['end_to_end'] + c['per_layer']:
            assert callable(run.metric_reader(m['name']))
        comparison = run.comparison(c)
        assert set(c['spec']['limits']) >= set(comparison.REQUIRED)
        assert c['spec']['who'] and c['spec']['why'] == w['why']
    for cfg in BENCH['configs']:
        assert (ROOT / cfg['file']).is_file()
        assert cfg['file'].startswith('benchmark/')
        name = json.loads((ROOT / cfg['file']).read_text())['compare']
        comparison = importlib.import_module(f'reference.{name}')
        assert callable(comparison.numbers)
        assert callable(comparison.control)
        assert comparison.FAILED in comparison.REQUIRED


def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric():
    import run
    for w in BENCH['workloads']:
        c = run.load_cell(w['name'])
        names = {m['name'] for m in c['end_to_end']}
        assert 'setup_s' in names and len(names) >= 2
        assert c['per_layer']
