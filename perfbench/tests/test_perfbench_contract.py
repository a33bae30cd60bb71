"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file of its own."""
import json
import re

import pytest

from perfbench.harness import bench

BENCH = bench.load_benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}
E2E_KEYS = {'name', 'unit', 'better', 'bound', 'source'}
LAYER_KEYS = {'name', 'unit', 'better', 'source', 'layer', 'moves'}
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


def _line(text):
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level():
    assert set(BENCH) == KEYS
    assert len((bench.CHECKOUT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH['paths']) <= 16
    for p in BENCH['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
    assert len(BENCH['command']) <= 32
    assert all(_line(w) for w in BENCH['command'])
    assert isinstance(BENCH['run_seconds'], int)
    assert 1 <= BENCH['run_seconds'] <= 51


def test_names_units_and_keys():
    names = []
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and _line(c['source'])
        assert _line(c['why']) and len(c['reduced']) <= 16
        assert all(NAME.match(k) for k in c['reduced'])
        assert any(c['file'].startswith(p + '/') for p in BENCH['paths'])
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert w['chips'] in (1, 4) and _line(w['why'])
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == E2E_KEYS
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0 < m['bound'] <= 0.25 and m['bound'] >= 0.01
    for m in BENCH['per_layer']:
        assert set(m) - {'workloads'} == LAYER_KEYS
        assert m['source'] in SOURCES and _line(m['layer'])
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
        names.append(m['name'])
    for group in (names, [c['name'] for c in BENCH['configs']],
                  [w['name'] for w in BENCH['workloads']]):
        assert len(group) == len(set(group))
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))
    assert 'setup_s' in names


def test_bounds_and_roofline_names():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert e2e['setup_s']['bound'] <= 0.25
    for m in BENCH['per_layer']:
        if 'roofline' in m['name'] or 'mfu' in m['name']:
            assert m['unit'] == '%'


@pytest.mark.parametrize('workload', [w['name'] for w in BENCH['workloads']])
def test_each_cell_reports_what_it_must(workload):
    cell = bench.load_cell(workload)
    e2e = {m['name'] for m in cell['end_to_end']}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert cell['per_layer'], 'every cell reports a per-layer metric'
    for m in cell['per_layer']:
        # each metric's `moves` is reported by every cell that reports it
        assert m['moves'] in e2e, (m['name'], workload)


def test_every_config_is_used_and_its_own_file():
    used = {w['config'] for w in BENCH['workloads']}
    assert used == {c['name'] for c in BENCH['configs']}
    files = [c['file'] for c in BENCH['configs']]
    assert len(files) == len(set(files))
    for c in BENCH['configs']:
        data = json.loads((bench.CHECKOUT / c['file']).read_text())
        assert data['name'] == c['name']
        assert data['reduced'] == c['reduced']


@pytest.mark.parametrize('workload', [w['name'] for w in BENCH['workloads']])
def test_cell_files_found_by_name(workload):
    cell = bench.load_cell(workload)
    assert cell['limits'], f'perfbench/limits/{workload}.json'
    for name, entry in cell['limits'].items():
        if entry.get('compared', True):
            # a limit lies between the program's and the control's (or a
            # fault's) readings
            assert entry['lower'] < entry['limit'] < entry['upper'], name
        else:
            assert 'limit' not in entry, name
    drv = bench.driver(cell['traffic']['driver'])
    for fn in ('setup', 'window', 'release', 'check', 'judge'):
        assert callable(getattr(drv, fn))
    for m in cell['per_layer']:
        assert callable(bench.metric_reader(m['name']).read)
