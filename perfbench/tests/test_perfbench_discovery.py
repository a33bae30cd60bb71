"""A cell, a configuration, a traffic mix and a per-layer metric added as
new files, with new entries in BENCHMARK.json, are found by name, and no
file the benchmark already has changes."""
import hashlib
import json
import shutil
import subprocess
import sys

from perfbench.harness import bench

PROBE = """
import json, sys
sys.path.insert(0, '.')
from perfbench.harness import bench
cell = bench.load_cell('serve_b2_small')
reader = bench.metric_reader('probe_ms.batch')
print(json.dumps({'config': cell['config']['name'],
                  'traffic': cell['traffic']['batch'],
                  'limits': sorted(cell['limits']),
                  'metrics': [m['name'] for m in cell['per_layer']],
                  'driver': bench.driver(cell['traffic']['driver']).__name__,
                  'read': reader.read(None, 'batch')}))
"""


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob('*')) if p.is_file()
            and '__pycache__' not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(bench.PERFBENCH, tmp_path / 'perfbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(bench.CHECKOUT / 'BENCHMARK.json', tmp_path)
    before = _digests(tmp_path / 'perfbench')
    pb = tmp_path / 'perfbench'
    config = json.loads((pb / 'configs' / 'c2m_x4_serving.json').read_text())
    config['name'] = 'c2m_x4_small'
    (pb / 'configs' / 'c2m_x4_small.json').write_text(json.dumps(config))
    traffic = json.loads((pb / 'traffic' / 'closed_b16_cufed5.json')
                         .read_text())
    traffic['batch'] = 2
    (pb / 'traffic' / 'closed_b2_small.json').write_text(json.dumps(traffic))
    (pb / 'limits' / 'serve_b2_small.json').write_text(json.dumps(
        {'out_rel': {'limit': 0.1}}))
    (pb / 'metrics' / 'probe_ms.py').write_text(
        'def read(run, variant):\n    return 1.5\n')
    data = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    data['configs'].append({'name': 'c2m_x4_small', 'source': 'x',
                            'file': 'perfbench/configs/c2m_x4_small.json',
                            'reduced': [], 'why': 'probe'})
    data['workloads'].append({'name': 'serve_b2_small',
                              'config': 'c2m_x4_small',
                              'traffic': 'closed_b2_small', 'chips': 1,
                              'why': 'probe'})
    data['per_layer'].append({'name': 'probe_ms.batch', 'unit': 'ms',
                              'better': 'lower', 'source': 'device_trace',
                              'layer': 'probe', 'moves': 'setup_s',
                              'workloads': ['serve_b2_small']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(data))
    out = subprocess.run([sys.executable, '-c', PROBE], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'config': 'c2m_x4_small', 'traffic': 2,
                   'limits': ['out_rel'], 'metrics': ['probe_ms.batch'],
                   'driver': 'perfbench.drivers.serve', 'read': 1.5}
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before
