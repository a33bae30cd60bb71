"""Each cell run end to end on the CPU at a tiny size (the package's plain
kernel versions): the reference agrees with the package, and neither JAX
nor the JAX package is loaded; ``run.py`` refuses a host without a card."""
import json
import subprocess
import sys

import pytest

from perfbench.harness import bench
from perfbench.tests.tiny import tiny_cell

# at the tiny size on the CPU both sides compute in float32 (the serving
# configuration's bf16 gathers round alike on both), so each compared
# number sits far under its limit; these bounds are what such a run gives
# with room, and a broken port or reference exceeds them; the gradient
# penalty swings with rounding even between two float32 computations
TINY = {'match_gap': 1e-5, 'out_rel': 1e-4, 'feat_rel': 1e-5,
        'dynagg_rel': 1e-3, 'loss_rel': 1e-4, 'grad_rel': 1e-3,
        'change_rel': 5e-3, 'gp_rel': 1e-2}
DRY = """
import json, sys
sys.path.insert(0, '.')
from perfbench.harness import bench
from perfbench.tests.tiny import tiny_cell
workload, trace = sys.argv[1], int(sys.argv[2])
result, numbers = bench.run_cell(workload, 4294967311, 1.0, trace, 'cpu',
                                 cell=tiny_cell(workload))
print(json.dumps({'checks': numbers.table(), 'notes': numbers.notes,
                  'uncompared': numbers.uncompared(),
                  'metrics': sorted(result['metrics']),
                  'forbidden': bench.forbidden_modules(),
                  'loaded': sorted({m.split('.')[0] for m in sys.modules})}))
"""
WORKLOADS = [w['name'] for w in bench.load_benchmark()['workloads']]


def _dry(workload, trace):
    out = subprocess.run([sys.executable, '-c', DRY, workload, str(trace)],
                         cwd=bench.CHECKOUT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('workload', WORKLOADS)
def test_tiny_run_agrees_and_loads_no_jax(workload):
    got = _dry(workload, 0)
    assert got['forbidden'] == []
    assert 'c2matching_tpu_torch' in got['loaded']
    assert not {'jax', 'jaxlib', 'flax', 'c2matching_tpu'} & set(
        got['loaded'])
    assert not got['notes']
    cell = tiny_cell(workload)
    compared = {k for k, v in cell['limits'].items()
                if v.get('compared', True)}
    assert set(got['checks']) == compared
    for name, entry in got['checks'].items():
        assert entry['value'] <= TINY[name], (name, entry)
    for name, value in got['uncompared'].items():
        assert value <= TINY[name], (name, value)
    assert set(got['metrics']) == {m['name'] for m in cell['end_to_end']}


@pytest.mark.parametrize('workload,host_read', [
    ('serve_b16_cufed5', {'mfu.batch'}),
    ('train_gan_b9', {'mfu.gan', 'step_ms.gan'}),
])
def test_tiny_traced_run_reads_its_layers(workload, host_read):
    got = _dry(workload, 1)
    assert got['forbidden'] == []
    # no device on the CPU: the device metrics read nothing or zero work,
    # and the metrics taken on the host clock (the whole forward's or
    # step's share, counted from the reference; the step's time) read
    assert host_read <= set(got['metrics'])
    cell = tiny_cell(workload)
    assert set(got['metrics']) <= {m['name'] for m in cell['per_layer']}


def test_run_refuses_a_host_without_a_card():
    out = subprocess.run(
        [sys.executable, 'perfbench/run.py', '--workload',
         'serve_b16_cufed5', '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=bench.CHECKOUT, capture_output=True, text=True, timeout=300,
        env={'CUDA_VISIBLE_DEVICES': '', 'PATH': '/usr/bin:/bin'})
    assert out.returncode != 0
    assert out.stdout.strip() == ''
