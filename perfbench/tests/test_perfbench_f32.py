"""The published f32 evaluation cell, ``serve_b16_f32``: its configuration
stays in float32, a tiny traced run reads its layers, the faults of the
serving driver are caught in it, and ``b1_scratch_gib`` reads the
program's counter, or nothing in a program without it."""
import importlib
import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from c2matching_tpu_torch.utils.options import load
from perfbench.harness import bench, faults
from perfbench.metrics import b1_scratch_gib
from perfbench.tests.test_perfbench_dryrun import DRY
from perfbench.tests.tiny import tiny_cell

WORKLOAD = 'serve_b16_f32'
SEED = 2 ** 31 + 7


def test_the_configuration_stays_float32():
    cell = bench.load_cell(WORKLOAD)
    cfg = cell['config']
    assert cfg['name'] == 'c2m_x4_f32'
    assert set(cfg['reference_precision'].values()) == {'float32'}
    # the nets as the benchmark builds them are those of the options file
    # the configuration names, which sets no lower precision
    opts = load(bench.CHECKOUT / cfg['options_file'])
    for key in ('network_g', 'network_map', 'network_extractor'):
        assert not {'match_dtype', 'gather_dtype'} & set(opts[key]), key
        assert opts[key] == cfg[key], key
    # the cell serves the bf16 cell's requests
    assert cell['entry']['traffic'] == bench.load_cell(
        'serve_b16_cufed5')['entry']['traffic']


def test_tiny_traced_run_reads_its_layers():
    out = subprocess.run([sys.executable, '-c', DRY, WORKLOAD, '1'],
                         cwd=bench.CHECKOUT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got['forbidden'] == []
    # no device on the CPU: the device metrics and B1's scratch (no
    # kernel launched) read nothing; the whole forward's share reads
    assert 'mfu.f32' in got['metrics']
    assert 'b1_scratch_gib.f32' not in got['metrics']
    cell = tiny_cell(WORKLOAD)
    assert set(got['metrics']) <= {m['name'] for m in cell['per_layer']}


def _run():
    return bench.run_cell(WORKLOAD, SEED, 1.0, 0, 'cpu',
                          cell=tiny_cell(WORKLOAD))


def test_unbroken_run_is_correct():
    result, numbers = _run()
    assert result['correct'], numbers.table()


@pytest.mark.parametrize('fault', ['answer_altered', 'half_batch'])
def test_fault_is_caught(fault):
    with faults.planted(fault):
        result, numbers = _run()
    assert not result['correct'], numbers.table()


def test_scratch_reader(monkeypatch):
    kernel = importlib.import_module(
        'c2matching_tpu_torch.ops.patch_match_kernel')
    run = SimpleNamespace()
    monkeypatch.setattr(kernel.match_argmax, 'launches', 3)
    monkeypatch.setattr(kernel.match_argmax, 'scratch_bytes', 6_539_968_512)
    assert b1_scratch_gib.read(run, 'f32') == pytest.approx(6.0908, abs=1e-4)
    # no kernel launched (a run on the CPU)
    monkeypatch.setattr(kernel.match_argmax, 'launches', 0)
    assert b1_scratch_gib.read(run, 'f32') is None
    # a program without the counter, as the tree before it
    monkeypatch.setattr(kernel.match_argmax, 'launches', 3)
    monkeypatch.delattr(kernel.match_argmax, 'scratch_bytes')
    assert b1_scratch_gib.read(run, 'f32') is None
