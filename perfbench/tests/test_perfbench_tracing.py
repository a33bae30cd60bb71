"""The readers of the program's own spans: ``host_wait_ms``,
``dispatch_ms``, ``device_ops`` and ``d_update_ms``, and the program's
span names and ranges against the benchmark's own.

A tiny traced run of each cell on the CPU reads the host metrics from
its untraced stretch; the device metrics read nothing there. A synthetic
run shows that an operation launched from another thread (autograd's,
in a backward) inside a span's interval counts. No program span name is
one of the benchmark's, nor starts with one, so the benchmark's readers
read what they read before the program had spans; and under the CPU
profiler the program's ``c2m.generator``, ``c2m.extractor`` and
``c2m.matcher`` own the same operators as the benchmark's hook ranges
``net_g``, ``net_extractor`` and ``net_map``, which they are to take
over from."""
import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.harness import bench, program
from perfbench.metrics import d_update_ms, device_ops
from perfbench.tests.tiny import tiny_cell

# the span names of the benchmark's own hooks and ranges
# (harness/program.py, drivers/serve.py)
BENCH_SPANS = ('net_extractor', 'net_map', 'net_g', 'dynagg.', 'feed_data',
               'test', 'cropped_output', 'to_host', 'request')

DRY = """
import json, sys
sys.path.insert(0, '.')
from perfbench.harness import bench
from perfbench.tests.tiny import tiny_cell
workload = sys.argv[1]
result, numbers = bench.run_cell(workload, 4294967311, 1.0, 1, 'cpu',
                                 cell=tiny_cell(workload))
print(json.dumps({k: v['value'] for k, v in result['metrics'].items()}))
"""
CELLS = {'serve_b16_cufed5': 'batch', 'train_pretrain_b9': 'train',
         'train_gan_b9': 'gan'}


@pytest.mark.parametrize('workload', sorted(CELLS))
def test_tiny_traced_run_reads_the_host_metrics(workload):
    out = subprocess.run([sys.executable, '-c', DRY, workload],
                         cwd=bench.CHECKOUT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    v = CELLS[workload]
    assert got[f'host_wait_ms.{v}'] >= 0
    assert got[f'dispatch_ms.{v}'] > 0
    # no device on the CPU: nothing to count
    assert f'device_ops.{v}' not in got
    assert 'd_update_ms.gan' not in got


def _timeline(spans, ops):
    """A stand-in for ``trace.Timeline``: host ranges {name: [(start,
    end, thread)]} and device ops (name, start, end, launch, thread)."""
    tl = SimpleNamespace(spans=spans, ops=ops)
    tl.span_count = lambda name: len(spans.get(name, []))
    return SimpleNamespace(timeline=tl)


MAIN, AUTOGRAD = 1, 2


def test_an_op_launched_from_the_backward_thread_counts():
    run = _timeline(
        {'c2m.step': [(0, 1000, MAIN)], 'c2m.feed_data': [(0, 10, MAIN)],
         'c2m.d_update': [(100, 400, MAIN)]},
        [('d_forward', 120, 150, 110, MAIN),
         ('d_backward', 300, 380, 290, AUTOGRAD),   # autograd's thread
         ('g_backward', 600, 700, 500, AUTOGRAD),   # after the D update
         ('unlinked', 800, 900, None, None),
         ('next_step', 1200, 1300, 1100, MAIN)])
    # 30 + 80 ns of device time in one step
    assert d_update_ms.read(run, 'gan') == pytest.approx(110 / 1e6)
    # the step's ops on either thread; none after its span
    assert device_ops.read(run, 'gan') == 3


def test_no_span_reads_nothing():
    run = _timeline({}, [('k', 0, 10, 5, MAIN)])
    assert d_update_ms.read(run, 'gan') is None
    assert device_ops.read(run, 'gan') is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    import c2matching_tpu_torch.utils as utils
    from c2matching_tpu_torch.utils import trace
    from perfbench.metrics import dispatch_ms, host_wait_ms
    run = SimpleNamespace(t0=0.0, parts={}, plain={'items': 1,
                                                   'seconds': 1e9})
    trace.clear()       # records of earlier runs in this process
    trace.new_item()
    with trace.span('c2m.step'):
        pass
    assert host_wait_ms.read(run, 'gan') == 0
    # the recorder cannot be imported, as in a tree that lacks it
    monkeypatch.delattr(utils, 'trace')
    monkeypatch.setitem(sys.modules, 'c2matching_tpu_torch.utils.trace',
                        None)
    assert host_wait_ms.read(run, 'gan') is None
    assert dispatch_ms.read(run, 'gan') is None


def test_program_span_names_leave_the_benchmarks_alone():
    from c2matching_tpu_torch.utils import trace
    for name in trace.NAMES:
        for ours in BENCH_SPANS:
            assert name != ours and not name.startswith(ours), name


def _owned_ops(events, name):
    """The operator events inside the ranges called ``name`` on their
    thread, by (name, start, thread)."""
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(),
               e.start_thread_id()) for e in events if e.name() == name]
    assert ranges, name
    out = set()
    for e in events:
        if e.is_user_annotation():
            continue
        s, t = e.start_ns(), e.start_thread_id()
        if any(a <= s and s + e.duration_ns() <= b and t == tid
               for a, b, tid in ranges):
            out.add((e.name(), s, t))
    return out


def test_program_spans_own_the_hooks_operators():
    from c2matching_tpu_torch.models import RefRestorationModel
    cell = tiny_cell('serve_b16_cufed5')
    model = RefRestorationModel(program.options(cell['config'], False),
                                'cpu')
    gen = torch.Generator().manual_seed(0)
    (h, w), b = cell['traffic']['sizes'][0], cell['traffic']['batch']
    batch = {'img_in_lq': torch.rand(b, h // 4, w // 4, 3, generator=gen),
             'img_in_up': torch.rand(b, h, w, 3, generator=gen),
             'img_ref': torch.rand(b, h, w, 3, generator=gen)}

    def serve():
        model.feed_data(batch)
        model.test()
        model.cropped_output()
    hooks = program.Spans(model)
    try:
        serve()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            serve()
    finally:
        hooks.remove()
    events = list(prof.profiler.kineto_results.events())
    for ours, theirs in (('c2m.generator', 'net_g'),
                         ('c2m.extractor', 'net_extractor'),
                         ('c2m.matcher', 'net_map')):
        got = _owned_ops(events, ours)
        assert got and got == _owned_ops(events, theirs), ours
