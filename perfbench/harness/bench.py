"""One run of one cell: set-up, the measured window, the check, the line.

Everything is found by name: the cell in ``BENCHMARK.json`` at the root
of the checkout, its configuration in the file the entry names, its
traffic in ``perfbench/traffic/<traffic>.json``, whose ``driver`` names
``perfbench/drivers/<driver>.py`` (``setup``, ``window``, ``release``,
``check``, and optionally ``close``, run once the window's time and the
peak are read and before the program is freed), its limits in
``perfbench/limits/<workload>.json``, and each per-layer metric in
``perfbench/metrics/<family>.py`` (the name before the first dot), whose
``read(run, variant)`` returns the value or None when the run gave it
nothing to read.
"""
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

import torch

from . import trace
from ..reference.nets import exact_float32

PERFBENCH = Path(__file__).resolve().parent.parent
CHECKOUT = PERFBENCH.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'c2matching_tpu')


def load_benchmark(root=CHECKOUT):
    return json.loads((Path(root) / 'BENCHMARK.json').read_text())


def _read(path):
    return json.loads(Path(path).read_text())


def applies(metric, workload):
    return 'workloads' not in metric or workload in metric['workloads']


def load_cell(workload, bench=None, root=CHECKOUT):
    """The cell's entry in ``BENCHMARK.json``, its configuration, traffic,
    limits and metrics."""
    bench = bench or load_benchmark(root)
    entry = {w['name']: w for w in bench['workloads']}[workload]
    config_entry = {c['name']: c for c in bench['configs']}[entry['config']]
    limits_path = Path(root) / 'perfbench' / 'limits' / f'{workload}.json'
    return {
        'entry': entry,
        'config': _read(Path(root) / config_entry['file']),
        'traffic': _read(Path(root) / 'perfbench' / 'traffic'
                         / f'{entry["traffic"]}.json'),
        'limits': _read(limits_path) if limits_path.exists() else {},
        'end_to_end': [m for m in bench['end_to_end']
                       if applies(m, workload)],
        'per_layer': [m for m in bench['per_layer']
                      if applies(m, workload)],
    }


def driver(name):
    return importlib.import_module(f'perfbench.drivers.{name}')


def metric_reader(name):
    return importlib.import_module(
        f'perfbench.metrics.{name.split(".")[0]}')


class Run:
    """The state of one run, handed to the driver and the readers."""

    def __init__(self, cell, seed, seconds, trace_on, device, t0):
        self.cell = cell
        self.config = cell['config']
        self.traffic = cell['traffic']
        self.limits = cell['limits']
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace_on)
        self.device = torch.device(device)
        self.t0 = t0
        self.e2e = {}       # end-to-end metrics the driver measured
        self.extra = {}     # further keys for the result line
        self.timeline = None
        self.spans = None
        self.window_s = None    # the reported stretch's seconds and items
        self.items = 0
        self.plain = None       # the untraced stretch's {'items', 'seconds'}
        self.parts = {}
        self._mark = t0

    def phase(self, name):
        """Record the seconds since the last phase under ``name`` (the
        set-up's parts, for the result line)."""
        self.sync()
        now = time.perf_counter()
        self.parts[name] = now - self._mark
        self._mark = now

    def sync(self):
        trace.synchronize(self.device)

    def stretches(self):
        """The window's stretches, as (seconds, traced). A traced run
        first times half of the window without the profiler, whose host
        cost would otherwise stretch every host-bound step (a GAN step
        takes about twice as long under it), then traces the other half:
        the per-layer metrics divide by the untraced stretch's time and
        read the device from the traced one."""
        if not self.trace:
            return [(self.seconds, False)]
        return [(self.seconds / 2, False), (self.seconds / 2, True)]

    def record(self, traced, items, seconds):
        """A stretch's items (steps or batches) and host seconds: the
        untraced one is ``plain``; the traced one, or in an untraced run
        the whole window, is the reported ``window_s`` and ``items``."""
        if not traced:
            self.plain = {'items': items, 'seconds': seconds}
        if traced or not self.trace:
            self.window_s, self.items = seconds, items

    def slowdown(self):
        """A traced item's host time over an untraced one's."""
        if not (self.plain and self.plain['items'] and self.items):
            return None
        return (self.window_s / self.items) / (
            self.plain['seconds'] / self.plain['items'])

    @contextlib.contextmanager
    def traced(self, on=True):
        """A stretch of the window: under the profiler when ``on`` in a
        traced run."""
        if not (self.trace and on):
            yield
            return
        prof = trace.profiler()
        with prof:
            yield
            self.sync()
        self.prof = prof


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(workload, seed, seconds, trace_on, device='cuda', t0=None,
             cell=None):
    """Run one cell once; returns (result dict, numbers)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = cell or load_cell(workload)
    run = Run(cell, seed, seconds, trace_on, device, t0)
    drv = driver(run.traffic['driver'])
    run.phase('start_s')
    if run.device.type == 'cuda':
        from c2matching_tpu_torch.ops import _build
        _build.build(tuple(run.config['kernels']))
    run.phase('build_s')
    drv.setup(run)
    run.sync()
    setup_s = time.perf_counter() - t0
    drv.window(run)
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == 'cuda' else 0)
    if run.trace:
        run.timeline = trace.Timeline(run.prof)
        run.prof = None
    if hasattr(drv, 'close'):
        drv.close(run)
    drv.release(run)
    with exact_float32():
        numbers = drv.check(run)
    run.sync()

    metrics = {}
    if not run.trace:
        values = dict(run.e2e, setup_s=setup_s, peak_mem_gib=peak / 2 ** 30)
        for m in cell['end_to_end']:
            metrics[m['name']] = {'value': values[m['name']],
                                  'unit': m['unit']}
        # what the driver measured and this cell holds to no bound (the
        # GAN step, which spreads too widely run to run: PERF.md)
        unbound = {k: v for k, v in run.e2e.items() if k not in metrics}
        if unbound:
            run.extra['unbound'] = unbound
    else:
        for m in cell['per_layer']:
            family, _, variant = m['name'].partition('.')
            value = metric_reader(m['name']).read(run, variant)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    device_info = {'platform': 'gpu' if run.device.type == 'cuda' else 'cpu',
                   'kind': (torch.cuda.get_device_name(run.device)
                            if run.device.type == 'cuda' else 'cpu'),
                   'count': cell['entry']['chips'],
                   'memory_peak_bytes': peak}
    result = {'correct': numbers.correct() and run.failed == 0,
              'attempted': run.attempted, 'failed': run.failed,
              'metrics': metrics, 'device': device_info}
    if run.trace:
        device_info['busy_s'] = run.timeline.busy_s()
        device_info['window_s'] = run.window_s
        result['breakdown'] = run.timeline.breakdown()
        result['unlinked_device_ops'] = run.timeline.unlinked
        result['trace_slowdown'] = run.slowdown()
    result.update(run.extra)
    result['setup_parts'] = run.parts
    result['items'] = run.items
    if numbers.notes:
        result['check_notes'] = numbers.notes
    result['checks_at'] = numbers.at
    if numbers.uncompared():
        result['uncompared'] = numbers.uncompared()
    result['checks'] = numbers.table()
    return result, numbers
