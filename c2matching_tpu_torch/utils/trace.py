"""Spans of the port's own phases, kept in memory.

A span is the host time of one phase of a request or a training step,
opened where the work happens::

    from c2matching_tpu_torch.utils import trace

    with trace.span('c2m.test'):
        ...

Each span records its name, its id, its parent span's id (0 at the top),
the item it belongs to, its start and end on ``time.perf_counter_ns()``
and whether the autograd profiler was on when it opened (``profiled``).
An item is one request (``feed_data`` -> ``test`` -> ``cropped_output``)
or one training step (``feed_data`` -> ``optimize_parameters``):
``new_item()``, called by ``feed_data``, starts the next, and every span
until the next call carries its id.

Spans nest in the order they open, on whichever thread: the program opens
them from one thread at a time, and a span that autograd's thread opens
while the step waits in ``backward()`` (the DynAggs of a checkpointed G
forward, recomputed) nests under the span the step has open there,
``c2m.g_backward``.

Records live in a bounded ring (``CAPACITY``): the oldest go first, and
nothing is written to a file. ``records()`` returns them. The recorder is
on by default; ``enable(False)`` turns it off, after which a span costs
one flag check and leaves no record, which is how the recorder's own cost
is measured (PERF.md).

While the autograd profiler is on (``torch.profiler`` or
``logger.trace_dir``), every span also opens a ``record_function`` range
of its own name, so the phases show in the trace on the profiler's own
clock.

Names: every span the package opens starts with ``c2m.`` and is listed in
``NAMES``; a host wait, a point where the host blocks on the device, is a
``c2m.wait.<what>`` span.
"""
import collections
import contextlib
import itertools
import time

import torch

CAPACITY = 65536

# the request's and the step's entry points, then their phases
NAMES = (
    'c2m.feed_data', 'c2m.test', 'c2m.cropped_output', 'c2m.step',
    'c2m.extractor', 'c2m.matcher', 'c2m.generator',
    'c2m.dynagg.relu3_1', 'c2m.dynagg.relu2_1', 'c2m.dynagg.relu1_1',
    'c2m.match', 'c2m.g_forward', 'c2m.d_update', 'c2m.d_adam',
    'c2m.g_losses', 'c2m.g_backward', 'c2m.g_adam',
    'c2m.wait.upload', 'c2m.wait.offset_stats', 'c2m.wait.gp_alpha',
)

Span = collections.namedtuple(
    'Span', 'name id parent item start end profiled')


class _Open:
    """A span while it is open."""

    __slots__ = ('rec', 'name', 'id', 'parent', 'item', 'start', 'profiled',
                 'range')

    def __init__(self, rec, name):
        self.rec = rec
        self.name = name

    def __enter__(self):
        rec = self.rec
        stack = rec._stack
        self.parent = stack[-1] if stack else 0
        self.id = next(rec._ids)
        self.item = rec._item
        stack.append(self.id)
        self.profiled = torch.autograd._profiler_enabled()
        self.start = time.perf_counter_ns()
        if self.profiled:
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.profiled:
            self.range.__exit__(*exc)
        end = time.perf_counter_ns()
        self.rec._stack.pop()
        # a plain tuple: records() makes each a Span
        self.rec._ring.append((self.name, self.id, self.parent, self.item,
                               self.start, end, self.profiled))
        return False


class Recorder:
    """Spans in a bounded ring of ``CAPACITY`` records."""

    def __init__(self):
        self._ring = collections.deque(maxlen=CAPACITY)
        self._ids = itertools.count(1)
        self._stack = []        # the ids of the open spans
        self._item = 0
        self._on = True
        self._null = contextlib.nullcontext()

    def span(self, name):
        """A context manager that records the host time of ``name``."""
        if not self._on:
            return self._null
        return _Open(self, name)

    def new_item(self):
        """Start the next item (a request or a step); returns its id (0
        while the recorder is off)."""
        if not self._on:
            return 0
        self._item = next(self._ids)
        return self._item

    def records(self):
        """The ring's spans, in the order they closed (a parent after its
        children)."""
        return [Span._make(r) for r in self._ring]

    def clear(self):
        self._ring.clear()
        self._item = 0

    def enable(self, on=True):
        """Turn the recorder on or off (off, to measure what it costs)."""
        self._on = bool(on)


# the package's recorder
recorder = Recorder()
span = recorder.span
new_item = recorder.new_item
records = recorder.records
clear = recorder.clear
enable = recorder.enable
