"""Host ms an item that the program spends blocked on the device: the
median, over the items of a traced run's untraced stretch, of the summed
time of the program's own ``c2m.wait.*`` spans (the reads of the DynAgg
offset statistics in ``cropped_output``, the copy of the gradient
penalty's coefficients, an upload from the host). An item is a served
batch or a training step; 0 where items ran and none waited.

The spans come from the program's in-memory recorder
(``c2matching_tpu_torch.utils.trace``), on ``time.perf_counter_ns``, the
clock of ``run.t0``. The untraced stretch starts where set-up ends,
``run.t0 + sum(run.parts.values())``, and lasts ``run.plain['seconds']``;
its items are those whose first span starts inside it while the profiler
is off. A program without the recorder reads nothing.
"""
import statistics
from collections import defaultdict

WAIT = 'c2m.wait.'


def recorded_spans():
    """The program's span records, or None where it keeps none."""
    try:
        from c2matching_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.records()


def plain_items(run):
    """{item id: its spans} of the untraced stretch, or None."""
    spans = recorded_spans()
    if not (spans and run.plain and run.plain['items']):
        return None
    start = round((run.t0 + sum(run.parts.values())) * 1e9)
    end = start + round(run.plain['seconds'] * 1e9)
    by_item = defaultdict(list)
    for s in spans:
        if s.item:
            by_item[s.item].append(s)
    out = {}
    for item, group in by_item.items():
        first = min(group, key=lambda s: s.start)
        if start <= first.start <= end and not first.profiled:
            out[item] = group
    return out or None


def waited_ns(spans):
    return sum(s.end - s.start for s in spans if s.name.startswith(WAIT))


def read(run, variant):
    items = plain_items(run)
    if items is None:
        return None
    return statistics.median(waited_ns(g) for g in items.values()) / 1e6
