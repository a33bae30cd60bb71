"""Device operations (kernels, copies, fills) an item launches: those
launched inside the program's entry-point spans (``c2m.feed_data``,
``c2m.test`` and ``c2m.cropped_output`` of a served batch;
``c2m.feed_data`` and ``c2m.step`` of a training step) in the traced
stretch, over its items (its ``c2m.feed_data`` spans).

The program mirrors each span as a ``record_function`` range while the
profiler is on, so the spans lie on the device trace's clock. An
operation belongs to a span when the host call that launched it started
inside the span's interval, on any thread: a backward's kernels are
launched from autograd's own thread, not from the thread that holds the
span. None where the trace holds no such span or no operation in it.
"""
import bisect

ENTRY_POINTS = ('c2m.feed_data', 'c2m.test', 'c2m.cropped_output',
                'c2m.step')
ITEM = 'c2m.feed_data'


def launched_in(timeline, names):
    """The device operations of ``timeline`` whose launch lies inside a
    host range named in ``names``, on any thread."""
    ranges = []
    for s, e in sorted((s, e) for n in names
                       for s, e, _ in timeline.spans.get(n, [])):
        if ranges and s <= ranges[-1][1]:
            ranges[-1][1] = max(ranges[-1][1], e)
        else:
            ranges.append([s, e])
    starts = [r[0] for r in ranges]
    out = []
    for op in timeline.ops:
        launch = op[3]
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch <= ranges[i][1]:
            out.append(op)
    return out


def read(run, variant):
    items = run.timeline.span_count(ITEM)
    ops = launched_in(run.timeline, ENTRY_POINTS)
    if not (items and ops):
        return None
    return len(ops) / items
