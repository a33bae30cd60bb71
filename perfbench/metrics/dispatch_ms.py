"""The host's own ms an item: the median, over the items of a traced
run's untraced stretch (``host_wait_ms.plain_items``), of the time of the
item's entry-point spans (``c2m.feed_data``, ``c2m.test`` and
``c2m.cropped_output`` of a served batch; ``c2m.feed_data`` and
``c2m.step`` of a training step) less its ``c2m.wait.*`` spans: what the
host takes to issue the item's work, the time it blocks on the device
left out. A program without the recorder reads nothing.
"""
import statistics

from perfbench.metrics.host_wait_ms import plain_items, waited_ns

ENTRY_POINTS = ('c2m.feed_data', 'c2m.test', 'c2m.cropped_output',
                'c2m.step')


def read(run, variant):
    items = plain_items(run)
    if items is None:
        return None
    own = [sum(s.end - s.start for s in g if s.name in ENTRY_POINTS)
           - waited_ns(g) for g in items.values()]
    return statistics.median(own) / 1e6
