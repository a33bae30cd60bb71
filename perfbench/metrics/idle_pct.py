"""Share of an item's time in which the device runs nothing, from the
profiler's timeline of the traced stretch: a served batch, or a training
step in the cells whose traffic's driver is ``train`` (whatever the
name's variant).

A step: the device's busy time a step in the traced stretch over a
step's host time in the untraced one (``bench.Run.stretches``). Under the
profiler a host-bound step takes 1.5-2 times as long, so the traced
stretch's own length would count the profiler's host cost as idle.
A batch: busy over the traced stretch's own length. A served batch is
device-bound: the profiler stretches it by about 2% (the line's
``trace_slowdown``), as much as it slows the device's operations, so
dividing by the untraced batch read a little below zero.
"""


def read(run, variant):
    busy = run.timeline.busy_s()
    if not (run.items and run.window_s and busy > 0):
        return None
    if run.traffic['driver'] != 'train':
        return 100.0 * (1.0 - busy / run.window_s)
    if not (run.plain and run.plain['items']):
        return None
    return 100.0 * (1.0 - busy / run.items * run.plain['items']
                    / run.plain['seconds'])
