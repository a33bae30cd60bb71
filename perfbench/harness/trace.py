"""The device timeline of a traced window, from ``torch.profiler``.

Kept in memory, never written to disk. Each device operation (kernel,
copy, fill) has its device interval and the host time and thread of the
CPU operation that launched it (the profiler's link from a device event
to its launching op); a host range (a ``record_function`` span placed by
the benchmark, or an operator such as ``c2matching::match_argmax``)
owns the device operations launched inside it on its thread.
"""
import bisect
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

DEVICE_TYPES = ('CUDA',)


def profiler():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Timeline:
    """Device operations and host ranges of one traced window, times in
    ns on the profiler's clock."""

    def __init__(self, prof):
        host, device = [], []
        for e in prof.profiler.kineto_results.events():
            kind = str(e.device_type()).split('.')[-1]
            start, dur = e.start_ns(), e.duration_ns()
            if kind in DEVICE_TYPES:
                if e.is_user_annotation():
                    continue
                device.append((e.name(), start, start + dur,
                               e.linked_correlation_id()))
            else:
                host.append((e.name(), start, start + dur,
                             e.correlation_id(), e.start_thread_id()))
        by_corr = {h[3]: h for h in host if h[3]}
        self.ops = []
        self.unlinked = 0
        for name, s, e, link in device:
            parent = by_corr.get(link)
            if parent is None:
                self.unlinked += 1
                self.ops.append((name, s, e, None, None))
            else:
                self.ops.append((name, s, e, parent[1], parent[4]))
        self.ops.sort(key=lambda o: o[1])
        self.host = host
        self.spans = defaultdict(list)
        for name, s, e, _, tid in host:
            self.spans[name].append((s, e, tid))
        self.busy = _merge([(o[1], o[2]) for o in self.ops])

    def busy_s(self):
        return sum(e - s for s, e in self.busy) / 1e9

    def ops_in(self, span, names=None):
        """Device operations launched inside the host ranges called
        ``span`` (or whose name ``span(name)`` accepts), on their threads,
        optionally only those whose name contains one of ``names``."""
        if callable(span):
            ranges = [r for n, rs in self.spans.items() if span(n)
                      for r in rs]
        else:
            ranges = self.spans.get(span, [])
        if not ranges:
            return []
        by_tid = defaultdict(list)
        for s, e, tid in ranges:
            by_tid[tid].append((s, e))
        starts = {t: sorted(r) for t, r in by_tid.items()}
        out = []
        for op in self.ops:
            launch, tid = op[3], op[4]
            if launch is None or tid not in starts:
                continue
            r = starts[tid]
            i = bisect.bisect_right(r, (launch, float('inf'))) - 1
            if i >= 0 and r[i][0] <= launch <= r[i][1]:
                if names is None or any(n in op[0] for n in names):
                    out.append(op)
        return out

    def device_s_in(self, span, names=None):
        """Summed device seconds of the operations launched in ``span``."""
        return sum(o[2] - o[1] for o in self.ops_in(span, names)) / 1e9

    def span_count(self, span):
        return len(self.spans.get(span, []))

    def breakdown(self, top=10):
        """{'device_ops': the operations that took the most device time,
        summed by name; 'idle_gaps': the device's idle time summed by the
        innermost host range open at each gap's start}, each a list of
        [name, seconds] of at most ``top``."""
        by_name = defaultdict(int)
        for name, s, e, _, _ in self.ops:
            by_name[name[:160]] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = defaultdict(int)
        host = sorted((h[1], h[2], h[0]) for h in self.host
                      if not h[0].startswith(('cuda', 'cu')))
        starts = [h[0] for h in host]
        for (_, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            i = bisect.bisect_right(starts, e0) - 1
            label = 'host (no range open)'
            depth = -1
            # the innermost range open at the gap's start: latest start
            # among those still open, looking back a bounded way
            for j in range(i, max(-1, i - 200), -1):
                hs, he, hn = host[j]
                if he >= e0 and hs > depth:
                    label, depth = hn, hs
                    break
            gaps[label[:160]] += s1 - e0
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {'device_ops': [[n, v / 1e9] for n, v in ops],
                'idle_gaps': [[n, v / 1e9] for n, v in idle]}


def synchronize(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
