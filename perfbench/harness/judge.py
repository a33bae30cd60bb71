"""The numbers that decide ``correct``, each against its limit.

A cell's limits are data, ``perfbench/limits/<workload>.json``: for each
number its limit and the readings it was set from (the program's largest
over sound seeds, the control's or a fault's smallest). A number whose
entry says ``"compared": false`` is read and reported but decides
nothing: no limit can separate its two readings (``PERF.md`` gives them).
Every number is a worst case over what the run compared, so larger is
worse.
"""
import torch


def rel_max(prog, ref):
    """max |prog - ref| over max |ref|."""
    prog, ref = prog.double(), ref.double()
    return float((prog - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _net(name):
    return name.split('.')[0]


def _medians(norms):
    """The median leaf norm of each net (the name before the first dot):
    G's and D's gradients differ by orders of magnitude."""
    by_net = {}
    for k, v in norms.items():
        by_net.setdefault(_net(k), []).append(v)
    return {n: float(torch.tensor(v, dtype=torch.float64).median())
            for n, v in by_net.items()}


def worst_leaf(prog_norms, ref_norms, names):
    """(the largest |prog norm - ref norm| over the ``names`` leaves, each
    against the larger of its reference norm and the median leaf's of its
    net; that leaf)."""
    medians = _medians(ref_norms)
    worst, at = 0.0, None
    for k in names:
        scale = max(ref_norms[k], medians[_net(k)], 1e-30)
        gap = abs(prog_norms[k] - ref_norms[k]) / scale
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def moved_leaves(ref_grads, rule=1e-3):
    """The leaves whose reference gradient norm is at least ``rule`` times
    the median leaf's of their net: the others move under Adam by
    round-off alone."""
    norms = {k: float(v.double().norm()) for k, v in ref_grads.items()}
    medians = _medians(norms)
    return [k for k, v in norms.items() if v >= rule * medians[_net(k)]]


class Numbers:
    """The compared numbers of a run, by name, and their verdict."""

    def __init__(self, limits):
        self.limits = limits
        self.values = {}
        self.at = {}
        self.notes = []
        self.detail = {}    # every reading by where, for calibration

    def put(self, name, value, at=None):
        """Keep the worst ``value`` of ``name``; ``at`` says where it was
        read (a loss's name, a leaf, a request)."""
        value = float(value)
        if at is not None:
            self.detail[f'{name} {at}'] = value
        if name not in self.values or value > self.values[name]:
            self.values[name] = value
            if at is not None:
                self.at[name] = at

    def compared(self, name):
        return self.limits.get(name, {}).get('compared', True)

    def correct(self):
        if not self.values:
            return False
        for name, value in self.values.items():
            limit = self.limits.get(name, {}).get('limit')
            if self.compared(name) and (limit is None or not value <= limit):
                return False
        return True

    def table(self):
        """The compared numbers, each with its limit."""
        return {name: {'value': value,
                       'limit': self.limits.get(name, {}).get('limit')}
                for name, value in self.values.items()
                if self.compared(name)}

    def uncompared(self):
        return {name: value for name, value in self.values.items()
                if not self.compared(name)}

    def lines(self):
        return [f'check {n}: {v["value"]!r} limit {v["limit"]!r}'
                for n, v in self.table().items()]
