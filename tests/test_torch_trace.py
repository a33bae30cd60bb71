"""The port's span recorder (``utils/trace.py``) and the spans the model
opens at its entry points, its phases and its host waits.

On the CPU: nesting and parent ids, one item id a request or step, the
ring's bound, ``enable(False)``, the names, a checkpointed forward's
recompute nested under the backward, and the mirrored ``record_function``
ranges against the ring: on the profiler's clock and in their nesting. On
a CUDA card (marker ``card``: ``python -m pytest --noconftest
tests/test_torch_trace.py -m card``): every host sync of the entry points
lies inside a ``c2m.wait.*`` span.

The models are built from the repository's own options files: the
serving options (``test_C2_matching_serving.yml``) and the stage-3 GAN
options (``stage3_restoration_gan.yml``), at their widths on the card
and cut to ngf 16, 2 blocks a scale and ndf 4 on the CPU.
"""
import copy
import re
import statistics
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from c2matching_tpu_torch.models import RefRestorationModel
from c2matching_tpu_torch.utils import options, trace

PACKAGE = Path(trace.__file__).resolve().parents[1]
REPO = PACKAGE.parent
SERVING = REPO / 'options' / 'test' / 'test_C2_matching_serving.yml'
GAN = REPO / 'options' / 'train' / 'stage3_restoration_gan.yml'
# requests (HR height, width, batch) and training batches (gt, batch)
TINY = {'serve': (64, 48, 2), 'train': (64, 3)}
FULL = {'serve': (512, 336, 2), 'train': (160, 2)}


@pytest.fixture
def recorder():
    """The package's recorder, emptied and on, left on."""
    trace.enable(True)
    trace.clear()
    yield trace
    trace.enable(True)
    trace.clear()


def _model_opt(train, tiny=True, **train_opt):
    """The model's options from the serving or the stage-3 GAN file."""
    opt = options.load(GAN if train else SERVING)
    out = {k: copy.deepcopy(opt[k]) for k in
           ('network_g', 'network_map', 'network_extractor')}
    out.update(manual_seed=0, crop_border=None, is_train=train)
    if train:
        out['network_d'] = copy.deepcopy(opt['network_d'])
        out['train'] = dict(copy.deepcopy(opt['train']), **train_opt)
    if tiny:
        out['network_g'].update(ngf=16, n_blocks=2)
        if train:
            out['network_d']['ndf'] = 4
    return out


def _tiny_model(train=False, **train_opt):
    return RefRestorationModel(_model_opt(train, **train_opt), 'cpu')


def _first_gan_step(model):
    return model.net_g_pretrain_steps + 1


def _serving_batch(sizes, seed=0):
    gen = torch.Generator().manual_seed(seed)
    h, w, b = sizes
    return {'img_in_lq': torch.rand(b, h // 4, w // 4, 3, generator=gen),
            'img_in_up': torch.rand(b, h, w, 3, generator=gen),
            'img_ref': torch.rand(b, h, w, 3, generator=gen)}


def _training_batch(sizes, seed=0):
    gen = torch.Generator().manual_seed(seed)
    s, b = sizes
    return {'img_in_lq': torch.rand(b, s // 4, s // 4, 3, generator=gen),
            'img_in_up': torch.rand(b, s, s, 3, generator=gen),
            'img_ref': torch.rand(b, s, s, 3, generator=gen),
            'img_in': torch.rand(b, s, s, 3, generator=gen)}


def _serve(model, batch):
    model.feed_data(batch)
    model.test()
    return model.cropped_output()


@pytest.fixture(scope='module')
def served():
    """Two requests through a tiny serving model, and the records."""
    trace.enable(True)
    trace.clear()
    model = _tiny_model()
    for seed in range(2):
        _serve(model, _serving_batch(TINY['serve'], seed))
    recs = trace.records()
    trace.clear()
    return recs


@pytest.fixture(scope='module')
def stepped():
    """A tiny model's G-pretrain step and GAN step, and the records."""
    trace.enable(True)
    trace.clear()
    model = _tiny_model(train=True)
    model.feed_data(_training_batch(TINY['train']))
    model.optimize_parameters(1)
    model.feed_data(_training_batch(TINY['train'], 1))
    model.optimize_parameters(_first_gan_step(model))
    recs = trace.records()
    trace.clear()
    return recs


def _by_id(recs):
    return {r.id: r for r in recs}


def _path(recs, rec):
    """The names from ``rec`` up to its outermost span."""
    ids = _by_id(recs)
    out = [rec.name]
    while rec.parent:
        rec = ids[rec.parent]
        out.append(rec.name)
    return out


def _open_on_a_thread(rec, name):
    """Open and close ``name`` on a thread of its own, as autograd's
    device thread does in a backward, and wait for it."""
    def run():
        with rec.span(name):
            pass
    t = threading.Thread(target=run)
    t.start()
    t.join()


def test_parent_ids_follow_the_nesting(recorder):
    rec = trace.Recorder()
    with rec.span('c2m.step'):
        with rec.span('c2m.match'):
            pass
        with rec.span('c2m.d_update'):
            with rec.span('c2m.d_adam'):
                pass
        with rec.span('c2m.g_backward'):
            _open_on_a_thread(rec, 'c2m.dynagg.relu1_1')
    got = {r.name: r for r in rec.records()}
    assert got['c2m.step'].parent == 0
    assert got['c2m.match'].parent == got['c2m.step'].id
    assert got['c2m.d_update'].parent == got['c2m.step'].id
    assert got['c2m.d_adam'].parent == got['c2m.d_update'].id
    assert got['c2m.dynagg.relu1_1'].parent == got['c2m.g_backward'].id
    for r in got.values():
        assert r.start <= r.end and not r.profiled
    outer = got['c2m.step']
    for name in ('c2m.match', 'c2m.d_update', 'c2m.d_adam',
                 'c2m.dynagg.relu1_1'):
        assert outer.start <= got[name].start <= got[name].end <= outer.end


def test_served_spans_nest_as_the_request_runs(served):
    tops = {r.name for r in served if r.parent == 0}
    assert tops == {'c2m.feed_data', 'c2m.test', 'c2m.cropped_output'}
    paths = {tuple(_path(served, r)) for r in served}
    assert ('c2m.extractor', 'c2m.test') in paths
    assert ('c2m.matcher', 'c2m.test') in paths
    for key in ('relu3_1', 'relu2_1', 'relu1_1'):
        assert (f'c2m.dynagg.{key}', 'c2m.generator', 'c2m.test') in paths
    # inputs already on the model's device: no upload to wait for
    assert not any(r.name == 'c2m.wait.upload' for r in served)


def test_one_item_id_a_request_and_a_new_one_each_feed(served):
    items = {}
    for r in served:
        items.setdefault(r.item, set()).add(r.name)
    assert len(items) == 2 and 0 not in items
    for names in items.values():
        assert {'c2m.feed_data', 'c2m.test',
                'c2m.cropped_output'} <= names


def test_wait_spans_at_the_host_syncs(served, stepped):
    waits = [r for r in served if r.name == 'c2m.wait.offset_stats']
    assert len(waits) == 2
    for w in waits:
        assert _path(served, w) == ['c2m.wait.offset_stats',
                                    'c2m.cropped_output']
    gp = [r for r in stepped if r.name == 'c2m.wait.gp_alpha']
    assert len(gp) == 1
    assert _path(stepped, gp[0]) == ['c2m.wait.gp_alpha', 'c2m.d_update',
                                     'c2m.step']


def test_step_phases(stepped):
    steps = {}
    for r in stepped:
        steps.setdefault(r.item, []).append(r)
    pretrain, gan = (steps[k] for k in sorted(steps))
    phases = ['c2m.match', 'c2m.g_forward', 'c2m.g_losses', 'c2m.g_backward',
              'c2m.g_adam']
    ids = _by_id(stepped)

    def children(recs):
        return [r.name for r in sorted(recs, key=lambda r: r.start)
                if r.parent and ids[r.parent].name == 'c2m.step']
    assert children(pretrain) == phases
    assert children(gan) == phases[:2] + ['c2m.d_update'] + phases[2:]
    adam = [r for r in gan if r.name == 'c2m.d_adam']
    assert len(adam) == 1 and ids[adam[0].parent].name == 'c2m.d_update'
    for recs in (pretrain, gan):
        top = {r.name for r in recs if r.parent == 0}
        assert top == {'c2m.feed_data', 'c2m.step'}


def test_ring_is_bounded(recorder, monkeypatch):
    assert trace.CAPACITY >= 65536
    monkeypatch.setattr(trace, 'CAPACITY', 8)
    rec = trace.Recorder()
    for i in range(20):
        with rec.span('c2m.test'):
            pass
    recs = rec.records()
    assert len(recs) == 8
    assert [r.id for r in recs] == list(range(13, 21))


def test_disabled_recorder_leaves_no_records(recorder):
    model = _tiny_model()
    trace.enable(False)
    assert trace.new_item() == 0
    _serve(model, _serving_batch(TINY['serve']))
    with trace.span('c2m.step'):
        pass
    assert trace.records() == []
    trace.enable(True)
    with trace.span('c2m.step'):
        pass
    assert [r.name for r in trace.records()] == ['c2m.step']


def test_checkpoint_recompute_nests_under_the_backward(recorder):
    """With a ``remat_policy``, the GAN step's backward recomputes G's
    forward, DynAggs included: their spans nest under ``c2m.g_backward``
    of the same step, not at the top."""
    model = _tiny_model(train=True, remat_policy='dots')
    model.feed_data(_training_batch(TINY['train']))
    model.optimize_parameters(_first_gan_step(model))
    recs = trace.records()
    ids = _by_id(recs)
    dynaggs = [r for r in recs if r.name.startswith('c2m.dynagg.')]
    # once in the forward (no graph kept) and once recomputed
    assert len(dynaggs) == 6
    paths = sorted(tuple(_path(recs, r)[1:]) for r in dynaggs)
    assert paths == (3 * [('c2m.g_backward', 'c2m.step')]
                     + 3 * [('c2m.g_forward', 'c2m.step')]), paths
    backward = next(r for r in recs if r.name == 'c2m.g_backward')
    for r in dynaggs:
        if ids[r.parent].name == 'c2m.g_backward':
            assert backward.start <= r.start <= r.end <= backward.end
    assert len({r.item for r in recs}) == 1
    assert [r.name for r in recs if r.parent == 0] == ['c2m.feed_data',
                                                       'c2m.step']


def _source_span_names():
    names = set()
    for path in PACKAGE.rglob('*.py'):
        names |= set(re.findall(r"trace\.span\('([^']+)'\)",
                                path.read_text()))
    return names


def test_span_names_are_the_programs_own(served, stepped):
    in_source = _source_span_names()
    recorded = {r.name for r in served + stepped}
    assert in_source and recorded
    assert in_source <= set(trace.NAMES)
    assert recorded <= set(trace.NAMES)
    assert len(set(trace.NAMES)) == len(trace.NAMES)
    for name in trace.NAMES:
        assert name.startswith('c2m.'), name


def test_mirrored_ranges_agree_with_the_ring(recorder):
    # the profiler's clock is the Unix epoch in ns
    offset = time.time_ns() - time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(200):
            with trace.span('c2m.test'):
                torch.ones(4).sum()
    ring = sorted(r.start for r in trace.records())
    assert len(ring) == 200 and all(r.profiled for r in trace.records())
    mirrored = sorted(e.start_ns() for e in prof.profiler.kineto_results
                      .events() if e.name() == 'c2m.test')
    assert len(mirrored) == 200
    gaps = [abs(m - (r + offset)) for m, r in zip(mirrored, ring)]
    assert statistics.median(gaps) < 0.5e6


def test_mirrored_ranges_nest_as_the_ring_does(recorder):
    """Under the profiler each recorded span has one mirrored range of its
    name, and each range lies inside its parent's range."""
    model = _tiny_model()
    batch = _serving_batch(TINY['serve'])
    _serve(model, batch)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(model, batch)
    recs = trace.records()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith('c2m.')]
    assert sorted(e.name() for e in events) == sorted(r.name for r in recs)
    # the ring's and the trace's order of opening match name for name
    ranges = sorted((e.start_ns(), -e.duration_ns(), e.name())
                    for e in events)
    by_open = sorted(recs, key=lambda r: r.start)
    assert [n for _, _, n in ranges] == [r.name for r in by_open]
    where = {r.id: (s, s - d) for r, (s, d, _) in zip(by_open, ranges)}
    for r in recs:
        if r.parent:
            (s, e), (ps, pe) = where[r.id], where[r.parent]
            assert ps <= s and e <= pe, r.name


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (on the card: python -m pytest '
                    '--noconftest tests/test_torch_trace.py -m card)')
    return torch.device('cuda')


def _full_model(train, device):
    """The options file's model at its widths on ``device``."""
    return RefRestorationModel(_model_opt(train, tiny=False), device)


@pytest.mark.card
def test_every_host_sync_is_inside_a_wait_span(card, monkeypatch):
    """A serving batch (inputs on the card, then on the host) and a
    G-pretrain and a GAN step at the benchmark's widths under
    ``torch.cuda.set_sync_debug_mode('error')``, which raises at any
    synchronising call but inside the ``c2m.wait.*`` spans, where this
    test drops it (the recorder itself never touches the mode). Each
    path runs once first with the mode off: its first calls build the
    kernels and pick cuDNN's plans."""
    span = trace.span

    def waiting(name):
        if not name.startswith('c2m.wait.'):
            return span(name)
        return _Lenient(span(name))

    serving = _full_model(False, card)
    host = _serving_batch(FULL['serve'])
    on_card = {k: v.to(card) for k, v in host.items()}
    training = _full_model(True, card)
    batch = {k: v.to(card)
             for k, v in _training_batch(FULL['train']).items()}
    first = _first_gan_step(training)

    def run():
        _serve(serving, on_card)
        _serve(serving, host)
        training.feed_data(batch)
        training.optimize_parameters(1)
        training.feed_data(batch)
        training.optimize_parameters(first)

    run()
    torch.cuda.synchronize()
    trace.clear()
    monkeypatch.setattr(trace, 'span', waiting)
    torch.cuda.set_sync_debug_mode('error')
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    names = {r.name for r in trace.records()}
    assert {'c2m.wait.offset_stats', 'c2m.wait.gp_alpha',
            'c2m.wait.upload'} <= names


class _Lenient:
    """A wait span with the sync debug mode off inside it."""

    def __init__(self, inner):
        self.inner = inner

    def __enter__(self):
        self.inner.__enter__()
        torch.cuda.set_sync_debug_mode(0)
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode('error')
        return self.inner.__exit__(*exc)
