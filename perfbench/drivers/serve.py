"""Serving driver: requests through ``feed_data`` -> ``test`` ->
``cropped_output``, each output copied to the host.

A closed loop (``arrivals`` 'closed'): one client sends the pool's
batches in turn, the next when the last output is on the host. The window
runs whole batches until ``seconds`` have passed, then the batches the
check samples, and ends when the last output is on the host;
``images_per_s`` is the images over that window. A traced run times its
first half without the profiler, traces the second, and serves the
sampled batches after it (``bench.Run.stretches``).

The check compares a sample of the served requests, drawn from the seed
before the window, with the plain reference (``check``).
"""
import time

import torch

from perfbench.harness import inputs, program
from perfbench.harness.judge import Numbers, rel_max
from perfbench.harness.weights import make_weights
from perfbench.reference import nets

# side of the deep sample's crop on the relu3 (LR) grid: 32 x 32 of a
# 128 x 84 request, 128 x 128 pixels of its relu1 layers
CROP = 32


class _Range:
    """A ``record_function`` range in traced runs, nothing otherwise."""

    def __init__(self, on, name):
        self.rf = torch.autograd.profiler.record_function(name) if on \
            else None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def setup(run):
    cfg, tr, dev = run.config, run.traffic, run.device
    run.weights = make_weights(nets.serving_param_shapes(cfg['network_g']),
                               run.seed, dev)
    run.model = program.build(cfg, run.weights, dev, train=False)
    run.phase('model_s')
    if tr['arrivals'] != 'closed' or len(tr['sizes']) != 1:
        raise ValueError('the serving driver runs a closed loop of one '
                         'size')
    run.pool = inputs.serving_pool(tr, run.seed, dev)
    run.phase('inputs_s')
    run.capture = program.Capture(run.model)
    if run.trace:
        run.spans = program.Spans(run.model)
    _choose_sample(run)
    for batches in run.pool.values():       # every shape the cell serves
        for _ in range(2):
            _serve(run, batches[0])
    run.phase('warmup_s')


def _choose_sample(run):
    """The served requests the check compares, drawn from the seed:
    (batch's place in the pool, image in it), one of them also compared
    layer by layer ('deep')."""
    sample = run.traffic['sample']
    gen = torch.Generator().manual_seed(run.seed % (2 ** 63))
    batches = torch.randperm(run.traffic['pool'],
                             generator=gen)[:sample['batches']]
    picks = [(int(b), int(j)) for b in batches for j in torch.randperm(
        run.traffic['batch'], generator=gen)[:sample['images']]]
    run.sample = picks
    run.deep = picks[0]
    # the deep sample's layers are compared on a crop, cut on the card so
    # that nothing leaves the device inside the window
    hr = run.traffic['sizes'][0]
    vh, vw = hr[0] // 4, hr[1] // 4
    side = min(CROP, vh, vw)
    run.crop = (int(torch.randint(0, vh - side + 1, (1,), generator=gen)),
                int(torch.randint(0, vw - side + 1, (1,), generator=gen)),
                side)
    run.kept = {}


def _serve(run, batch, ranges=False):
    """One request (a batch) through the entry points, in ``ranges`` of
    its own; returns the output on the host."""
    model = run.model
    with _Range(ranges, 'feed_data'):
        model.feed_data(batch)
    with _Range(ranges, 'test'):
        model.test()
    with _Range(ranges, 'cropped_output'):
        out = model.cropped_output()
    with _Range(ranges, 'to_host'):
        return out.cpu()


def _arm(run, number):
    """Capture this request's outputs where the sample holds it (its
    number is the batch's place in the pool)."""
    images = [j for (i, j) in run.sample if i == number]
    if images:
        slot = [i for i, _ in run.sample].index(number)
        deep = run.deep[1] if run.deep[0] == number else None
        run.capture.arm(slot, deep, run.crop)
    return images


def _keep(run, number, images, out, size):
    got = run.capture.disarm()
    for j in images:
        run.kept[(number, j)] = {
            'size': size, 'image': j,
            'output': out[j], 'flow': got['flow'][j],
            'deep': ({k: v for k, v in got.items() if k != 'flow'}
                     if (number, j) == run.deep else None)}


def window(run):
    """The pool's batches in turn until ``seconds`` have passed; then the
    sampled batches of the pool (by their place in it) close the window,
    so that their capture, a few copies on the card, stays out of its
    bulk (capturing inside it moved some runs' rate by 3%). A traced run
    serves them after its traced stretch."""
    pool = run.pool[0]
    n = 0
    for seconds, traced in run.stretches():
        with run.traced(traced):
            start = time.perf_counter()
            m = 0
            while time.perf_counter() - start < seconds:
                with _Range(traced, 'request'):
                    _serve(run, pool[(n + m) % len(pool)], traced)
                m += 1
            if not run.trace:
                m += _sampled(run)
            end = time.perf_counter()
        run.record(traced, m, end - start)
        n += m
    if run.trace:
        n += _sampled(run)
    b = run.traffic['batch']
    run.attempted, run.failed = n * b, 0
    run.e2e['images_per_s'] = b * run.plain['items'] / run.plain['seconds']


def _sampled(run):
    """Serve the sampled batches, keeping their outputs; returns how
    many."""
    numbers = list(dict.fromkeys(i for i, _ in run.sample))
    for number in numbers:
        images = _arm(run, number)
        out = _serve(run, run.pool[0][number])
        _keep(run, number, images, out, 0)
    return len(numbers)


def release(run):
    """Free the program's state before the reference runs."""
    run.capture.remove()
    if getattr(run, 'spans', None) is not None:
        run.spans.remove()
    run.model = None
    torch.cuda.empty_cache() if run.device.type == 'cuda' else None


# ------------------------------------------------------------- the check
def _exact(run, size, number, image):
    """One request's exact-size inputs, NCHW (the pool holds them at the
    request's own size; the model pads its copy)."""
    batch = run.pool[size][number]
    return {k: batch[k][image:image + 1].permute(0, 3, 1, 2)
            for k in ('img_in_lq', 'img_in_up', 'img_ref')}


def program_samples(run):
    """The sampled requests as the program served them: the match's
    indices on the exact grid, the output (and the deep sample's layer
    crops), CHW on the host."""
    out = []
    for (number, image), kept in sorted(run.kept.items()):
        hr = run.traffic['sizes'][kept['size']]
        valid3 = (hr[0] // 4, hr[1] // 4)
        o = kept['output'].permute(2, 0, 1)
        sample = {'size': kept['size'], 'number': number, 'image': image,
                  'idx': program.flow_to_index(kept['flow'].cpu(), valid3),
                  'output': o, 'layers': None}
        if kept['deep'] is not None:
            sample['layers'] = {k: v.cpu().permute(2, 0, 1)
                                for k, v in kept['deep'].items()}
        out.append(sample)
    return out


def control_samples(run, prec):
    """The same requests answered by the reference in the precision
    ``prec`` put in the program's place."""
    out = []
    net = run.config['network_g']
    for (number, image) in run.sample:
        x = _exact(run, 0, number, image)
        r = nets.serve_image(x['img_in_lq'], x['img_in_up'], x['img_ref'],
                             run.weights, net, prec)
        f_in, f_ref = r['features']
        layers = {'dense_features1': f_in[0], 'dense_features2': f_ref[0],
                  **{k: v[0] for k, v in r['ref_feats'].items()},
                  **{f'dynagg.{k}': v[0] for k, v in r['taps'].items()}}
        out.append({'size': 0, 'number': number, 'image': image,
                    'idx': r['idx'].cpu(), 'output': r['output'][0].cpu(),
                    'layers': {k: _cut(run, k, v).cpu()
                               for k, v in layers.items()}
                    if (number, image) == run.deep else None})
    return out


def judge(run, samples):
    """The compared numbers of ``samples`` against the reference in the
    configuration's precision:

    - match_gap: the widest gap by which a chosen reference patch's score
      lies below the best (cosine units), over every valid query;
    - out_rel: max |output - reference| / max |reference| of each output,
      the reference following the judged match indices;
    - feat_rel, dynagg_rel: max |layer - reference| over the crop
      against max |reference| over the whole valid layer, of the deep
      sample's extractor and VGG features and of its three DynAgg outputs.
    """
    numbers = Numbers(run.limits)
    prec = nets.Precision(**run.config['reference_precision'])
    net = run.config['network_g']
    expected = set(run.sample)
    got = {(s['number'], s['image']) for s in samples}
    if got != expected:
        numbers.notes.append(f'{len(expected - got)} sampled requests '
                             'never answered')
        numbers.put('answered', 0.0)
    for s in samples:
        x = _exact(run, s['size'], s['number'], s['image'])
        f_in, f_ref = nets.extractor(x['img_in_up'], x['img_ref'],
                                     run.weights, prec)
        match = nets.Match(f_in[0], f_ref[0], prec)
        idx = s['idx'].to(f_in.device)
        gap = match.gap(idx)
        where = f'request {s["number"]} image {s["image"]}'
        numbers.put('match_gap', float(gap.max()), where)
        follow = torch.where(idx >= 0, idx, match.best()[1])
        r = nets.serve_image(x['img_in_lq'], x['img_in_up'], x['img_ref'],
                             run.weights, net, prec, match_idx=follow)
        numbers.put('out_rel', rel_max(s['output'], r['output'][0].cpu()),
                    where)
        if s['layers'] is not None:
            lay = s['layers']
            ref_layers = {'dense_features1': f_in[0],
                          'dense_features2': f_ref[0],
                          **{k: v[0] for k, v in r['ref_feats'].items()}}
            for k, v in ref_layers.items():
                numbers.put('feat_rel', _crop_rel(run, k, lay[k], v), k)
            for k, v in r['taps'].items():
                name = f'dynagg.{k}'
                numbers.put('dynagg_rel', _crop_rel(run, name, lay[name],
                                                    v[0]), k)
    return numbers


def _cut(run, name, layer):
    """The deep sample's crop of a CHW ``layer``."""
    y, x, side = run.crop
    f = program.SCALE[name.split('.')[-1]]
    return layer[:, y * f:(y + side) * f, x * f:(x + side) * f]


def _crop_rel(run, name, prog_crop, ref_layer):
    """max |prog - ref| over the crop over max |ref| over the layer."""
    ref_crop = _cut(run, name, ref_layer).double().cpu()
    scale = ref_layer.double().abs().max().clamp_min(1e-30).cpu()
    return float((prog_crop.double() - ref_crop).abs().max() / scale)


def check(run):
    with torch.no_grad():
        return judge(run, program_samples(run))
