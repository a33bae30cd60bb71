"""Training driver: stage-3 iterations through ``feed_data`` ->
``optimize_parameters(step)``.

Set-up builds one model with its optimizers and drives it through its
first three steps on three distinct batches of the pool, through the
window's own call and feed; those steps warm every shape up, and the
check follows them with the plain reference. The window then runs steps
until ``seconds`` have passed on the host and ends in a synchronise;
``train_step_ms`` is the window over the steps (end to end where the
cell lists it; a cell that does not carries its traced run's untraced
stretch as ``step_ms``, per layer). A traced run times its first half
without the profiler and traces the second (``bench.Run.stretches``).

Once the window's time and the peak are read, ``close`` keeps the state
the window reached (weights and Adam's moments, on the card) and takes
one more step through the same call; the check replays that step in the
reference from the kept state and compares its match, its losses and
each leaf's change, so that the state the window's own steps made is
judged too, not only set-up's first steps.

Each step's gradient-penalty coefficients are the benchmark's, handed to
the model as ``gp_alpha`` and to the reference alike.
"""
import time

import torch

from perfbench.harness import inputs, program
from perfbench.harness.judge import Numbers, moved_leaves, worst_leaf
from perfbench.harness.weights import make_weights
from perfbench.reference import nets
from perfbench.reference.train import TrainReference, training_param_shapes

CHECKED_STEPS = 3
ALPHA_ROWS = 64
# the gradient penalty is read as a number of its own: a function of D's
# input gradient through ten convolutions, twice differentiated, it swings
# with rounding far more than the other losses (PERF.md)
GAP_NUMBER = {'l_grad_penalty': 'gp_rel'}


def _gan(run):
    return run.traffic['first_step'] > \
        run.config['train']['net_g_pretrain_steps']


def _shapes(run):
    return training_param_shapes(run.config['network_g'],
                                 run.config['network_d']['ndf'])


def setup(run):
    cfg, tr, dev = run.config, run.traffic, run.device
    run.weights = make_weights(_shapes(run), run.seed, dev)
    run.model = program.build(cfg, run.weights, dev, train=True)
    run.phase('model_s')
    run.pool = inputs.training_pool(tr, run.seed, dev)
    run.alphas = inputs.gp_alphas(run.seed, ALPHA_ROWS, tr['batch'])
    run.phase('inputs_s')
    run.capture = program.Capture(run.model)
    if run.trace:
        run.spans = program.Spans(run.model)
    run.first = []
    for k in range(CHECKED_STEPS):
        run.capture.arm(slot=k)
        _step(run, k)
        flow = run.capture.disarm()['flow'].cpu()
        run.first.append({'losses': _losses(run), 'flow': flow})
        if k == 0:
            run.first_grads = _optimizer_grads(run)
    run.changes = _changes(run)
    run.step_no = CHECKED_STEPS
    run.closing = None
    run.phase('warmup_s')


def _step(run, k):
    model = run.model
    model.feed_data(run.pool[k % len(run.pool)])
    if _gan(run):
        model.gp_alpha = run.alphas[k % ALPHA_ROWS]
    model.optimize_parameters(run.traffic['first_step'] + k)


def _named(run):
    model = run.model
    out = {f'net_g.{n}': p for n, p in model.net_g.named_parameters()}
    if model.net_d is not None:
        out.update({f'net_d.{n}': p for n, p in
                    model.net_d.named_parameters()})
    return out


def _trained(run):
    """(name, parameter, its optimizer's state, beta1) of each leaf the
    step's optimizers hold."""
    named = {id(p): n for n, p in _named(run).items()}
    opts = [run.model.optimizer_g]
    if _gan(run):
        opts.append(run.model.optimizer_d)
    return [(named[id(p)], p, opt.state.get(p), group['betas'][0])
            for opt in opts for group in opt.param_groups
            for p in group['params']]


def _optimizer_grads(run):
    """Each trained leaf's first gradient as Adam got it: its first moment
    after one step over (1 - beta1)."""
    return {name: float((state['exp_avg'].double() / (1 - beta1)).norm())
            for name, _, state, beta1 in _trained(run)
            if state and 'exp_avg' in state}


def _changes(run):
    """Each leaf's change over the first steps, by its norm."""
    with torch.no_grad():
        return {n: float((p.double() - run.weights[n].double()).norm())
                for n, p in _named(run).items()}


def window(run):
    n = 0
    for seconds, traced in run.stretches():
        with run.traced(traced):
            start = time.perf_counter()
            m = 0
            while True:
                _step(run, run.step_no)
                run.step_no += 1
                m += 1
                if time.perf_counter() - start >= seconds:
                    break
            run.sync()
            end = time.perf_counter()
        run.record(traced, m, end - start)
        n += m
    run.attempted, run.failed = n, 0
    run.e2e['train_step_ms'] = 1e3 * run.plain['seconds'] \
        / run.plain['items']


def close(run):
    """Keep the state the window reached, on the card, then take the next
    step through the window's own call (its losses, match and each leaf's
    change, for the check)."""
    with torch.no_grad():
        weights = {n: p.detach().clone() for n, p, _, _ in _trained(run)}
        moments = {n: {k: v.clone() for k, v in (state or {}).items()}
                   for n, _, state, _ in _trained(run)}
    k = run.step_no
    run.capture.arm(slot=CHECKED_STEPS)
    _step(run, k)
    flow = run.capture.disarm()['flow'].cpu()
    with torch.no_grad():
        changes = {n: float((p.double() - weights[n].double()).norm())
                   for n, p, _, _ in _trained(run)}
    run.closing = {'step': k, 'weights': weights, 'moments': moments,
                   'losses': _losses(run), 'flow': flow,
                   'changes': changes}


def _losses(run):
    return {n: float(v) for n, v in run.model.log_dict.items()
            if n.startswith('l_')}


def release(run):
    run.capture.remove()
    if getattr(run, 'spans', None) is not None:
        run.spans.remove()
    run.model = None
    if run.device.type == 'cuda':
        torch.cuda.empty_cache()


# ------------------------------------------------------------- the check
def _nchw(run, k):
    b = run.pool[k % len(run.pool)]
    t = {k2: v.permute(0, 3, 1, 2) for k2, v in b.items()}
    return {'lq': t['img_in_lq'], 'up': t['img_in_up'], 'ref': t['img_ref'],
            'gt': t['img_in']}


def program_result(run):
    lq = run.pool[0]['img_in_lq']
    valid3 = tuple(lq.shape[1:3])

    def idx(flow):
        return [program.flow_to_index(f, valid3) for f in flow]
    res = {'losses': [s['losses'] for s in run.first],
           'idx': [idx(s['flow']) for s in run.first],
           'grads': run.first_grads, 'changes': run.changes}
    if run.closing is not None:
        res['close'] = dict(run.closing, idx=idx(run.closing['flow']))
    return res


def _reference(run, prec):
    return TrainReference(run.weights, _shapes(run), run.config['train'],
                          run.config['network_g'], _gan(run), prec)


def _alpha(run, k):
    return run.alphas[k % ALPHA_ROWS].to(run.device)


def control_result(run, prec):
    """The first steps as the reference in ``prec`` takes them, in the
    program's place."""
    ref = _reference(run, prec)
    losses, idx = [], []
    for k in range(CHECKED_STEPS):
        logs = ref.step(_nchw(run, k), alpha=_alpha(run, k))
        losses.append({n: float(v) for n, v in logs.items()})
        idx.append([i.cpu() for i in ref.last_idx])
    grads = {n: float(g.double().norm()) for n, g in ref.first_grads.items()}
    with torch.no_grad():
        changes = {n: float((ref.w[n].double() - run.weights[n].double())
                            .norm()) for n in grads}
    return {'losses': losses, 'idx': idx, 'grads': grads,
            'changes': changes}


def judge(run, res):
    """The compared numbers of a result against the reference in the
    configuration's precision, which follows the judged match indices:
    set-up's first steps from the seeded weights, and the closing step
    (where the result has one) from the state the window reached. Each
    number is the worst over both:

    - match_gap: the widest gap by which a chosen reference patch's score
      lies below the best, over every query of every image and step;
    - loss_rel: the largest |loss - reference| / |reference| over the
      steps' losses but the gradient penalty, which is gp_rel;
    - grad_rel: the first step's gradients' norms by the worst leaf, each
      gap against the larger of the leaf's reference norm and the median
      leaf's (the closing step's, a sum over the window's history in
      Adam's moments, is not read);
    - change_rel: the same of the leaves' change over the first steps (or
      the closing one), leaving out leaves whose reference gradient is
      under 1e-3 of the median leaf's (round-off alone moves them under
      Adam).
    """
    numbers = Numbers(run.limits)
    prec = nets.Precision(**run.config['reference_precision'])
    ref = _reference(run, prec)
    for k in range(CHECKED_STEPS):
        _judge_step(run, numbers, ref, prec, k, res['idx'][k],
                    res['losses'][k], f'step {k}')
    _judge_grads(numbers, ref, res['grads'])
    _judge_change(numbers, ref, res['changes'], run.weights, 'first steps')
    close = res.get('close')
    if close is not None:
        k = close['step']
        ref = TrainReference(dict(run.weights, **close['weights']),
                             _shapes(run), run.config['train'],
                             run.config['network_g'], _gan(run), prec)
        ref.set_moments(close['moments'])
        _judge_step(run, numbers, ref, prec, k, close['idx'],
                    close['losses'], f'close step {k}')
        _judge_change(numbers, ref, close['changes'], close['weights'],
                      f'close step {k}')
    return numbers


def _judge_step(run, numbers, ref, prec, k, idxs, losses, where):
    """Judge step ``k``'s match and losses, the reference taking the
    step on the judged indices."""
    batch = _nchw(run, k)
    follow = []
    for i, idx in enumerate(idxs):
        f_in, f_ref = nets.extractor(batch['up'][i:i + 1],
                                     batch['ref'][i:i + 1], ref.w, prec)
        match = nets.Match(f_in[0], f_ref[0], prec)
        idx = idx.to(f_in.device)
        numbers.put('match_gap', float(match.gap(idx).max()),
                    f'{where} image {i}')
        follow.append(torch.where(idx >= 0, idx, match.best()[1]))
    logs = ref.step(batch, match_idx=follow, alpha=_alpha(run, k))
    for name, v in logs.items():
        p = losses.get(name)
        v = float(v)
        numbers.put(GAP_NUMBER.get(name, 'loss_rel'),
                    float('inf') if p is None else
                    abs(p - v) / max(abs(v), 1e-30), f'{where} {name}')


def _judge_grads(numbers, ref, grads):
    """Judge the gradients of the reference's first step."""
    ref_grads = {n: float(g.double().norm())
                 for n, g in ref.first_grads.items()}
    if set(grads) != set(ref_grads):
        numbers.notes.append('the trained leaves differ from the '
                             "reference's")
        numbers.put('grad_rel', float('inf'))
    else:
        numbers.put('grad_rel', *worst_leaf(grads, ref_grads,
                                            list(ref_grads)))


def _judge_change(numbers, ref, changes, start, where):
    """Judge each leaf's change since ``start`` against the reference's
    over its steps."""
    with torch.no_grad():
        ref_changes = {n: float((ref.w[n].double() - start[n].double())
                                .norm()) for n in ref.first_grads}
    moved = moved_leaves(ref.first_grads)
    gap, leaf = worst_leaf({n: changes.get(n, 0.0) for n in moved},
                           ref_changes, moved)
    numbers.put('change_rel', gap, f'{where} {leaf}')


def check(run):
    return judge(run, program_result(run))
