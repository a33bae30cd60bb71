"""The port's stage-3 LR groups, schedules, gating and resume against the
JAX package's, on the CPU.

One small JAX RefRestorationModel (``torch_train_common``) with the train
block of ``debug_stage3_synth.yml``. Held against it:

- the LR group of every G parameter (``_offset_lr_tree``'s labels) and
  ``base_lrs``;
- the LRs each optimizer update applies over the debug config's 12
  iterations, and the logged LRs, with G unscheduled (the default) and
  with ``schedule_net_g``, restarts and D-only iterations;
- the ``do_g`` sequence of ``tests/test_gan_gating.py``;
- save -> resume reproducing the next GAN step bit for bit (port only).
"""
import importlib
import os.path as osp

import jax
import numpy as np
import optax
import pytest
import torch

import torch_train_common as common
from c2matching_tpu.models import create_model as jax_create_model
from c2matching_tpu.models.base_model import make_adam as jax_make_adam
from c2matching_tpu.models.base_model import shift_schedule_count
from c2matching_tpu.models.lr_scheduler import build_schedule
from c2matching_tpu_torch.models import RefRestorationModel
from c2matching_tpu_torch.models.ref_restoration_model import lr_group
from c2matching_tpu_torch.utils import check_resume, weights
from test_gan_gating import simulate

jrm = importlib.import_module('c2matching_tpu.models.ref_restoration_model')


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope='module')
def synth_root(tmp_path_factory):
    return common.make_synth(tmp_path_factory.mktemp('synth_schedule'))


@pytest.fixture(scope='module')
def synth32(tmp_path_factory):
    """One 32-px pair, for the port's own runs of many iterations."""
    return common.make_synth(tmp_path_factory.mktemp('synth32'), n=1,
                             size=32)


@pytest.fixture(scope='module')
def jax_model(synth_root, tmp_path_factory):
    opt = common.small_opt(synth_root, str(tmp_path_factory.mktemp('jax')))
    model = jax_create_model(opt)
    model.feed_data(common.batch(opt))
    return opt, model


def test_lr_group_of_every_parameter(jax_model):
    opt, jmodel = jax_model
    params = jax.device_get(jmodel.vars_g['params'])
    tree = jrm._offset_lr_tree(params, opt['train'])
    want = weights.restoration_net_state_dict(jax.tree.map(
        lambda p, lr: np.full(np.shape(p), lr, np.float32), params, tree))
    port = RefRestorationModel(opt, 'cpu')
    by_param = {id(p): g for g in port.optimizer_g.param_groups
                for p in g['params']}
    seen = set()
    for name, p in port.net_g.named_parameters():
        group = by_param[id(p)]
        assert group['name'] == lr_group(name)
        assert np.all(want[name].numpy() == np.float32(group['base_lr'])), \
            name
        seen.add(group['name'])
    assert seen == {'g', 'offset', 'relu3_offset', 'relu2_offset'}
    assert port.base_lrs() == jmodel.base_lrs()


def _jax_lr_trace(jmodel, opt, schedule_g, steps):
    """The LRs of each optimizer update of the JAX model's own
    optimize_parameters over ``steps`` iterations, its steps replaced by
    their optimizer bookkeeping (the fused step's D update, G update or
    G schedule shift): each LR read as minus the first update of a fresh
    Adam, at the state's schedule count, on gradients of ones (-lr to the
    float32 rounding of Adam's bias corrections, ~1e-5)."""
    params_g = jax.device_get(jmodel.vars_g['params'])
    params_d = jax.device_get(jmodel.vars_d['params'])
    tx_g = jax_make_adam(
        opt['train']['lr_g'],
        schedule_fn=jmodel.schedule_fn if schedule_g else None,
        lr_tree=jrm._offset_lr_tree(params_g, opt['train']))
    tx_d = jax_make_adam(opt['train']['lr_d'], schedule_fn=jmodel.schedule_fn)
    # a fresh Adam at every update, at the schedule count the model's
    # state carries: the update is then exactly -lr
    trace = []

    update = {id(tx): jax.jit(tx.update) for tx in (tx_g, tx_d)}

    def lr_of(tx, state, params):
        upd, _ = update[id(tx)](jax.tree.map(np.ones_like, params), state,
                                params)
        return jax.tree.map(lambda u: -float(np.asarray(u).reshape(-1)[0]),
                            upd)

    def adam_fresh(state):
        return jax.tree.map(
            lambda s: (s._replace(mu=jax.tree.map(np.zeros_like, s.mu),
                                  nu=jax.tree.map(np.zeros_like, s.nu),
                                  count=np.zeros_like(s.count))
                       if isinstance(s, optax.ScaleByAdamState) else s),
            state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))

    def step_g(state):
        trace.append(('g', lr_of(tx_g, adam_fresh(state), params_g)))
        return update[id(tx_g)](jax.tree.map(np.zeros_like, params_g), state,
                                params_g)[1]

    def step_d(state):
        trace.append(('d', lr_of(tx_d, adam_fresh(state), params_d)))
        return update[id(tx_d)](jax.tree.map(np.zeros_like, params_d), state,
                                params_d)[1]

    state = {'g': tx_g.init(params_g),
             'd': shift_schedule_count(tx_d.init(params_d),
                                       jmodel.net_g_pretrain_steps)}

    def pretrain(*args):
        state['g'] = step_g(state['g'])
        return args[0], args[1], None, {}

    def gan(*args, do_g):
        state['d'] = step_d(state['d'])
        state['g'] = (step_g(state['g']) if do_g
                      else shift_schedule_count(state['g'], 1))
        return args[0], args[1], args[2], args[3], None, {}

    saved = jmodel._g_pretrain_step, jmodel._gan_step
    jmodel._g_pretrain_step, jmodel._gan_step = pretrain, gan
    try:
        for step in range(1, steps + 1):
            jmodel.optimize_parameters(step)
    finally:
        jmodel._g_pretrain_step, jmodel._gan_step = saved
    return trace


@pytest.mark.parametrize('variant', ['debug', 'schedule_g_d_only'])
def test_lrs_per_iteration_match_jax(variant, jax_model, synth32, tmp_path):
    """Every optimizer update of the debug config's 12 iterations applies
    the JAX model's LRs; the port runs its real iterations on one 32-px
    item."""
    opt, jmodel = jax_model
    extra = {}
    if variant == 'schedule_g_d_only':
        extra = {'schedule_net_g': True, 'net_d_steps': 2,
                 'net_d_init_steps': 1, 'lr_steps': [3, 8, 10],
                 'restarts': [6], 'restart_weights': [0.5]}
    root = osp.dirname(opt['datasets']['train']['dataroot_in'])
    jopt = common.small_opt(root, str(tmp_path / 'j'), **extra)
    popt = common.small_opt(synth32, str(tmp_path / 'p'), gt=32, **extra)
    popt['datasets']['train']['batch_size'] = 1
    saved = (jmodel.opt, jmodel.schedule_fn, jmodel.net_d_steps,
             jmodel.net_d_init_steps, jmodel._schedule_g)
    jmodel.opt, jmodel.schedule_fn = jopt, build_schedule(jopt['train'])
    jmodel.net_d_steps = jopt['train']['net_d_steps']
    jmodel.net_d_init_steps = jopt['train']['net_d_init_steps']
    jmodel._schedule_g = bool(extra)
    try:
        want = _jax_lr_trace(jmodel, jopt, bool(extra), 12)
        want_report = [jmodel.current_learning_rates(s) for s in range(1, 13)]
    finally:
        (jmodel.opt, jmodel.schedule_fn, jmodel.net_d_steps,
         jmodel.net_d_init_steps, jmodel._schedule_g) = saved

    port = RefRestorationModel(popt, 'cpu')
    got = []
    step = port.schedules.step

    def spy(name):
        got.append((name, port.schedules.lrs(name)))
        step(name)

    port.schedules.step = spy
    port.feed_data(common.batch(popt, n=1))
    report = []
    for s in range(1, 13):
        port.optimize_parameters(s)
        report.append(port.current_learning_rates(s))
    assert [n for n, _ in got] == [n for n, _ in want]
    groups = {g['name']: i for i, g in
              enumerate(port.optimizer_g.param_groups)}
    for (name, lrs), (_, tree) in zip(got, want):
        if name == 'd':
            want_lrs = set(jax.tree.leaves(tree))
            assert len(want_lrs) == 1
            np.testing.assert_allclose(lrs, [want_lrs.pop()], rtol=1e-4)
            continue
        state = weights.restoration_net_state_dict(jax.tree.map(
            lambda v, p: np.full(np.shape(p), v, np.float32), tree,
            jax.device_get(jmodel.vars_g['params'])))
        for pname, _ in port.net_g.named_parameters():
            np.testing.assert_allclose(
                lrs[groups[lr_group(pname)]],
                float(state[pname].reshape(-1)[0]), rtol=1e-4, err_msg=pname)
    np.testing.assert_allclose(report, want_report, rtol=1e-6)


@pytest.mark.parametrize('pretrain,d_steps,d_init', [
    (10000, 1, 0), (0, 1, 0), (5, 3, 2), (0, 2, 1)])
def test_do_g_sequence_matches_gating(pretrain, d_steps, d_init, jax_model,
                                      tmp_path):
    opt, _ = jax_model
    port = RefRestorationModel(common.small_opt(
        osp.dirname(opt['datasets']['train']['dataroot_in']), str(tmp_path),
        net_g_pretrain_steps=pretrain, net_d_steps=d_steps,
        net_d_init_steps=d_init), 'cpu')
    ran = []
    port._pretrain_iteration = lambda: ran.append('g_pretrain')
    port._gan_iteration = lambda do_g: ran.extend(['d', 'g'] if do_g
                                                  else ['d'])
    want = []
    for step in range(1, 40):
        port.optimize_parameters(step)
        want.extend(simulate(step, pretrain, d_steps, d_init))
    assert ran == want


def test_save_resume_reproduces_next_step(synth32, tmp_path):
    """Save after a GAN step, resume in a new model from the .state (nets
    from the .pth files check_resume points at), and the next step gives
    the same bits as the run that went on."""
    opt = common.small_opt(synth32, str(tmp_path), gt=32)
    opt['datasets']['train']['batch_size'] = 1
    batch = common.batch(opt, n=1)
    first = RefRestorationModel(opt, 'cpu')
    first.feed_data(batch)
    for step in (4, 5):
        first.optimize_parameters(step)
    first.save(0, 5)
    first.optimize_parameters(6)

    resumed_opt = common.small_opt(synth32, str(tmp_path), gt=32)
    state = osp.join(str(tmp_path), 'training_state', '5.state')
    resumed_opt['path']['resume_state'] = state
    check_resume(resumed_opt, '5')
    assert resumed_opt['path']['pretrain_model_g'].endswith('net_g_5.pth')
    assert resumed_opt['path']['pretrain_model_d'].endswith('net_d_5.pth')
    second = RefRestorationModel(resumed_opt, 'cpu')
    assert second.resume_training(state) == (0, 5)
    second.feed_data(batch)
    second.optimize_parameters(6)
    for net in ('net_g', 'net_d'):
        a = getattr(first, net).state_dict()
        b = getattr(second, net).state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), (net, k)
    assert first.schedules.counts == second.schedules.counts
    for k, v in first.log_dict.items():
        assert float(v) == float(second.log_dict[k]), k
