"""The port's stage-3 training against the JAX package's, on the CPU.

One small JAX RefRestorationModel (``torch_train_common``) with the train
block of ``debug_stage3_synth.yml``; the port's model gets its variables
through ``utils/weights.py``. Held against JAX:

- the G-pretrain step: the pixel loss, the offset telemetry and every G
  gradient at rel 1e-4 (before Adam); Adam on identical gradients; the
  parameter deltas of each side's own step where |g| is clear of the
  gradients' disagreement;
- the MSE config's iteration (no ``network_d``, no perceptual loss).

The JAX model's optimizers are wrapped so that their state keeps each
update's gradient: one run of its own fused step gives both its gradients
and its updated parameters. The GAN step is in ``test_torch_train_gan.py``;
the LR groups and schedules, the ``do_g`` gating and save -> resume in
``test_torch_train_schedule.py`` (one JAX model per file keeps each file
under a minute).
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
from c2matching_tpu_torch.models.ref_restoration_model import (group_lrs,
                                                                 lr_group)
from c2matching_tpu_torch.utils import weights

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
    return common.make_synth(tmp_path_factory.mktemp('synth_train_step'))


@pytest.fixture(scope='module')
def jax_model(synth_root, tmp_path_factory):
    opt = common.small_opt(synth_root, str(tmp_path_factory.mktemp('jax')))
    model = jax_create_model(opt)
    common.install_recorders(model)
    return opt, model


def test_pretrain_step_matches_jax(jax_model):
    opt, jmodel = jax_model
    common.reset_optimizers(jmodel)
    snap = common.snapshot(jmodel)
    batch = common.batch(opt)
    port = common.port_model(opt, snap)
    before = common.torch_state(port.net_g)

    jmodel.feed_data(batch)
    jmodel.optimize_parameters(1)
    port.feed_data(batch)
    port.optimize_parameters(1)

    want = {k: float(v) for k, v in jmodel.log_dict.items()}
    assert set(port.log_dict) == set(want)
    common.close(float(port.log_dict['l_pix']), want['l_pix'], what='l_pix')
    for k in want:
        if k.startswith('offset_absmean'):
            assert float(port.log_dict[k]) == want[k] == 0.0, k
    grads = weights.restoration_net_state_dict(jmodel.opt_state_g[1])
    common.close_g_grads(port.net_g, grads, 'pretrain')
    common.close(port.output, np.asarray(jmodel.output), what='output')
    lrs = group_lrs(opt['train'])
    after = weights.restoration_net_state_dict(jax.device_get(
        jmodel.vars_g['params']))
    common.close_deltas(port.net_g, before, after, grads,
                        lambda name: lrs[lr_group(name)], 'pretrain')


def test_adam_on_identical_gradients(jax_model):
    """The port's Adam (four LR groups) and the JAX package's tx_g, one
    and two steps on the same gradients from the same parameters."""
    opt, jmodel = jax_model
    snap = common.snapshot(jmodel)
    port = common.port_model(opt, snap)
    params = jax.device_get(snap['g']['params'])
    rng = np.random.RandomState(0)
    tx = jax_make_adam(1e-4, lr_tree=jrm._offset_lr_tree(params,
                                                         opt['train']))
    state = tx.init(params)
    jparams = params

    @jax.jit
    def step(g, state, jparams):
        upd, state = tx.update(g, state, jparams)
        return optax.apply_updates(jparams, upd), state

    for _ in range(2):
        g = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32)
                         * 10.0 ** rng.uniform(-9, 0), params)
        jparams, state = step(g, state, jparams)
        g_state = weights.restoration_net_state_dict(g)
        for name, p in port.net_g.named_parameters():
            p.grad = g_state[name].clone()
        port.schedules.step('g')
    want = weights.restoration_net_state_dict(jax.device_get(jparams))
    base = weights.restoration_net_state_dict(params)
    for name, p in port.net_g.named_parameters():
        d_port = p.detach() - base[name]
        d_jax = want[name] - base[name]
        # plus two float32 ulps of the parameter, which the deltas carry
        tol = (1e-4 * d_jax.abs().max()
               + 2 * torch.finfo(torch.float32).eps * base[name].abs())
        assert bool(((d_port - d_jax).abs() <= tol).all()), name


def test_mse_config_iteration_matches_jax(jax_model, tmp_path):
    """The MSE config (no network_d, no perceptual loss,
    net_g_pretrain_steps 0): the iteration is the G update on the pixel
    loss, logged as l_g_pix."""
    opt, jmodel = jax_model
    net_d, jmodel.net_d = jmodel.net_d, None
    gan_step = jmodel._gan_step
    try:
        jmodel._gan_step = jmodel._build_gan_step()
        jmodel.net_g_pretrain_steps = 0
        common.reset_optimizers(jmodel)
        snap = common.snapshot(jmodel)
        mse_opt = common.small_opt(osp.dirname(
            opt['datasets']['train']['dataroot_in']), str(tmp_path),
            with_d=False, net_g_pretrain_steps=0)
        port = common.port_model(mse_opt, snap)
        batch = common.batch(opt)
        jmodel.feed_data(batch)
        jmodel.optimize_parameters(1)
        port.feed_data(batch)
        port.optimize_parameters(1)
    finally:
        jmodel.net_d, jmodel._gan_step = net_d, gan_step
        jmodel.net_g_pretrain_steps = opt['train']['net_g_pretrain_steps']
    want = {k: float(v) for k, v in jmodel.log_dict.items()}
    assert set(port.log_dict) == set(want)
    common.close(float(port.log_dict['l_g_pix']), want['l_g_pix'],
                 what='l_g_pix')
    common.close_g_grads(port.net_g, weights.restoration_net_state_dict(
        jmodel.opt_state_g[1]), 'mse')
