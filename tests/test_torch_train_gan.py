"""One stage-3 GAN iteration of the port against the JAX package's fused
GAN step, on the CPU.

The small model of ``torch_train_common`` with a discriminator and the
debug config's whole loss set (L1 pixel, fro perceptual on relu5_1 of the
JAX loss's seeded VGG19, WGAN with the gradient penalty). Both start from
the JAX model's variables, take the same batch and the same penalty
coefficients (drawn from the JAX model's key as its step draws them, and
handed to the port's ``gp_alpha``), and run the iteration after the
G-pretrain phase. Held against JAX at rel 1e-4:

- every logged loss and D output;
- D's gradients (before its update; the pre-BN conv biases, whose exact
  gradient is zero, against D's largest gradient), which also shows that
  the G phase left no gradient on D's parameters;
- G's gradients, taken through the UPDATED D in train mode;
- D's parameters and its BN running statistics after the iteration (the
  real, fake and G-phase passes move them, the penalty's pass does not;
  the running means net of the pre-BN conv biases' noise-driven step);
- the restored output, and G's and D's parameter deltas where |g| is
  clear of the gradients' disagreement.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_common as common
from c2matching_tpu.models import create_model as jax_create_model
from c2matching_tpu_torch.models.ref_restoration_model import (group_lrs,
                                                                 lr_group)
from c2matching_tpu_torch.utils import weights


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope='module')
def gan_step(tmp_path_factory):
    """Both models after one GAN iteration (step 5 of the debug config:
    the pretrain phase is 4 steps)."""
    root = common.make_synth(tmp_path_factory.mktemp('synth_gan'))
    opt = common.small_opt(root, str(tmp_path_factory.mktemp('gan')),
                           perceptual=True)
    jmodel = jax_create_model(opt)
    common.install_recorders(jmodel)
    snap = common.snapshot(jmodel)
    port = common.port_model(opt, snap)
    before = {'g': common.torch_state(port.net_g),
              'd': common.torch_state(port.net_d)}
    batch = common.batch(opt)
    # the key the JAX step splits off for the penalty's coefficients
    _, key = jax.random.split(jmodel._rng)
    port.gp_alpha = np.asarray(jax.random.uniform(key, (2, 1, 1, 1),
                                                  jnp.float32))
    step = opt['train']['net_g_pretrain_steps'] + 1
    jmodel.feed_data(batch)
    jmodel.optimize_parameters(step)
    port.feed_data(batch)
    port.optimize_parameters(step)
    return opt, jmodel, port, before


def test_losses_match_jax(gan_step):
    _, jmodel, port, _ = gan_step
    want = {k: float(v) for k, v in jmodel.log_dict.items()}
    assert set(port.log_dict) == set(want)
    for k, v in want.items():
        common.close(float(port.log_dict[k]), v, what=k)
    assert port.gp_alpha is None            # the injected draw was used
    common.close(port.output, np.asarray(jmodel.output), what='output')


def test_d_gradients_match_jax(gan_step):
    _, jmodel, port, _ = gan_step
    want = weights.discriminator_state_dict(
        {'params': jmodel.opt_state_d[1],
         'batch_stats': jax.device_get(jmodel.vars_d['batch_stats'])})
    common.close_d_grads(port.net_d.named_parameters(), want)


def test_g_gradients_through_updated_d_match_jax(gan_step):
    _, jmodel, port, _ = gan_step
    common.close_g_grads(port.net_g, weights.restoration_net_state_dict(
        jmodel.opt_state_g[1]), 'gan')


def test_d_after_step_matches_jax(gan_step):
    opt, jmodel, port, before = gan_step
    after = weights.discriminator_state_dict(jax.device_get(jmodel.vars_d))
    state = port.net_d.state_dict()
    for name in after:
        if name.endswith(('running_mean', 'running_var')):
            want = after[name]
            if name.endswith('running_mean'):
                # the G phase's pass sees the updated pre-BN conv bias, whose
                # Adam step follows a rounding-noise gradient (+-lr on each
                # side): that shift moves the batch mean, and the running
                # mean by 0.1 of it
                block, idx = name.rsplit('.', 1)[0].rsplit('.', 1)
                bias = f'{block}.{int(idx) - 1}.bias'
                want = want + 0.1 * (state[bias] - after[bias])
            common.close(state[name], want, what=name)
            assert not torch.equal(state[name], before['d'][name]), name
    grads = weights.discriminator_state_dict(
        {'params': jmodel.opt_state_d[1],
         'batch_stats': jax.device_get(jmodel.vars_d['batch_stats'])})
    lr_d = opt['train']['lr_d']
    common.close_deltas(
        _Unbiased(port.net_d), before['d'], after,
        {k: v for k, v in grads.items()}, lambda name: lr_d, 'd')


def test_g_deltas_match_jax(gan_step):
    opt, jmodel, port, before = gan_step
    lrs = group_lrs(opt['train'])
    after = weights.restoration_net_state_dict(
        jax.device_get(jmodel.vars_g['params']))
    common.close_deltas(port.net_g, before['g'], after,
                        weights.restoration_net_state_dict(
                            jmodel.opt_state_g[1]),
                        lambda name: lrs[lr_group(name)], 'gan g')


class _Unbiased:
    """D's named parameters without the pre-BN conv biases, whose gradient
    signs are rounding noise."""

    def __init__(self, net):
        self.net = net

    def named_parameters(self):
        return ((n, p) for n, p in self.net.named_parameters()
                if not common.pre_bn_bias(n))
