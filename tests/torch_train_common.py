"""Shared set-up of the stage-3 training parity tests
(``test_torch_train_step.py``, ``test_torch_train_gan.py``).

A small stage-3 model (ngf 16, 2 blocks, 8 groups; D ndf 4; batch 2 at gt
64, as ``tests/test_models.py`` sizes it) with the train block of
``options/train/debug_stage3_synth.yml``; the JAX model's variables bridged
into the port's model by ``c2matching_tpu_torch/utils/weights.py``; and an
optax wrapper that keeps each update's gradient in the optimizer state, so
that one run of the JAX package's own fused step gives its gradients and
its updated parameters.
"""
import copy
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from c2matching_tpu.data import RefCUFEDDataset as JaxDataset
from c2matching_tpu.data.loader import default_collate
from c2matching_tpu.utils import dict_to_nonedict
from c2matching_tpu_torch.models import RefRestorationModel
from c2matching_tpu_torch.utils import options, weights

REPO = osp.abspath(osp.join(osp.dirname(__file__), osp.pardir))
DEBUG_CFG = osp.join(REPO, 'options', 'train', 'debug_stage3_synth.yml')
REL = 1e-4


def make_synth(root, n=4, size=64):
    subprocess.run([sys.executable,
                    osp.join(REPO, 'scripts', 'make_synth_dataset.py'),
                    str(root), '--n', str(n), '--size', str(size)],
                   check=True)
    return str(root)


def small_opt(root, out, with_d=True, perceptual=False, gt=64, **train):
    """The options dict of the small model on the synth set under
    ``root``, with debug_stage3_synth.yml's train block (``train``
    overrides keys of it)."""
    train_opt = dict(options.load(DEBUG_CFG)['train'])
    if not perceptual:
        train_opt.pop('perceptual_opt')
    if not with_d:
        for key in ('gan_type', 'gan_weight', 'grad_penalty_weight'):
            train_opt.pop(key)
    train_opt.update(train)
    opt = {
        'name': 'parity', 'is_train': True,
        'model_type': 'RefRestorationModel', 'scale': 4, 'crop_border': 4,
        'manual_seed': 0,
        'datasets': {'train': {
            'name': 'synth', 'phase': 'train', 'scale': 4,
            'type': 'RefCUFEDDataset', 'gt_size': gt, 'use_flip': False,
            'use_rot': False, 'dataroot_in': osp.join(root, 'input'),
            'dataroot_ref': osp.join(root, 'ref'),
            'io_backend': {'type': 'disk'},
            'ann_file': osp.join(root, 'pairs.txt'), 'batch_size': 2}},
        'network_g': {'type': 'RestorationNet', 'ngf': 16, 'n_blocks': 2,
                      'groups': 8},
        'network_map': {'type': 'CorrespondenceGenerationArch',
                        'patch_size': 3, 'stride': 1,
                        'vgg_layer_list': ['relu1_1', 'relu2_1', 'relu3_1'],
                        'vgg_type': 'vgg19'},
        'network_extractor': {'type': 'ContrasExtractorSep'},
        'path': {'models': osp.join(out, 'models'),
                 'training_state': osp.join(out, 'training_state')},
        'train': train_opt,
        'logger': {'print_freq': 1, 'save_checkpoint_freq': 1000},
    }
    if with_d:
        opt['network_d'] = {'type': 'ImageDiscriminator', 'in_nc': 3,
                            'ndf': 4}
    return dict_to_nonedict(opt)


def batch(opt, n=2):
    """The first ``n`` train items of the JAX dataset, collated."""
    ds = JaxDataset(copy.deepcopy(opt['datasets']['train']))
    return default_collate([ds[i] for i in range(n)])


def recorder(tx):
    """``tx`` whose state also holds the gradient of its last update."""

    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def install_recorders(model):
    """Wrap the JAX model's optimizers in ``recorder`` (before its steps
    trace) and start them afresh."""
    model.tx_g = recorder(model.tx_g)
    reset_optimizers(model)
    if model.net_d is not None:
        model.tx_d = recorder(model.tx_d)
        model.opt_state_d = model.tx_d.init(model.vars_d['params'])
        if model.net_g_pretrain_steps:
            from c2matching_tpu.models.base_model import shift_schedule_count
            model.opt_state_d = shift_schedule_count(
                model.opt_state_d, model.net_g_pretrain_steps)


def reset_optimizers(model):
    model.opt_state_g = model.tx_g.init(model.vars_g['params'])


def snapshot(model):
    """The JAX model's variables as numpy trees."""
    out = {'g': jax.device_get(model.vars_g),
           'extractor': jax.device_get(model.vars_extractor),
           'map': jax.device_get(model.vars_map)}
    if model.net_d is not None:
        out['d'] = jax.device_get(model.vars_d)
    if model.vars_perceptual is not None:
        out['perceptual'] = jax.device_get(model.vars_perceptual)
    return out


def port_model(opt, snap):
    """The port's model on the CPU with the JAX variables ``snap``."""
    model = RefRestorationModel(opt, 'cpu')
    model.net_g.load_state_dict(weights.restoration_net_state_dict(snap['g']))
    model.net_extractor.load_state_dict(
        weights.contras_extractor_state_dict(snap['extractor']))
    model.net_map.load_state_dict(
        weights.corres_generation_state_dict(snap['map']))
    if 'd' in snap:
        model.net_d.load_state_dict(weights.discriminator_state_dict(
            snap['d']))
    if 'perceptual' in snap:
        model.cri_perceptual.load_state_dict(
            weights.corres_generation_state_dict(snap['perceptual']))
    return model


def close(got, want, rel=REL, what=''):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= rel * scale, (f'{what}: max |diff| {err:.3g} > {rel:g} x '
                                f'{scale:.3g}')
    return err / max(scale, 1e-30)


def close_g_grads(net, want_state, what):
    """Every G gradient within 1e-4 of G's largest gradient, and within
    1e-3 of its own largest: float32 sums in other orders agree to ~1e-6
    of each leaf on most leaves, and to a few 1e-4 on the relu1-scale
    DynAgg's (measured 3.2e-4, on its bias), whose outputs include values
    within the two sides' float32 disagreement (~1e-6) of zero, where the
    leaky ReLU after it takes the other slope on one side."""
    top = max(float(np.abs(np.asarray(v)).max()) for v in want_state.values())
    for name, p in net.named_parameters():
        want = np.asarray(want_state[name], np.float64)
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= REL * top, f'{what} grad {name}: {err:.3g} vs {top:.3g}'
        close(p.grad, want, 10 * REL, f'{what} grad {name}')


def pre_bn_bias(name):
    """A D conv bias that a train-mode BN follows: its gradient is zero in
    exact arithmetic (BN removes any shift), so both sides' float gradients
    are rounding noise."""
    return name.startswith('conv_block') and name.endswith(('.0.bias',
                                                            '.3.bias'))


def close_d_grads(named_params, want):
    """D's parameter gradients against ``want`` (a state dict of
    gradients): each within 1e-4 of its own largest magnitude, the pre-BN
    biases within 1e-4 of D's largest gradient."""
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name, p in named_params:
        if pre_bn_bias(name):
            err = (p.grad - torch.as_tensor(np.asarray(want[name]))).abs()
            assert float(err.max()) <= REL * top, name
        else:
            close(p.grad, want[name], REL, f'd grad {name}')


def close_deltas(net, before, want_after, grads, lr_of, what):
    """Parameter deltas of one Adam step against JAX's, where |g| is above
    1e-3 of the leaf's largest gradient and above 1e-6: there the sign of
    g, which sets Adam's first step lr * g / (|g| + eps), is the same on
    both sides (the gradients agree to 1e-3 of each leaf's largest; below
    that either sign may come out), and |g| is 100 times Adam's eps of
    1e-8 (nearer eps the step still moves with the gradients' last
    digits: the zero-initialised conv_offset_mask's gradients at the
    relu3 scale are all below 1e-7). Held to 1e-2 of the LR."""
    n_held = 0
    for name, p in net.named_parameters():
        g = np.abs(np.asarray(grads[name]))
        held = (g > 1e-3 * g.max()) & (g > 1e-6)
        d_port = p.detach().numpy() - before[name].numpy()
        d_jax = np.asarray(want_after[name]) - before[name].numpy()
        lr = lr_of(name)
        err = np.abs(d_port - d_jax)[held]
        assert err.size == 0 or err.max() <= 1e-2 * lr, (
            f'{what} delta {name}: max |diff| {err.max():.3g} on '
            f'{held.sum()} held elements (lr {lr:g})')
        n_held += int(held.sum())
    assert n_held > 0


def torch_state(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}
