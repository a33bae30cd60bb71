"""The port's stage-3 losses and LR schedules against the JAX package's.

Pixel and GAN losses on the same numpy inputs; the WGAN gradient penalty
with a pinned alpha on an ImageDiscriminator whose JAX weights and batch
statistics are bridged by ``utils/weights.py``
(``discriminator_state_dict``), its value and D's parameter gradients
(grad of grad); D's train-mode forward and its running-statistics update
(flax's biased variance); ``PerceptualLoss`` (fro, relu5_1) on the JAX
loss's seeded VGG19, its value and its input gradient; and every schedule
against ``build_schedule`` over steps 0-300, across milestones, restarts
and warmup. Tolerance rel 1e-4 of each quantity's largest magnitude
(float32 sums in other orders); the schedules to 1e-6, and 1e-7 of the
base LR near the cosine's floor (the JAX package evaluates them in
float32). The conv biases right before a train-mode BN
have a zero gradient in exact arithmetic (BN removes any shift), so their
float gradients are rounding noise on both sides: they are held to 1e-4 of
D's largest gradient instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2matching_tpu.models import losses as jl
from c2matching_tpu.models.archs.discriminator_arch import \
    ImageDiscriminator as JaxD
from c2matching_tpu.models.lr_scheduler import build_schedule as jax_schedule
from c2matching_tpu_torch.models import losses as tl
from c2matching_tpu_torch.models.archs import ImageDiscriminator
from c2matching_tpu_torch.models.lr_scheduler import build_schedule
from c2matching_tpu_torch.utils import weights
from torch_train_common import close_d_grads

REL = 1e-4


def _close(got, want, rel=REL, what=''):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f'{what}: max |diff| {err:.3g} > {rel:g} x ' \
                               f'{scale:.3g}'


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize('name', ['l1', 'mse', 'charbonnier'])
@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
@pytest.mark.parametrize('weighted', [False, True])
def test_pixel_losses(name, reduction, weighted):
    rng = np.random.RandomState(0)
    pred, target = rng.rand(2, 2, 8, 8, 3).astype(np.float32)
    weight = (rng.rand(2, 8, 8, 1) > 0.3).astype(np.float32) \
        if weighted else None
    jfn = getattr(jl, f'{name}_loss')
    tfn = getattr(tl, f'{name}_loss')
    want = jfn(pred, target, weight, reduction, loss_weight=0.7)
    got = tfn(_t(pred), _t(target), None if weight is None else _t(weight),
              reduction, loss_weight=0.7)
    _close(got, want, what=name)
    cls = {'l1': 'L1Loss', 'mse': 'MSELoss',
           'charbonnier': 'CharbonnierLoss'}[name]
    assert tl.PIXEL_LOSSES[cls](0.7, reduction)(
        _t(pred), _t(target), None if weight is None else _t(weight)
    ).shape == got.shape


@pytest.mark.parametrize('gan_type', ['wgan', 'vanilla', 'lsgan', 'hinge'])
def test_gan_losses(gan_type):
    pred = np.random.RandomState(1).randn(4, 1, 1, 1).astype(np.float32)
    for real in (True, False):
        for is_disc in (True, False):
            want = jl.gan_loss(pred, real, gan_type, loss_weight=0.3,
                               is_disc=is_disc)
            got = tl.gan_loss(_t(pred), real, gan_type, loss_weight=0.3,
                              is_disc=is_disc)
            _close(got, want, what=f'{gan_type} real={real} d={is_disc}')


@pytest.fixture(scope='module')
def disc():
    """A small JAX ImageDiscriminator's variables (random running stats,
    so that loading them shows), and the port's net with them."""
    net = JaxD(in_nc=3, ndf=4)
    variables = jax.jit(lambda k, x: net.init(k, x, train=False))(
        jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.RandomState(2)
    stats = jax.tree.map(
        lambda a: np.asarray(rng.uniform(0.5, 1.5, a.shape), np.float32),
        jax.device_get(variables['batch_stats']))
    variables = {'params': jax.device_get(variables['params']),
                 'batch_stats': stats}
    port = ImageDiscriminator(3, 4)
    port.load_state_dict(weights.discriminator_state_dict(variables))
    return net, variables, port


def test_discriminator_forward_and_stats(disc):
    net, variables, port = disc
    x = np.random.RandomState(4).rand(3, 64, 64, 3).astype(np.float32)
    want_eval = jax.jit(lambda v, x: net.apply(v, x, train=False))(
        variables, x)
    port.eval()
    _close(port(_t(x)).detach(), want_eval, what='eval forward')
    want, state = jax.jit(lambda v, x: net.apply(
        v, x, train=True, mutable=['batch_stats']))(variables, x)
    port.train()
    got = port(_t(x))
    _close(got.detach(), want, what='train forward')
    sd = port.state_dict()
    for i in range(1, 6):
        for j, idx in ((1, 1), (2, 4)):
            leaf = state['batch_stats'][f'block{i}_bn{j}']
            _close(sd[f'conv_block{i}.{idx}.running_mean'], leaf['mean'],
                   what=f'block{i} bn{j} mean')
            _close(sd[f'conv_block{i}.{idx}.running_var'], leaf['var'],
                   what=f'block{i} bn{j} var')
    port.load_state_dict(weights.discriminator_state_dict(variables))
    port(_t(x), update_stats=False)
    assert torch.equal(port.state_dict()['conv_block3.4.running_var'],
                       _t(variables['batch_stats']['block3_bn2']['var']))


def test_gradient_penalty_with_pinned_alpha(disc):
    net, variables, port = disc
    rng = np.random.RandomState(5)
    real, fake = rng.rand(2, 3, 64, 64, 3).astype(np.float32)
    alpha = rng.rand(3, 1, 1, 1).astype(np.float32)

    def jax_gp(params):
        def disc_fn(x):
            out, _ = net.apply({'params': params,
                                'batch_stats': variables['batch_stats']},
                               x, train=True, mutable=['batch_stats'])
            return out
        return jl.gradient_penalty_loss(disc_fn, real, fake, None,
                                        loss_weight=10.0, alpha=alpha)

    want, want_grads = jax.jit(jax.value_and_grad(jax_gp))(
        variables['params'])
    port.load_state_dict(weights.discriminator_state_dict(variables))
    port.train().zero_grad()
    got = tl.gradient_penalty_loss(
        lambda x: port(x, update_stats=False), _t(real), _t(fake), _t(alpha),
        loss_weight=10.0)
    got.backward()
    _close(got.detach(), want, what='gp')
    close_d_grads(port.named_parameters(), weights.discriminator_state_dict(
        {'params': want_grads, 'batch_stats': variables['batch_stats']}))
    # the penalty's D pass moved no running statistic
    assert torch.equal(port.state_dict()['conv_block1.1.running_mean'],
                       _t(variables['batch_stats']['block1_bn1']['mean']))


def test_perceptual_loss_fro_relu5(monkeypatch):
    """PerceptualLoss(fro, relu5_1) on the JAX loss's seeded VGG19
    (PRNGKey(11), as the JAX model inits it): the value and the gradient
    on the restored image."""
    opt = {'layer_weights': {'relu5_1': 1}, 'vgg_type': 'vgg19',
           'use_input_norm': True, 'perceptual_weight': 1e-4,
           'style_weight': 0, 'norm_img': False, 'criterion': 'fro'}
    jloss = jl.PerceptualLoss(**opt)
    jvars = jax.jit(jloss.init)(jax.random.PRNGKey(11),
                                jnp.zeros((1, 64, 64, 3)),
                                jnp.zeros((1, 64, 64, 3)))
    rng = np.random.RandomState(6)
    x, gt = rng.rand(2, 2, 48, 48, 3).astype(np.float32)

    def jfn(x):
        return jloss.apply(jvars, x, gt)[0]

    want, want_grad = jax.jit(jax.value_and_grad(jfn))(x)
    port = tl.PerceptualLoss(**opt)
    port.load_state_dict(weights.corres_generation_state_dict(
        jax.device_get(jvars)))
    xt = _t(x).requires_grad_(True)
    got, style = port(xt, _t(gt))
    assert style is None
    got.backward()
    _close(got.detach(), want, what='percep')
    _close(xt.grad, want_grad, what='percep grad')
    assert all(p.grad is None for p in port.parameters())


SCHEDULES = {
    'multistep': {'lr_scheme': 'MultiStepLR', 'lr_steps': [50, 120, 120, 250],
                  'lr_gamma': 0.5},
    'multistep_restarts': {'lr_scheme': 'MultiStepRestartLR',
                           'lr_steps': [40, 100, 180, 260], 'lr_gamma': 0.1,
                           'restarts': [100, 200],
                           'restart_weights': [0.5, 0.25]},
    'multistep_warmup': {'lr_scheme': 'MultiStepLR', 'lr_steps': [30, 200],
                         'lr_gamma': 0.1, 'warmup_iter': 60},
    'cosine_restarts': {'lr_scheme': 'CosineAnnealingRestartLR',
                        'period': [80, 100, 150], 'restarts': [80, 180],
                        'restart_weights': [1, 0.5], 'eta_min': 1e-7},
    'cosine_warmup': {'lr_scheme': 'CosineAnnealingRestartLR',
                      'period': [300], 'eta_min': 1e-6, 'warmup_iter': 25},
}


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedules_match_jax(name):
    train_opt = SCHEDULES[name]
    jfn = jax.jit(jax_schedule(train_opt), static_argnums=1)
    fn = build_schedule(train_opt)
    for base in (1e-4, 3e-6):
        want = np.array([float(jfn(s, base)) for s in range(301)])
        got = np.array([fn(s, base) for s in range(301)])
        # float32 rounding of terms of the size of the base LR
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * base,
                                   err_msg=name)
