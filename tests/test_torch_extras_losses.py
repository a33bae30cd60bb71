"""The port's remaining losses against the JAX package's, on the CPU, on the
same VGG weights (``utils/weights.py``).

- ``MaskedTVLoss`` with and without a mask;
- the ``GANLoss`` class for each type, both sides of D;
- ``GradientPenaltyLoss`` with an explicit alpha, on a small analytic D
  written on both sides, and its generator draw;
- ``PerceptualLoss`` with ``use_input_norm: false`` and
  ``PerceptualLossMultiInputs`` (perceptual and style terms);
- ``TextureLoss`` with and without ``use_weights`` (the JAX side under
  64-bit types: its normaliser overflows int32 above width 6);
- ``MapLoss`` under l1, l2 and fro.

Tolerance 1e-5 of the value (f32 sums in other orders; the VGG losses
reduce features of O(1)-O(10)); and each VGG loss's gradient with respect
to its input at 1e-4 of the largest magnitude.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2matching_tpu.models import losses as jl
from c2matching_tpu_torch.models import losses as tl
from c2matching_tpu_torch.utils import weights

TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _float(v):
    return float(v.detach()) if isinstance(v, torch.Tensor) else float(v)


def _rel(got, want, tol=TOL):
    got, want = _float(got), _float(want)
    assert abs(got - want) <= tol * max(1.0, abs(want)), (got, want)


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GRAD_TOL * np.abs(want).max())


def _vgg_variables(module, *args):
    """The flax loss's VGG params drawn with numpy (its init traced for the
    shapes only): He-normal kernels and N(0, 0.02) biases."""
    shapes = jax.eval_shape(functools.partial(module.init),
                            jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(7)

    def draw(path, leaf):
        if path[-1].key == 'kernel':
            std = np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
            return (std * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.02 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _load_vgg(module, variables, use_input_norm=True):
    state = weights.corres_generation_state_dict(
        {'vgg': variables['params']['vgg']})
    if not use_input_norm:
        state = {k: v for k, v in state.items()
                 if k not in ('vgg.mean', 'vgg.std')}
    module.load_state_dict(state, strict=True)
    return module


def _img(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize('masked', [False, True])
def test_masked_tv_loss(masked):
    pred = _img(0, 2, 9, 7, 3)
    mask = (_img(1, 2, 9, 7, 1) > 0.3).astype(np.float32) if masked else None
    want = jl.MaskedTVLoss(loss_weight=0.5)(
        jnp.asarray(pred), None if mask is None else jnp.asarray(mask))
    got = tl.MaskedTVLoss(loss_weight=0.5)(
        _t(pred), None if mask is None else _t(mask))
    _rel(got, want)


@pytest.mark.parametrize('gan_type', ['vanilla', 'lsgan', 'wgan', 'hinge'])
def test_gan_loss_class(gan_type):
    pred = np.random.RandomState(2).randn(4, 1, 1, 1).astype(np.float32)
    jloss = jl.GANLoss(gan_type, real_label_val=0.9, loss_weight=0.3)
    tloss = tl.GANLoss(gan_type, real_label_val=0.9, loss_weight=0.3)
    for real in (True, False):
        for is_disc in (True, False):
            _rel(tloss(_t(pred), real, is_disc),
                 jloss(jnp.asarray(pred), real, is_disc))


def test_gradient_penalty_loss_class():
    rng = np.random.RandomState(3)
    real = rng.rand(3, 6, 5, 3).astype(np.float32)
    fake = rng.rand(3, 6, 5, 3).astype(np.float32)
    alpha = rng.rand(3, 1, 1, 1).astype(np.float32)
    w = rng.randn(3, 4).astype(np.float32)

    def jdisc(x):
        return jnp.mean(jnp.tanh(x @ jnp.asarray(w)) ** 2, axis=(1, 2, 3))

    def tdisc(x):
        return (torch.tanh(x @ _t(w)) ** 2).mean(dim=(1, 2, 3))

    want = jl.gradient_penalty_loss(jdisc, jnp.asarray(real),
                                    jnp.asarray(fake), None,
                                    loss_weight=10.0, alpha=jnp.asarray(alpha))
    gp = tl.GradientPenaltyLoss(loss_weight=10.0)
    _rel(gp(tdisc, _t(real), _t(fake), alpha=_t(alpha)), want)
    # the draw: uniform per sample from the generator, on the CPU
    got = gp(tdisc, _t(real), _t(fake),
             generator=torch.Generator().manual_seed(5))
    drawn = torch.rand((3, 1, 1, 1),
                       generator=torch.Generator().manual_seed(5))
    _rel(got, gp(tdisc, _t(real), _t(fake), alpha=drawn), 0)


def _perceptual_pair(cls, opts, x_shape):
    jloss = getattr(jl, cls)(**opts)
    x = jnp.zeros(x_shape)
    variables = _vgg_variables(jloss, x, x)
    tloss = getattr(tl, cls)(**opts)
    _load_vgg(tloss, variables, opts.get('use_input_norm', True))
    return jloss, tloss, variables


@pytest.mark.parametrize('cls,shape', [
    ('PerceptualLoss', (2, 16, 12, 3)),
    ('PerceptualLossMultiInputs', (2, 3, 16, 12, 3))])
@pytest.mark.parametrize('criterion', ['l1', 'fro'])
def test_perceptual_losses(cls, shape, criterion):
    opts = dict(layer_weights={'relu1_1': 0.5, 'relu2_1': 1.0},
                use_input_norm=cls != 'PerceptualLoss',
                perceptual_weight=1.0, style_weight=2.0, criterion=criterion)
    jloss, tloss, variables = _perceptual_pair(cls, opts, shape)
    x, gt = _img(4, *shape), _img(5, *shape)

    def jfn(x):
        return jloss.apply(variables, x, jnp.asarray(gt))

    (wp, ws), vjp = jax.vjp(jfn, jnp.asarray(x))
    want_grad, = vjp((jnp.float32(1.0), jnp.float32(1.0)))
    tx = _t(x).requires_grad_(True)
    gp, gs = tloss(tx, _t(gt))
    _rel(gp, wp)
    _rel(gs, ws)
    (gp + gs).backward()
    _grad_close(tx.grad, want_grad)


@pytest.mark.parametrize('use_weights', [False, True])
def test_texture_loss(use_weights):
    b, h, w = 2, 16, 12
    opts = dict(use_weights=use_weights, loss_weight=3.0)
    jloss = jl.TextureLoss(**opts)
    x = _img(6, b, h, w, 3)
    rng = np.random.RandomState(7)
    maps, wts = {}, {}
    for i, (k, c) in enumerate((('relu1_1', 64), ('relu2_1', 128),
                                ('relu3_1', 256))):
        s = 2 ** i
        maps[k] = rng.rand(b, h // s, w // s, c).astype(np.float32)
        wts[k] = rng.rand(b, h // s - 2, w // s - 2, 1).astype(np.float32)
    jmaps = {k: jnp.asarray(v) for k, v in maps.items()}
    jw = {k: jnp.asarray(v) for k, v in wts.items()}
    # the JAX loss's normaliser (W^2 div)^2 is a Python int past int32 at
    # any width above 6: it raises OverflowError under JAX's default 32-bit
    # types, so the JAX side runs with 64-bit types on (the computation
    # stays float32: the inputs and parameters are)
    with jax.enable_x64(True):
        variables = _vgg_variables(jloss, jnp.asarray(x), jmaps, jw)
        want, vjp = jax.vjp(lambda x: jloss.apply(variables, x, jmaps, jw),
                            jnp.asarray(x))
        want_grad, = vjp(jnp.float32(1.0))
    assert want.dtype == jnp.float32
    tloss = _load_vgg(tl.TextureLoss(**opts), variables)
    tx = _t(x).requires_grad_(True)
    got = tloss(tx, {k: _t(v) for k, v in maps.items()},
                {k: _t(v) for k, v in wts.items()})
    _rel(got, want)
    got.backward()
    _grad_close(tx.grad, want_grad)


@pytest.mark.parametrize('criterion', ['l1', 'l2', 'fro'])
def test_map_loss(criterion):
    b, h, w = 2, 16, 12
    jloss = jl.MapLoss(criterion=criterion, map_weight=0.7)
    gt = _img(8, b, h, w, 3)
    rng = np.random.RandomState(9)
    feats = {k: rng.rand(b, h // s, w // s, c).astype(np.float32)
             for k, s, c in (('relu1_1', 1, 64), ('relu2_1', 2, 128),
                             ('relu3_1', 4, 256))}
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = _vgg_variables(jloss, jfeats, jnp.asarray(gt))
    tloss = _load_vgg(tl.MapLoss(criterion=criterion, map_weight=0.7),
                      variables)
    want, vjp = jax.vjp(lambda f: jloss.apply(variables, f, jnp.asarray(gt)),
                        jfeats)
    want_grads, = vjp(jnp.float32(1.0))
    tfeats = {k: _t(v).requires_grad_(True) for k, v in feats.items()}
    got = tloss(tfeats, _t(gt))
    _rel(got, want)
    got.backward()
    for k, t in tfeats.items():
        _grad_close(t.grad, want_grads[k])
    with pytest.raises(NotImplementedError):
        tl.MapLoss(criterion='l3')
