"""``dtype: bfloat16`` on ``network_d`` and on ``perceptual_opt``, held
against the JAX package on the CPU: the discriminator (train mode with
its running statistics, then eval mode on them) and the perceptual loss
(criteria fro, l1 and l2) within 2^-5 of the JAX blocks' largest output,
as ``test_torch_dtype.py`` bounds the other blocks, and one GAN iteration
of the small model of ``torch_train_common`` with both set against the
JAX model's fused step: every log within 2^-5 of its JAX value.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_common as common
from c2matching_tpu.models import create_model as jax_create_model
from c2matching_tpu.models import networks as jax_networks
from c2matching_tpu.models.losses import PerceptualLoss as JaxPerceptual
from c2matching_tpu_torch.models import define_network
from c2matching_tpu_torch.models.losses import PerceptualLoss
from c2matching_tpu_torch.utils import weights

BF16_REL = 2 ** -5   # as tests/test_torch_dtype.py: ~4 bf16 roundings of
                     # O(1) activations, compounded over a few conv layers


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _random_variables(module, *args, **kwargs):
    """Variables of the flax ``module`` drawn with numpy (its init traced
    for the shapes only: an eager or jitted init of a conv stack costs
    tens of seconds of XLA compiles here): conv kernels He-normal, biases
    and BN shifts N(0, 0.02), BN scales N(1, 0.02), running means
    N(0, 0.1) and variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(functools.partial(module.init, **kwargs),
                            jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(7)

    def draw(path, leaf):
        name = path[-1].key
        if name == 'kernel':
            std = np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
            value = std * rng.randn(*leaf.shape)
        elif name == 'scale':
            value = 1 + 0.02 * rng.randn(*leaf.shape)
        elif name == 'var':
            value = rng.uniform(0.5, 1.5, leaf.shape)
        elif name == 'mean':
            value = 0.1 * rng.randn(*leaf.shape)
        else:
            value = 0.02 * rng.randn(*leaf.shape)
        return value.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_discriminator_bf16():
    """Train mode (batch statistics, the running statistics moved in
    float32) and then eval mode (those running statistics) against the
    JAX block; the parameters and statistics stay float32."""
    block = {'type': 'ImageDiscriminator', 'in_nc': 3, 'ndf': 4,
             'dtype': 'bfloat16'}
    net, jnet = define_network(block), jax_networks._instantiate(block)
    rng = np.random.RandomState(0)
    x = rng.rand(3, 64, 64, 3).astype(np.float32)
    x2 = rng.rand(2, 64, 64, 3).astype(np.float32)
    variables = _random_variables(jnet, jnp.asarray(x), train=False)
    want, new_state = jax.jit(functools.partial(
        jnet.apply, train=True, mutable=['batch_stats']))(
            variables, jnp.asarray(x))
    want_eval = jax.jit(functools.partial(jnet.apply, train=False))(
        dict(variables, **new_state), jnp.asarray(x2))
    net.load_state_dict(weights.discriminator_state_dict(_np(variables)),
                        strict=True)
    net.train()
    with torch.no_grad():
        got = net(torch.as_tensor(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel_err(got.float(), want) <= BF16_REL
    stats = weights.discriminator_state_dict(
        _np(dict(variables, **new_state)))
    for name, buf in net.named_buffers():
        if name.endswith(('running_mean', 'running_var')):
            assert buf.dtype == torch.float32
            assert _rel_err(buf, stats[name]) <= BF16_REL, name
    assert all(p.dtype == torch.float32 for p in net.parameters())
    net.eval()
    with torch.no_grad():
        got_eval = net(torch.as_tensor(x2))
    assert _rel_err(got_eval.float(), want_eval) <= BF16_REL


@pytest.mark.parametrize('criterion', ['fro', 'l1', 'l2'])
def test_perceptual_loss_bf16(criterion):
    """The VGG19 in bf16 and the criterion reduced as the JAX loss's
    (float32 accumulation, a bf16 result); a string dtype as
    ``perceptual_opt`` gives it."""
    kwargs = dict(layer_weights={'relu1_1': 0.5, 'relu3_1': 1.0},
                  vgg_type='vgg19', use_input_norm=True,
                  perceptual_weight=1.0, style_weight=1.0, norm_img=False,
                  criterion=criterion, dtype='bfloat16')
    rng = np.random.RandomState(1)
    x, gt = (rng.rand(2, 48, 48, 3).astype(np.float32) for _ in range(2))
    jloss = JaxPerceptual(**kwargs)
    variables = _random_variables(jloss, jnp.asarray(x), jnp.asarray(gt))
    want = jax.jit(jloss.apply)(variables, jnp.asarray(x), jnp.asarray(gt))
    loss = PerceptualLoss(**kwargs)
    loss.load_state_dict(weights.corres_generation_state_dict(
        _np(variables)))
    with torch.no_grad():
        got = loss(torch.as_tensor(x), torch.as_tensor(gt))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert abs(float(g) - float(w)) <= BF16_REL * abs(float(w))


def test_gan_step_bf16_d_and_vgg_matches_jax(tmp_path_factory):
    """One GAN iteration of the small model with ``dtype: bfloat16`` on
    ``network_d`` and ``perceptual_opt``, from the JAX model's variables,
    on the same batch and penalty coefficients: every log within 2^-5 of
    its JAX value."""
    root = common.make_synth(tmp_path_factory.mktemp('synth_bf16'))
    opt = common.small_opt(root, str(tmp_path_factory.mktemp('bf16')),
                           perceptual=True)
    opt['network_d']['dtype'] = 'bfloat16'
    # relu3_1 rather than the debug config's relu5_1: a shallower VGG19,
    # to keep the JAX step's compile inside the file's minute
    opt['train']['perceptual_opt'].update(dtype='bfloat16',
                                          layer_weights={'relu3_1': 1.0})
    jmodel = jax_create_model(opt)
    port = common.port_model(opt, common.snapshot(jmodel))
    batch = common.batch(opt)
    _, key = jax.random.split(jmodel._rng)
    port.gp_alpha = np.asarray(jax.random.uniform(key, (2, 1, 1, 1),
                                                  jnp.float32))
    step = opt['train']['net_g_pretrain_steps'] + 1
    jmodel.feed_data(batch)
    jmodel.optimize_parameters(step)
    port.feed_data(batch)
    port.optimize_parameters(step)
    want = {k: float(v) for k, v in jmodel.log_dict.items()}
    assert set(port.log_dict) == set(want)
    assert port.log_dict['l_d_real'].dtype == torch.bfloat16
    assert port.log_dict['l_g_percep'].dtype == torch.bfloat16
    for k, v in want.items():
        got = float(port.log_dict[k])
        assert abs(got - v) <= BF16_REL * abs(v), (k, got, v)
