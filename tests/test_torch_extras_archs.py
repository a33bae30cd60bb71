"""The port's off-path blocks against the JAX package's, on the CPU, on the
same weights (``utils/weights.py``).

Tolerances: 1e-4 of the largest magnitude for conv outputs and for every
gradient (f32 sums in other orders; the DCN gradients as
``test_torch_dcn_grad.py`` holds them), 1e-5 for the spectral pair and
the BN running statistics, exact where no arithmetic differs.

- ``SpectralNormConv`` through ``ResidualBlockNoBN(sn=True)``: u and v
  after k train-mode calls, each output, eval leaving them untouched, and
  ``n_power_iterations=0`` reusing the stored pair.
- ``ResidualBlockWithBN`` in train mode (output and running statistics)
  and in eval mode.
- ``Upsample`` at 2, 3 and 4 (5 raises on both sides) and
  ``UpsampleShuffle``.
- ``DCNv2Module``, ``DCN`` (also one group of 128 channels) and
  ``DCNSep``: forward, and the gradients of the weight, the bias,
  ``conv_offset_mask`` and every input against ``jax.grad``, with a
  random ``conv_offset_mask`` (zero at init).
- ``kaiming_scaled_init``'s std against JAX's.
- ``VGGFeatureExtractor`` with ``use_input_norm=False``,
  ``remove_pooling=True`` and ``pooling_stride`` 1; the port's refusal of
  a band with a stride other than 2, and the JAX package's of
  ``valid_shape``.
- ``CorrespondenceGenerationArch(stride=2)`` equal to stride 1 on both
  sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2matching_tpu.models.archs import arch_util as jau
from c2matching_tpu.models.archs import corres_generation_arch as jcorres
from c2matching_tpu.models.archs import dcn_arch as jdcn
from c2matching_tpu.models.archs import vgg_arch as jvgg
from c2matching_tpu_torch.models.archs import arch_util as tau
from c2matching_tpu_torch.models.archs import dcn_arch as tdcn
from c2matching_tpu_torch.models.archs import vgg_arch as tvgg
from c2matching_tpu_torch.models.archs import CorrespondenceGenerationArch
from c2matching_tpu_torch.parallel import Band
from c2matching_tpu_torch.utils import weights

TOL = 1e-4
STATS_TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize('n_iter', [1, 2, 0])
def test_spectral_residual_block(n_iter):
    nf = 8
    x = _x(0, 2, 6, 7, nf)
    jblock = jau.ResidualBlockNoBN(nf=nf, sn=True, n_power_iterations=n_iter)
    variables = _np(jblock.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    # a non-zero bias, so that sn_bias divides it
    rng = np.random.RandomState(1)
    for name in ('conv1', 'conv2'):
        variables['params'][name]['bias'] = 0.3 * rng.randn(nf).astype(
            np.float32)
    block = tau.ResidualBlockNoBN(nf, sn=True, n_power_iterations=n_iter)
    block.load_state_dict(weights.residual_block_state_dict(variables),
                          strict=True)
    stats0 = {k: v.clone() for k, v in block.state_dict().items()}

    # eval: no iteration, nothing stored, on both sides
    block.eval()
    with torch.no_grad():
        _close(block(_t(x)), jblock.apply(variables, jnp.asarray(x)))
    for k, v in block.state_dict().items():
        assert torch.equal(v, stats0[k]), k

    # k train-mode calls advance (u, v) as the mutable apply does
    block.train()
    stats = variables['spectral_stats']
    for step in range(3):
        xs = _x(10 + step, 2, 6, 7, nf)
        want, new = jblock.apply({'params': variables['params'],
                                  'spectral_stats': stats}, jnp.asarray(xs),
                                 mutable=['spectral_stats'])
        stats = _np(new['spectral_stats'])
        got = block(_t(xs))
        _close(got, want)
        for name in ('conv1', 'conv2'):
            ref = weights.residual_block_state_dict(
                {'params': variables['params'], 'spectral_stats': stats})
            for leaf in ('weight_u', 'weight_v'):
                key = f'{name}.{leaf}'
                _close(block.state_dict()[key], ref[key], STATS_TOL)
                if n_iter == 0:
                    assert torch.equal(block.state_dict()[key], stats0[key])


def test_residual_block_with_bn():
    nf = 8
    x = _x(1, 3, 5, 6, nf)
    jblock = jau.ResidualBlockWithBN(nf=nf)
    variables = _np(jblock.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    rng = np.random.RandomState(2)
    for bn in ('bn1', 'bn2'):
        variables['params'][bn]['scale'] += 0.1 * rng.randn(nf).astype(
            np.float32)
        variables['params'][bn]['bias'] += 0.1 * rng.randn(nf).astype(
            np.float32)
        variables['batch_stats'][bn]['mean'] += 0.2 * rng.randn(nf).astype(
            np.float32)
    block = tau.ResidualBlockWithBN(nf)
    block.load_state_dict(weights.residual_block_bn_state_dict(variables),
                          strict=True)
    # train: batch statistics, the running ones moved 0.1 toward them
    want, new = jblock.apply(variables, jnp.asarray(x), train=True,
                             mutable=['batch_stats'])
    block.train()
    _close(block(_t(x)), want)
    new = _np(new['batch_stats'])
    for bn in ('bn1', 'bn2'):
        _close(getattr(block, bn).running_mean, new[bn]['mean'], STATS_TOL)
        _close(getattr(block, bn).running_var, new[bn]['var'], STATS_TOL)
    # eval: the running statistics
    variables['batch_stats'] = new
    block.eval()
    with torch.no_grad():
        _close(block(_t(x)), jblock.apply(variables, jnp.asarray(x),
                                          train=False))


@pytest.mark.parametrize('scale', [2, 3, 4])
def test_upsample(scale):
    nf = 4
    x = _x(scale, 1, 5, 7, nf)
    jnet = jau.Upsample(scale=scale, nf=nf)
    variables = _np(jnet.init(jax.random.PRNGKey(scale), jnp.asarray(x)))
    net = tau.Upsample(scale, nf)
    net.load_state_dict(weights.upsample_state_dict(variables), strict=True)
    with torch.no_grad():
        _close(net(_t(x)), jnet.apply(variables, jnp.asarray(x)))


def test_upsample_refuses_and_shuffle():
    with pytest.raises(ValueError, match='not supported'):
        tau.Upsample(5, 4)
    with pytest.raises(ValueError, match='not supported'):
        jau.Upsample(scale=5, nf=4).init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 4, 4, 4)))
    nf = 4
    x = _x(7, 2, 5, 6, nf)
    jnet = jau.UpsampleShuffle(nf=nf)
    variables = _np(jnet.init(jax.random.PRNGKey(5), jnp.asarray(x)))
    net = tau.UpsampleShuffle(nf)
    net.load_state_dict(weights.upsample_shuffle_state_dict(variables),
                        strict=True)
    with torch.no_grad():
        _close(net(_t(x)), jnet.apply(variables, jnp.asarray(x)))


def test_kaiming_scaled_init_std():
    cin, cout = 64, 256
    want = 0.1 * np.sqrt(2.0 / (9 * cin))
    w = torch.empty(cout, cin, 3, 3)
    tau.kaiming_scaled_init(0.1)(w, torch.Generator().manual_seed(0))
    jw = np.asarray(jau.kaiming_scaled_init(0.1)(jax.random.PRNGKey(0),
                                                 (3, 3, cin, cout)))
    # 147456 draws: the sample std is within 1% of the true one
    assert abs(w.std().item() / want - 1) < 0.01
    assert abs(jw.std() / want - 1) < 0.01
    w0 = torch.empty(8, 4, 3, 3)
    tau.srntt_normal_init(0.02)(w0, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(1)
    assert torch.equal(w0, torch.empty(8, 4, 3, 3).normal_(0, 0.02,
                                                           generator=g))


def _dcn_case(kind, c, co, g):
    """(jax module, torch module, flax variables, inputs) with a random
    conv_offset_mask."""
    rng = np.random.RandomState(c + co + g)
    h, w = 6, 7
    x = rng.randn(2, h, w, c).astype(np.float32)
    if kind == 'DCNv2Module':
        shift = rng.randint(-2, 3, size=(2, h, w, 1, 9, 2))
        offset = (shift + rng.uniform(-0.9, 0.9, size=(2, h, w, g, 9, 2))
                  ).astype(np.float32)
        mask = rng.uniform(0, 1, size=(2, h, w, g, 9)).astype(np.float32)
        inputs = (x, offset, mask)
    elif kind == 'DCN':
        inputs = (x,)
    else:
        inputs = (x, rng.randn(2, h, w, c).astype(np.float32))
    jmod = getattr(jdcn, kind)(channels=c, out_channels=co,
                               deformable_groups=g)
    variables = _np(jmod.init(jax.random.PRNGKey(c),
                              *map(jnp.asarray, inputs)))
    com = variables['params'].get('conv_offset_mask')
    if com is not None:
        com['kernel'] = (0.3 * rng.randn(*com['kernel'].shape)).astype(
            np.float32)
        com['bias'] = (0.5 * rng.randn(*com['bias'].shape)).astype(np.float32)
    variables['params']['bias'] = (0.1 * rng.randn(co)).astype(np.float32)
    tmod = getattr(tdcn, kind)(c, co, g)
    tmod.load_state_dict(weights.dcn_state_dict(variables), strict=True)
    return jmod, tmod, variables, inputs


@pytest.mark.parametrize('kind,c,co,g', [
    ('DCNv2Module', 16, 12, 2), ('DCNv2Module', 8, 6, 1), ('DCN', 16, 8, 2),
    ('DCN', 128, 8, 1), ('DCNSep', 16, 16, 4)])
def test_dcn_modules(kind, c, co, g):
    jmod, tmod, variables, inputs = _dcn_case(kind, c, co, g)
    h, w = inputs[0].shape[1:3]
    cot = np.random.RandomState(9).randn(2, h, w, co).astype(np.float32)

    def loss(params, *args):
        out = jmod.apply({'params': params}, *args)
        return jnp.sum(out * cot), out

    argnums = tuple(range(len(inputs) + 1))
    (_, want), grads = jax.value_and_grad(loss, argnums=argnums,
                                          has_aux=True)(
        variables['params'], *map(jnp.asarray, inputs))
    targs = [_t(a).requires_grad_(True) for a in inputs]
    out = tmod(*targs)
    _close(out, want)
    (out * _t(cot)).sum().backward()
    want_params = weights.dcn_state_dict({'params': _np(grads[0])})
    for name, p in tmod.named_parameters():
        _close(p.grad, want_params[name])
    for t, g_want in zip(targs, grads[1:]):
        _close(t.grad, g_want)


def _vgg_state(params, use_input_norm):
    state = {}
    for name, leaf in params.items():
        state[f'vgg_net.{name}.weight'] = _t(np.transpose(
            np.asarray(leaf['kernel']), (3, 2, 0, 1)))
        state[f'vgg_net.{name}.bias'] = _t(leaf['bias'])
    if use_input_norm:
        state['mean'] = torch.tensor(tvgg.IMAGENET_MEAN).view(1, 3, 1, 1)
        state['std'] = torch.tensor(tvgg.IMAGENET_STD).view(1, 3, 1, 1)
    return state


@pytest.mark.parametrize('opts', [
    dict(use_input_norm=False), dict(remove_pooling=True),
    dict(pooling_stride=1), dict(use_input_norm=False, pooling_stride=1)])
def test_vgg_options(opts):
    img = np.random.RandomState(3).rand(1, 20, 18, 3).astype(np.float32)
    layers = ['relu1_1', 'relu2_1', 'relu3_1']
    jnet = jvgg.VGGFeatureExtractor(layer_name_list=layers, **opts)
    variables = _np(jnet.init(jax.random.PRNGKey(2), jnp.asarray(img)))
    want = jnet.apply(variables, jnp.asarray(img))
    net = tvgg.VGGFeatureExtractor(layers, **opts)
    net.load_state_dict(_vgg_state(variables['params'],
                                   opts.get('use_input_norm', True)),
                        strict=True)
    with torch.no_grad():
        got = net(_t(img))
    for key in layers:
        _close(got[key], want[key])
    if opts.get('pooling_stride', 2) != 2:
        with pytest.raises(NotImplementedError, match='pooling_stride'):
            net(_t(img), band=Band(0, (0, 10, 20)))
        with pytest.raises(NotImplementedError, match='pooling_stride'):
            jnet.apply(variables, jnp.asarray(img), valid_shape=(16, 16))


def test_correspondence_stride_is_ignored():
    rng = np.random.RandomState(4)
    feats = {'dense_features1': rng.randn(1, 8, 6, 16).astype(np.float32),
             'dense_features2': rng.randn(1, 8, 6, 16).astype(np.float32)}
    ref = rng.rand(1, 32, 24, 3).astype(np.float32)
    layers = ['relu1_1']
    # the port: stride 2 builds and gives stride 1's output
    outs = []
    for stride in (1, 2):
        net = CorrespondenceGenerationArch(
            stride=stride, vgg_layer_list=layers,
            generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            outs.append(net({k: _t(v) for k, v in feats.items()}, _t(ref)))
    # the JAX package: the same on the same params
    jouts = []
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = None
    for stride in (1, 2):
        jnet = jcorres.CorrespondenceGenerationArch(stride=stride,
                                                    vgg_layer_list=layers)
        if variables is None:
            variables = jnet.init(jax.random.PRNGKey(0), jfeats,
                                  jnp.asarray(ref))
        jouts.append(jnet.apply(variables, jfeats, jnp.asarray(ref)))
    for (pre_a, feat_a), (pre_b, feat_b) in (outs, jouts):
        for k in pre_a:
            np.testing.assert_array_equal(np.asarray(pre_a[k]),
                                          np.asarray(pre_b[k]))
        for k in feat_a:
            np.testing.assert_array_equal(np.asarray(feat_a[k]),
                                          np.asarray(feat_b[k]))
    # and the port's pre-offsets equal the JAX package's
    for k in outs[0][0]:
        _close(outs[1][0][k], jouts[1][0][k], 0)
