"""``dtype: bfloat16`` on every network block, held against the JAX
package's blocks with the same key.

In both packages ``dtype`` is the compute dtype of a block's convs:
parameters stay float32, each conv casts its input, weight and bias, and
the DCN's offsets and mask stay float32. Each block is built through the
options factory of its package (``define_network`` and the JAX
``networks._instantiate``) from a block that names ``dtype: bfloat16``,
runs on the CPU on the same weights and inputs, and must land within
BF16_REL of the JAX block's output (of its largest magnitude): both round
to bf16 at every conv, in orders and with bias roundings of their own
(measured: 5e-3 on the restoration net's residual, 2e-6 on the
contrastive features, 3e-3 on the VGG19 features). The restoration net's
distance from the float32 JAX block, far above the 1e-6 at which float32
blocks agree, shows the dtype takes effect.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c2matching_tpu.models import networks as jax_networks
from c2matching_tpu_torch.models import RefRestorationModel, define_network
from c2matching_tpu_torch.ops.resize import upscale
from c2matching_tpu_torch.utils import weights

from test_torch_archs import (_crop, _images, _np_tree, _restoration_inputs,
                              _t, _zero_bands, _zero_padded)

BF16_REL = 2 ** -5   # ~4 bf16 roundings (2^-8 each) of O(1) activations,
                     # compounded over a few conv layers
BF16 = {'dtype': 'bfloat16'}


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


def _both(block):
    """The port's and the JAX package's network for one YAML block."""
    return define_network(block), jax_networks._instantiate(block)


RESTORATION = {'type': 'RestorationNet', 'ngf': 16, 'n_blocks': 2,
               'groups': 8}


@pytest.fixture(scope='module')
def restoration_params():
    """RestorationNet flax params with a non-zero conv_offset_mask (zero at
    init), so that the learned offsets and the mask take part."""
    x, pre, feat = _restoration_inputs(8, 1)
    jnet = jax_networks._instantiate(RESTORATION)
    params = _np_tree(jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jax.tree.map(jnp.asarray, pre),
        jax.tree.map(jnp.asarray, feat))['params'])
    rng = np.random.RandomState(5)
    for scale in ('small', 'medium', 'large'):
        com = params['dyn_agg_restore'][f'{scale}_dyn_agg'][
            'conv_offset_mask']
        com['kernel'] = (0.05 * rng.randn(*com['kernel'].shape)).astype(
            np.float32)
    return params


@pytest.mark.parametrize('valid', [None, (6, 5)])
def test_restoration_net_bf16(valid, restoration_params):
    """Held on the restored residual (output minus the f32 bilinear base,
    which both add last), of O(0.1) at this init. With ``valid`` the port
    runs on the exact 6 x 5 inputs, held against the JAX package's run on
    the zero-padded 8 x 8 ones with ``valid_shape``, cut to the valid
    region."""
    params = restoration_params
    x, pre, feat = _restoration_inputs(8, 1)
    exact = (x, pre, feat) if valid is None else _crop(x, pre, feat, valid)
    padded = (x, pre, feat) if valid is None else _zero_bands(x, pre, feat,
                                                              valid)
    jx = (jnp.asarray(padded[0]), jax.tree.map(jnp.asarray, padded[1]),
          jax.tree.map(jnp.asarray, padded[2]))
    net, jnet = _both(dict(RESTORATION, **BF16))
    jnet_f32 = jax_networks._instantiate(RESTORATION)
    base = upscale(_t(exact[0]), 4, 'bilinear').numpy()

    def residual(module):
        fn = jax.jit(lambda p, *a: module.apply({'params': p}, *a, valid))
        out = np.asarray(fn(params, *jx))
        return out[:, :base.shape[1], :base.shape[2]] - base

    want, want_f32 = residual(jnet), residual(jnet_f32)
    net.load_state_dict(weights.restoration_net_state_dict(params),
                        strict=True)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    with torch.no_grad():
        got = net(_t(exact[0]), {k: _t(v) for k, v in exact[1].items()},
                  {k: _t(v) for k, v in exact[2].items()})
    assert got.dtype == torch.float32 and got.shape == base.shape
    err = _rel_err(got.numpy() - base, want)
    assert err <= BF16_REL, err
    # f32 blocks agree to ~1e-6 (test_torch_archs.py); bf16 ones do not
    assert _rel_err(got.numpy() - base, want_f32) > 1e-4


@pytest.mark.parametrize('valid', [None, (28, 20)])
def test_contras_extractor_bf16(valid):
    """With ``valid`` the port runs on the exact 28 x 20 images, the JAX
    package on the zero-padded 32 x 32 ones, cut to the valid 7 x 5."""
    img1, img2 = _images(0, 1, 32, 32, 3), _images(1, 1, 32, 32, 3)
    vh, vw = (32, 32) if valid is None else valid
    net, jnet = _both({'type': 'ContrasExtractorSep', **BF16})
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(img1),
                          jnp.asarray(img2))
    want = jnet.apply(variables, jnp.asarray(_zero_padded(img1, (vh, vw))),
                      jnp.asarray(_zero_padded(img2, (vh, vw))), valid)
    net.load_state_dict(weights.contras_extractor_state_dict(
        _np_tree(variables)), strict=True)
    with torch.no_grad():
        got = net(_t(img1[:, :vh, :vw]), _t(img2[:, :vh, :vw]))
    for key in ('dense_features1', 'dense_features2'):
        assert got[key].dtype == torch.bfloat16
        assert want[key].dtype == jnp.bfloat16
        err = _rel_err(got[key].float(),
                       np.asarray(want[key].astype(jnp.float32))[
                           :, :vh // 4, :vw // 4])
        assert err <= BF16_REL, (key, err)


def test_correspondence_generation_bf16():
    """The VGG19 computes in bf16; the matching runs on the extractor's
    f32 features, so the offsets are equal."""
    rng = np.random.RandomState(3)
    feats = {k: rng.randn(1, 8, 8, 256).astype(np.float32)
             for k in ('dense_features1', 'dense_features2')}
    ref = _images(4, 1, 32, 32, 3)
    block = {'type': 'CorrespondenceGenerationArch', 'patch_size': 3,
             'stride': 1, 'vgg_layer_list': ['relu1_1', 'relu2_1',
                                             'relu3_1'],
             'vgg_type': 'vgg19', **BF16}
    net, jnet = _both(block)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = jnet.init(jax.random.PRNGKey(1), jfeats, jnp.asarray(ref))
    want_pre, want_feat = jnet.apply(variables, jfeats, jnp.asarray(ref))
    net.load_state_dict(weights.corres_generation_state_dict(
        _np_tree(variables)), strict=True)
    with torch.no_grad():
        pre, feat = net({k: _t(v) for k, v in feats.items()}, _t(ref))
    for key in ('relu1_1', 'relu2_1', 'relu3_1'):
        np.testing.assert_array_equal(pre[key].numpy(),
                                      np.asarray(want_pre[key]))
        assert feat[key].dtype == torch.bfloat16
        err = _rel_err(feat[key].float(), want_feat[key])
        assert err <= BF16_REL, (key, err)


def test_model_with_bf16_blocks_runs():
    """An options dict with ``dtype: bfloat16`` on all three blocks builds
    and serves a request (fault: the port used to refuse the key)."""
    opt = {
        'network_g': {'type': 'RestorationNet', 'ngf': 16, 'n_blocks': 2,
                      'groups': 8, **BF16},
        'network_map': {'type': 'CorrespondenceGenerationArch',
                        'patch_size': 3, 'stride': 1,
                        'vgg_layer_list': ['relu1_1', 'relu2_1', 'relu3_1'],
                        'vgg_type': 'vgg19', **BF16},
        'network_extractor': {'type': 'ContrasExtractorSep', **BF16},
    }
    model = RefRestorationModel(opt, 'cpu')
    img = _images(5, 1, 36, 44, 3)
    model.feed_data({'img_in_lq': img[:, ::4, ::4], 'img_in_up': img,
                     'img_ref': np.roll(img, 3, axis=1)})
    model.test()
    out = model.cropped_output()
    assert out.shape == (1, 36, 44, 3) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
