"""The port's main path against the JAX package's, end to end.

The port's RefRestorationModel (feed_data / test / cropped_output) runs
against the JAX chain ContrasExtractorSep -> CorrespondenceGenerationArch ->
RestorationNet on the same weights (converted by utils.weights) and the
same numpy images: on the JAX package's 16-LR-pixel bucket, and off it at
even and odd sizes, which the port runs at their own shape while the JAX
chain pads them to the bucket (as its model's feed_data does, passing
``valid_shape``) and is cut back to the valid region; and with the bf16
serving knobs on both sides. The match indices are held equal first.
"""
from importlib import import_module

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c2matching_tpu.models import archs as jax_archs
from c2matching_tpu_torch.models import RefRestorationModel
from c2matching_tpu_torch.ops.patch_match import batched_patch_match
from c2matching_tpu_torch.utils import weights

jax_pm = import_module('c2matching_tpu.ops.patch_match')

NGF, N_BLOCKS = 16, 2
BUCKET = 16     # the JAX package's LR bucket


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.fixture(scope='module')
def params():
    """Flax params of the three nets; conv_offset_mask (zero at init) is
    made non-zero so that the learned offsets and the mask take part."""
    rng = jax.random.PRNGKey(0)
    hr = jnp.zeros((1, 32, 32, 3))
    ext = jax_archs.ContrasExtractorSep()
    ext_vars = jax.jit(ext.init)(rng, hr, hr)
    feats = jax.jit(ext.apply)(ext_vars, hr, hr)
    cg_vars = jax.jit(jax_archs.CorrespondenceGenerationArch().init)(
        rng, feats, hr)
    lr, s = jnp.zeros((1, 8, 8, 3)), 8
    pre = {k: jnp.zeros((1, 9, s * f, s * f, 2))
           for k, f in (('relu3_1', 1), ('relu2_1', 2), ('relu1_1', 4))}
    rf = {k: jnp.zeros((1, s * f, s * f, c))
          for k, f, c in (('relu3_1', 1, 256), ('relu2_1', 2, 128),
                          ('relu1_1', 4, 64))}
    g = jax_archs.RestorationNet(ngf=NGF, n_blocks=N_BLOCKS, groups=8)
    g_params = _np_tree(jax.jit(g.init)(rng, lr, pre, rf)['params'])
    r = np.random.RandomState(5)
    for scale in ('small', 'medium', 'large'):
        com = g_params['dyn_agg_restore'][f'{scale}_dyn_agg'][
            'conv_offset_mask']
        com['kernel'] = (0.05 * r.randn(*com['kernel'].shape)).astype(
            np.float32)
        com['bias'] = (0.1 * r.randn(*com['bias'].shape)).astype(np.float32)
    return {'ext': _np_tree(ext_vars), 'cg': _np_tree(cg_vars),
            'g': g_params}


def _request(seed, h, w):
    """A smooth random HR image (4h x 4w), its x4 LR, a slightly noisy copy
    as the upsampled LR, and a shifted copy as the reference, so that the
    matches are well separated."""
    rng = np.random.RandomState(seed)
    gt = rng.rand(4 * h, 4 * w, 3).astype(np.float32)
    for shift in ((1, 0), (0, 1), (2, 0), (0, 2)):
        gt = gt + np.roll(gt, shift, (0, 1))
    gt = gt / gt.max()
    lq = gt.reshape(h, 4, w, 4, 3).mean(axis=(1, 3))
    up = np.clip(gt + 0.02 * rng.randn(*gt.shape), 0, 1).astype(np.float32)
    ref = np.roll(gt, (5, 3), (0, 1))
    return {'img_in_lq': lq[None], 'img_in_up': up[None],
            'img_ref': ref[None]}


def _to_bucket(x, mult):
    """Zero-pad NHWC bottom/right up to a multiple of ``mult``."""
    h, w = x.shape[1:3]
    return np.pad(x, ((0, 0), (0, (-h) % mult), (0, (-w) % mult), (0, 0)))


def _jax_chain(p, batch, match_dtype=None, gather_dtype=None):
    """The JAX chain on the batch padded to the bucket with its valid
    sizes, as the JAX model's feed_data and test run it: the match indices
    on the valid (h-2) x (w-2) query grid, read on that grid, and the
    output cut to (4h, 4w)."""
    ext = jax_archs.ContrasExtractorSep()
    cg = jax_archs.CorrespondenceGenerationArch(match_dtype=match_dtype)
    g = jax_archs.RestorationNet(ngf=NGF, n_blocks=N_BLOCKS, groups=8,
                                 gather_dtype=gather_dtype)
    h, w = batch['img_in_lq'].shape[1:3]
    vs_lr = None if not (h % BUCKET or w % BUCKET) else (h, w)
    vs_hr = None if vs_lr is None else (4 * h, 4 * w)
    up = jnp.asarray(_to_bucket(batch['img_in_up'], 4 * BUCKET))
    ref = jnp.asarray(_to_bucket(batch['img_ref'], 4 * BUCKET))
    lq = jnp.asarray(_to_bucket(batch['img_in_lq'], BUCKET))
    feats = ext.apply(p['ext'], up, ref, vs_hr)
    idx, _ = jax_pm.batched_patch_match(
        feats['dense_features1'], feats['dense_features2'],
        compute_dtype=match_dtype, valid_shape=vs_lr)
    pre, rf = cg.apply(p['cg'], feats, ref, vs_hr)
    out = g.apply({'params': p['g']}, lq, pre, rf, vs_lr)
    idx = np.asarray(idx)
    width = idx.shape[2]
    idx = idx[:, :h - 2, :w - 2]
    return ((idx // width) * (w - 2) + idx % width,
            np.asarray(out)[:, :4 * h, :4 * w])


def _port(p, batch, match_dtype=None, gather_dtype=None):
    blocks = {
        'network_g': {'type': 'RestorationNet', 'ngf': NGF,
                      'n_blocks': N_BLOCKS, 'groups': 8,
                      'gather_dtype': gather_dtype},
        'network_map': {'type': 'CorrespondenceGenerationArch',
                        'patch_size': 3, 'stride': 1,
                        'vgg_layer_list': ['relu1_1', 'relu2_1', 'relu3_1'],
                        'vgg_type': 'vgg19', 'match_dtype': match_dtype},
        'network_extractor': {'type': 'ContrasExtractorSep'},
    }
    model = RefRestorationModel(blocks, 'cpu', torch.Generator().manual_seed(0))
    model.net_extractor.load_state_dict(
        weights.contras_extractor_state_dict(p['ext']), strict=True)
    model.net_map.load_state_dict(
        weights.corres_generation_state_dict(p['cg']), strict=True)
    model.net_g.load_state_dict(weights.restoration_net_state_dict(p['g']),
                                strict=True)
    model.feed_data(batch)
    model.test()
    out = model.cropped_output().numpy()
    with torch.no_grad():
        feats = model.net_extractor(model.batch['img_in_up'],
                                    model.batch['img_ref'])
        idx, _ = batched_patch_match(
            feats['dense_features1'], feats['dense_features2'],
            compute_dtype=match_dtype)
    return model, idx.numpy(), out


@pytest.mark.parametrize('lr_shape', [(16, 16), (14, 11), (13, 9), (17, 15)],
                         ids=['on_bucket', 'off_bucket', 'odd_13x9',
                              'odd_17x15'])
def test_main_path_matches_jax(params, lr_shape):
    """f32 config. The port runs LR 14x11, 13x9 and 17x15 at their own
    shape, JAX padded to 16x16 (32x32) and cut back. f32 convs in XLA:CPU
    and torch sum in other orders, so outputs agree to 1e-4 (values of
    O(1))."""
    h, w = lr_shape
    batch = _request(0, h, w)
    want_idx, want = _jax_chain(params, batch)
    model, idx, got = _port(params, batch)
    assert tuple(model.batch['img_in_lq'].shape) == (1, h, w, 3)
    assert idx.shape == want_idx.shape == (1, h - 2, w - 2)
    np.testing.assert_array_equal(idx, want_idx)
    assert got.shape == want.shape == (1, 4 * h, 4 * w, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_serving_knobs_match_jax(params):
    """gather_dtype and match_dtype bf16 on both sides. The matches stay
    equal (bf16 products are exact; only the f32 summation order differs,
    and these images have no near-tie). The DCN samples round to bf16 at
    other points in the two packages: JAX rounds each corner product, the
    port each summed column. bf16 moves the output by about 8e-4 from the
    f32 config on either side (more than 2e-4 is asserted), so the two
    must agree well inside that: 1e-4, the f32 bound."""
    batch = _request(1, 16, 16)
    want_idx, want = _jax_chain(params, batch, 'bfloat16', 'bfloat16')
    _, idx, got = _port(params, batch, 'bfloat16', 'bfloat16')
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    _, _, f32 = _port(params, batch)
    assert np.abs(got - f32).max() > 2e-4   # the knob really acts
