"""The port's networks against the JAX package's on the same weights.

Flax parameters from ``init`` go through c2matching_tpu_torch.utils.weights
into the port's modules (load_state_dict strict=True); both sides then
run the same numpy inputs. The same converted dicts, saved as a .pth, must
come back through the JAX package's pth_import bit for bit.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c2matching_tpu.models import archs as jax_archs
from c2matching_tpu.utils import pth_import
from c2matching_tpu_torch.models import archs
from c2matching_tpu_torch.utils import weights

REPO = pathlib.Path(__file__).resolve().parents[1]
# f32 convs in XLA:CPU and in torch sum in different orders; activations
# are of O(1) to O(10) after a few layers of random weights
CONV_TOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _images(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.fixture(scope='module')
def restoration():
    """RestorationNet(ngf 16, 2 blocks) and its flax params, with a non-zero
    conv_offset_mask (zero at init), so that the learned offsets and the
    mask take part."""
    net = jax_archs.RestorationNet(ngf=16, n_blocks=2, groups=8)
    pre, feat = _restoration_inputs(4, 0)[1:]
    params = _np_tree(jax.jit(net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 3)),
        jax.tree.map(jnp.asarray, pre),
        jax.tree.map(jnp.asarray, feat))['params'])
    rng = np.random.RandomState(5)
    for scale in ('small', 'medium', 'large'):
        com = params['dyn_agg_restore'][f'{scale}_dyn_agg']['conv_offset_mask']
        com['kernel'] = (0.05 * rng.randn(*com['kernel'].shape)).astype(
            np.float32)
        com['bias'] = (0.1 * rng.randn(*com['bias'].shape)).astype(np.float32)
    return net, params


def _restoration_inputs(h, seed, b=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, h, h, 3).astype(np.float32)
    pre, feat = {}, {}
    for i, (key, ch) in enumerate((('relu3_1', 256), ('relu2_1', 128),
                                   ('relu1_1', 64))):
        s = h * 2 ** i
        pre[key] = rng.randint(-3, 4, (b, 9, s, s, 2)).astype(np.float32)
        feat[key] = rng.randn(b, s, s, ch).astype(np.float32)
    return x, pre, feat


def _zero_padded(img, valid):
    """``img`` (B, H, W, C) with the rows and columns past ``valid`` zero,
    as the JAX package's feed_data pads a batch to its bucket."""
    out = np.zeros_like(img)
    out[:, :valid[0], :valid[1]] = img[:, :valid[0], :valid[1]]
    return out


@pytest.mark.parametrize('valid', [None, (28, 20)])
def test_contras_extractor_matches_jax(valid):
    """With ``valid`` the port runs on the exact 28 x 20 images, the JAX
    package on the zero-padded 32 x 32 ones with ``valid_shape``, its
    features cut to the valid 7 x 5."""
    img1, img2 = _images(0, 2, 32, 32, 3), _images(1, 2, 32, 32, 3)
    vh, vw = (32, 32) if valid is None else valid
    jnet = jax_archs.ContrasExtractorSep()
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(img1),
                          jnp.asarray(img2))
    want = jnet.apply(variables, jnp.asarray(_zero_padded(img1, (vh, vw))),
                      jnp.asarray(_zero_padded(img2, (vh, vw))), valid)
    net = archs.ContrasExtractorSep()
    net.load_state_dict(weights.contras_extractor_state_dict(
        _np_tree(variables)), strict=True)
    with torch.no_grad():
        got = net(_t(img1[:, :vh, :vw]), _t(img2[:, :vh, :vw]))
    for key in ('dense_features1', 'dense_features2'):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key])[:, :vh // 4, :vw // 4],
            rtol=CONV_TOL, atol=CONV_TOL)


@pytest.mark.parametrize('valid', [None, (28, 20)])
def test_vgg_feature_extractor_matches_jax(valid):
    """As the contrastive extractor: each layer cut to the valid sizes at
    its scale."""
    img = _images(2, 1, 32, 32, 3)
    vh, vw = (32, 32) if valid is None else valid
    layers = ['relu1_1', 'relu2_1', 'relu3_1']
    jnet = jax_archs.VGGFeatureExtractor(layer_name_list=layers)
    variables = jnet.init(jax.random.PRNGKey(1), jnp.asarray(img))
    want = jnet.apply(variables, jnp.asarray(_zero_padded(img, (vh, vw))),
                      valid)
    net = archs.VGGFeatureExtractor(layer_name_list=layers)
    state = weights.corres_generation_state_dict(
        {'vgg': _np_tree(variables)['params']})
    net.load_state_dict({k[len('vgg.'):]: v for k, v in state.items()},
                        strict=True)
    with torch.no_grad():
        got = net(_t(img[:, :vh, :vw]))
    assert set(got) == set(layers)
    for key, f in zip(layers, (1, 2, 4)):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key])[:, :vh // f, :vw // f],
            rtol=CONV_TOL, atol=CONV_TOL)


SCALE = {'relu3_1': 1, 'relu2_1': 2, 'relu1_1': 4}


def _crop(x, pre, feat, valid):
    """The inputs cut to the LR sizes ``valid`` (the relu2 and relu1
    inputs at twice and four times them)."""
    vh, vw = valid
    return (x[:, :vh, :vw],
            {k: v[:, :, :vh * SCALE[k], :vw * SCALE[k]]
             for k, v in pre.items()},
            {k: v[:, :vh * SCALE[k], :vw * SCALE[k]]
             for k, v in feat.items()})


def _zero_bands(x, pre, feat, valid):
    """The inputs with zeros past the LR sizes ``valid`` (the relu2 and
    relu1 inputs past twice and four times them): a batch as the JAX
    package pads it to its bucket."""
    vh, vw = valid
    return (_zero_padded(x, valid),
            {k: np.pad(v[:, :, :vh * SCALE[k], :vw * SCALE[k]],
                       ((0, 0), (0, 0), (0, v.shape[2] - vh * SCALE[k]),
                        (0, v.shape[3] - vw * SCALE[k]), (0, 0)))
             for k, v in pre.items()},
            {k: _zero_padded(v, (vh * SCALE[k], vw * SCALE[k]))
             for k, v in feat.items()})


@pytest.mark.parametrize('valid', [None, (6, 5)])
def test_restoration_net_matches_jax(valid, restoration):
    """With ``valid`` the port runs on the exact 6 x 5 inputs, the JAX
    package on the zero-padded 8 x 8 ones with ``valid_shape``, cut to the
    valid 24 x 20; its offset means are those of the padded run's
    ``conv_offset_mask`` outputs over the valid region (captured: the
    padded grid's own mean counts the pad bands, which are no part of the
    exact run)."""
    jnet, params = restoration
    x, pre, feat = _restoration_inputs(8, 1)
    padded = (x, pre, feat) if valid is None else _zero_bands(x, pre, feat,
                                                              valid)
    exact = (x, pre, feat) if valid is None else _crop(x, pre, feat, valid)
    want, aux = jnet.apply({'params': params}, jnp.asarray(padded[0]),
                           jax.tree.map(jnp.asarray, padded[1]),
                           jax.tree.map(jnp.asarray, padded[2]), valid,
                           mutable=['intermediates'],
                           capture_intermediates=valid is not None)
    net = archs.RestorationNet(ngf=16, n_blocks=2, groups=8)
    net.load_state_dict(weights.restoration_net_state_dict(params),
                        strict=True)
    with torch.no_grad():
        got = net(_t(exact[0]), {k: _t(v) for k, v in exact[1].items()},
                  {k: _t(v) for k, v in exact[2].items()})
    assert got.shape == (1, 4 * exact[0].shape[1], 4 * exact[0].shape[2], 3)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want)[:, :got.shape[1], :got.shape[2]],
        rtol=0, atol=CONV_TOL)
    stats = net.dyn_agg_restore.offset_stats()
    sown = aux['intermediates']['dyn_agg_restore']
    for scale, f in (('small', 1), ('medium', 2), ('large', 4)):
        want_mean = float(sown[f'{scale}_dyn_agg']['offset_absmean'][0])
        if valid is not None:
            o = np.asarray(sown[f'{scale}_dyn_agg']['conv_offset_mask'][
                '__call__'][0], np.float64)
            want_mean = float(np.abs(o[:, :valid[0] * f, :valid[1] * f,
                                       :2 * 8 * 9]).mean())
        assert want_mean > 0.1   # the learned offsets really take part
        # a mean of conv outputs that agree to CONV_TOL
        np.testing.assert_allclose(float(stats[f'offset_absmean_{scale}']),
                                   want_mean, rtol=0, atol=CONV_TOL)


def _bridge_cases(g_params):
    rng = jax.random.PRNGKey(2)
    img = jnp.zeros((1, 16, 16, 3))
    ext = jax_archs.ContrasExtractorSep()
    ext_vars = ext.init(rng, img, img)
    cg = jax_archs.CorrespondenceGenerationArch()
    cg_vars = cg.init(rng, ext.apply(ext_vars, img, img), img)
    return {
        'restoration': (g_params, weights.restoration_net_state_dict,
                        lambda p: pth_import.import_restoration_net(
                            p, n_blocks=2),
                        lambda: archs.RestorationNet(ngf=16, n_blocks=2)),
        'contras': (_np_tree(ext_vars)['params'],
                    weights.contras_extractor_state_dict,
                    pth_import.import_contras_extractor,
                    archs.ContrasExtractorSep),
        'corres': (_np_tree(cg_vars)['params'],
                   weights.corres_generation_state_dict,
                   pth_import.import_corres_generation,
                   archs.CorrespondenceGenerationArch),
    }


@pytest.mark.parametrize('name', ['restoration', 'contras', 'corres'])
def test_weight_bridge_round_trips_through_pth_import(name, tmp_path,
                                                      restoration):
    """flax params -> the port's state dict -> torch.save -> pth_import
    gives every leaf back bit for bit, and the port's module loads the
    dict strictly."""
    params, to_state, import_fn, make_net = _bridge_cases(
        restoration[1])[name]
    state = to_state(params)
    make_net().load_state_dict(state, strict=True)
    path = str(tmp_path / f'{name}.pth')
    torch.save(state, path)
    back = import_fn(path)['params']
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_back)
    for path_, leaf in flat_in:
        got = flat_back[path_]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, path_
        assert np.array_equal(got, leaf), path_


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node, node.module or ''


def test_port_imports_no_jax():
    """The port and chip_smoke.py import no jax, flax or c2matching_tpu,
    and triton, if used, only inside a function."""
    files = sorted((REPO / 'c2matching_tpu_torch').rglob('*.py'))
    files.append(REPO / 'chip_smoke.py')
    assert len(files) > 10
    banned = ('jax', 'jaxlib', 'flax', 'optax', 'c2matching_tpu')
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        in_functions = {id(n) for f in ast.walk(tree)
                        if isinstance(f, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        for n in ast.walk(f)}
        for node, name in _imports(tree):
            root = name.split('.')[0]
            assert root not in banned, f'{path}: imports {name}'
            if root == 'triton':
                assert id(node) in in_functions, \
                    f'{path}: imports triton outside a function'
