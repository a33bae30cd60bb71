"""The port's ``SRModel`` against the JAX package's, on the CPU.

- ``test_x8`` against JAX's ``SRModel.test_x8`` on a non-square input
  through a net with no dihedral symmetry (a x2 nearest upsample and a
  random 3x3 conv, as ``tests/test_sr_x8.py`` builds it), at 1e-6; and
  ``test`` alike.
- ``val: use_x8: true`` through the validation loop: the PSNR of the
  ensemble's image (JAX's ``tensor2img`` and ``psnr`` on JAX's
  ensemble), not the plain forward's.
- One ``optimize_parameters`` step (pixel and perceptual terms, Adam with
  ``beta_g`` and ``weight_decay_g``) against JAX's jitted step on the same
  weights: the logs at 1e-5, the parameters after the step at 1e-3 of
  the step size (the first Adam step is lr * g / (|g| + eps)).
- ``create_model`` builds it from ``model_type: SRModel``, and
  ``RefRestorationModel`` gives the same image with ``use_x8`` set as
  without it, as the JAX one does.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from c2matching_tpu.models import base_model as jbase
from c2matching_tpu.models import sr_model as jsr
from c2matching_tpu.utils import metrics as jmetrics
from c2matching_tpu.utils import util as jutil
from c2matching_tpu_torch.models import MODELS, create_model
from c2matching_tpu_torch.models import archs as tarchs
from c2matching_tpu_torch.models.sr_model import SRModel
from c2matching_tpu_torch.utils import weights

LR = 1e-3


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class _JaxTinySR(nn.Module):
    """2x nearest upsample + a 3x3 conv."""

    @nn.compact
    def __call__(self, x):
        b, h, w, c = x.shape
        up = jnp.broadcast_to(x[:, :, None, :, None, :],
                              (b, h, 2, w, 2, c)).reshape(b, 2 * h, 2 * w, c)
        return nn.Conv(3, (3, 3), name='conv')(up)


class TinySR(torch.nn.Module):
    """The same net in the port's NHWC convention."""

    def __init__(self, generator=None):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 3, 3, padding=1)

    def forward(self, x):
        up = x.repeat_interleave(2, 1).repeat_interleave(2, 2)
        return F.conv2d(up.permute(0, 3, 1, 2), self.conv.weight,
                        self.conv.bias, padding=1).permute(0, 2, 3, 1)


@pytest.fixture
def tiny(monkeypatch):
    """JAX's tiny net's params, and TinySR registered in the port's
    ARCHS for ``define_network``."""
    monkeypatch.setitem(tarchs.ARCHS, 'TinySR', TinySR)
    params = jax.device_get(_JaxTinySR().init(
        jax.random.PRNGKey(7), jnp.zeros((1, 6, 10, 3)))['params'])
    return jax.tree.map(np.asarray, params)


def _state(params):
    out = {}
    weights._conv(out, 'conv', params['conv'])
    return out


def _opt(train=None, val=None):
    opt = {'model_type': 'SRModel', 'is_train': train is not None,
           'network_g': {'type': 'TinySR'}, 'crop_border': 2,
           'path': {}, 'manual_seed': 0}
    if train is not None:
        opt['train'] = train
    if val is not None:
        opt['val'] = val
    return opt


def _port(opt, params):
    model = create_model(opt, device='cpu')
    model.net_g.load_state_dict(_state(params), strict=True)
    return model


def _jax_model(opt, params):
    model = jsr.SRModel.__new__(jsr.SRModel)
    jbase.BaseModel.__init__(model, opt)
    model.net_g = _JaxTinySR()
    model.vars_g = {'params': jax.tree.map(jnp.asarray, params)}
    return model


def test_x8_and_test(tiny):
    lq = np.random.RandomState(1).rand(2, 6, 10, 3).astype(np.float32)
    jmodel = _jax_model(_opt(), tiny)
    jmodel.batch = {'img_in_lq': jnp.asarray(lq)}
    model = _port(_opt(), tiny)
    assert type(model) is SRModel and MODELS['SRModel'] is SRModel
    model.feed_data({'img_in_lq': lq})
    for name in ('test_x8', 'test'):
        getattr(jmodel, name)()
        getattr(model, name)()
        assert model.output.shape == (2, 12, 20, 3)
        np.testing.assert_allclose(model.output.numpy(),
                                   np.asarray(jmodel.output), rtol=0,
                                   atol=1e-6)
    # the ensemble averages outputs that differ
    jmodel.test_x8()
    x8 = np.asarray(jmodel.output)
    jmodel.test()
    assert np.abs(x8 - np.asarray(jmodel.output)).max() > 1e-3


class _Loader(list):
    """A list of batch-1 items with the loader's ``dataset.opt``."""

    class dataset:
        opt = {'name': 'tiny'}


def test_use_x8_in_validation(tiny):
    rng = np.random.RandomState(2)
    items = [{'img_in_lq': rng.rand(1, 6, 10, 3).astype(np.float32),
              'img_in': rng.rand(1, 12, 20, 3).astype(np.float32),
              'lq_path': [f'im{i}.png']} for i in range(2)]
    jmodel = _jax_model(_opt(), tiny)
    want = {}
    for x8 in (False, True):
        vals = []
        for item in items:
            jmodel.batch = {'img_in_lq': jnp.asarray(item['img_in_lq'])}
            jmodel.test_x8() if x8 else jmodel.test()
            sr = jutil.tensor2img(np.asarray(jmodel.output))
            gt = jutil.tensor2img(item['img_in'])
            vals.append(jmetrics.psnr(sr, gt, crop_border=2))
        want[x8] = np.mean(vals)
    for x8 in (False, True):
        model = _port(_opt(val={'use_x8': x8}), tiny)
        got = model.nondist_validation(_Loader(items), 0, None)
        assert set(got) == {'psnr'}
        assert abs(got['psnr'] - want[x8]) < 1e-6, (got, want)
    assert abs(want[True] - want[False]) > 1e-3


def test_optimize_parameters_step(tiny):
    train = {'lr_g': LR, 'beta_g': [0.8, 0.95], 'weight_decay_g': 1e-3,
             'lr_scheme': 'MultiStepLR', 'lr_steps': [5], 'lr_gamma': 0.5,
             'pixel_criterion': 'L1Loss', 'pixel_weight': 1.0,
             'perceptual_opt': {'layer_weights': {'relu1_1': 1.0},
                                'perceptual_weight': 0.1,
                                'style_weight': 0.5, 'criterion': 'l1'}}
    rng = np.random.RandomState(3)
    batch = {'img_in_lq': rng.rand(2, 6, 10, 3).astype(np.float32),
             'img_in': rng.rand(2, 12, 20, 3).astype(np.float32)}
    jmodel = _jax_model(_opt(train), tiny)
    jmodel.init_training_settings()
    model = _port(_opt(train), tiny)
    model.cri_perceptual.load_state_dict(weights.corres_generation_state_dict(
        {'vgg': jax.device_get(jmodel.vars_perceptual)['params']['vgg']}),
        strict=True)
    jmodel.batch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel.optimize_parameters(1)
    model.feed_data(batch)
    model.optimize_parameters(1)
    assert set(model.log_dict) == set(jmodel.log_dict) == {
        'l_pix', 'l_percep', 'l_style'}
    for k, v in jmodel.log_dict.items():
        want = float(v)
        assert abs(float(model.log_dict[k]) - want) <= 1e-5 * max(1, want), k
    after = _state(jax.tree.map(np.asarray, jax.device_get(
        jmodel.vars_g['params'])))
    before = _state(tiny)
    for name, p in model.net_g.named_parameters():
        got = p.detach() - before[name]
        want = after[name] - before[name]
        assert want.abs().max() > 0.5 * LR
        assert (got - want).abs().max() <= 1e-3 * LR, name
    assert model.current_learning_rates(1) == [LR]


def test_ref_restoration_ignores_use_x8():
    rng = np.random.RandomState(4)
    item = {'img_in_lq': rng.rand(1, 8, 8, 3).astype(np.float32),
            'img_in_up': rng.rand(1, 32, 32, 3).astype(np.float32),
            'img_ref': rng.rand(1, 32, 32, 3).astype(np.float32),
            'img_in': rng.rand(1, 32, 32, 3).astype(np.float32)}
    images = []
    for x8 in (False, True):
        opt = {'model_type': 'RefRestorationModel', 'is_train': False,
               'network_g': {'type': 'RestorationNet', 'ngf': 16,
                             'n_blocks': 1, 'groups': 8},
               'network_map': {'type': 'CorrespondenceGenerationArch',
                               'patch_size': 3, 'stride': 1,
                               'vgg_layer_list': ['relu3_1', 'relu2_1',
                                                  'relu1_1'],
                               'vgg_type': 'vgg19'},
               'network_extractor': {'type': 'ContrasExtractorSep'},
               'crop_border': 0, 'val': {'use_x8': x8}}
        model = create_model(opt, device='cpu')
        images.append(model._validation_images(item)[0])
    np.testing.assert_array_equal(images[0], images[1])
