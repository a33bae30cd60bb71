"""The generator's valid crop: ``RestorationNet`` on a bucket-padded batch
without a band runs the exact-shape net on the valid crop of its inputs
and zero-pads the result back.

On 16 x 16 LR inputs whose valid sizes are off the bucket in rows, in
columns or in both (float32, the DynAggs' offset convs made non-zero so
that the learned offsets take part):

- the padded call equals the net on the exact crops (``valid_shape=None``)
  on the valid region, and its offset statistics are that run's, whether
  the reference features are zero or random in the pad bands; with zero
  pad bands, as the matcher's VGG leaves them, it also equals the masked
  forward on the padded grid, offset statistics included;
- the output's pad bands are zero;
- ``RestorationNet.valid_crops`` counts the padded call and
  ``masked_forwards`` does not move; through ``RefRestorationModel`` an
  off-bucket request counts one crop, an on-bucket request and a training
  step none.
"""
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from c2matching_tpu_torch.models import RefRestorationModel
from c2matching_tpu_torch.models.archs import RestorationNet
from c2matching_tpu_torch.utils import options

REPO = Path(__file__).resolve().parents[1]
SERVING = REPO / 'options' / 'test' / 'test_C2_matching.yml'
TRAIN = REPO / 'options' / 'train' / 'stage3_restoration_mse.yml'
PADDED = 16                 # LR side of the padded batch: one bucket
VALID = {'rows_off': (11, 16), 'cols_off': (16, 13), 'both_off': (11, 13)}
SCALE = {'relu3_1': 1, 'relu2_1': 2, 'relu1_1': 4}
CHANNELS = {'relu3_1': 256, 'relu2_1': 128, 'relu1_1': 64}
TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope='module')
def net():
    gen = torch.Generator().manual_seed(0)
    model = RestorationNet(ngf=16, n_blocks=1, groups=8, generator=gen)
    with torch.no_grad():
        for scale in ('small', 'medium', 'large'):
            com = getattr(model.dyn_agg_restore,
                          f'{scale}_dyn_agg').conv_offset_mask
            com.weight.normal_(0.0, 0.05, generator=gen)
            com.bias.normal_(0.0, 0.1, generator=gen)
    return model.eval()


def _inputs(valid, pad, seed=0):
    """Padded (x, pre-offsets, reference features); ``pad`` 'zero' zeroes
    the pad bands of x and of the features, as feed_data and the matcher's
    VGG leave them, 'random' leaves random values there."""
    gen = torch.Generator().manual_seed(seed)
    vh, vw = valid
    x = torch.rand(2, PADDED, PADDED, 3, generator=gen)
    pre, feat = {}, {}
    for key, s in SCALE.items():
        side = PADDED * s
        pre[key] = torch.randint(-3, 4, (2, 9, side, side, 2),
                                 generator=gen).float()
        feat[key] = torch.randn(2, side, side, CHANNELS[key], generator=gen)
        if pad == 'zero':
            feat[key][:, vh * s:] = 0
            feat[key][:, :, vw * s:] = 0
    if pad == 'zero':
        x[:, vh:] = 0
        x[:, :, vw:] = 0
    return x, pre, feat


def _crop(x, pre, feat, valid):
    vh, vw = valid
    return (x[:, :vh, :vw],
            {k: v[:, :, :vh * SCALE[k], :vw * SCALE[k]]
             for k, v in pre.items()},
            {k: v[:, :vh * SCALE[k], :vw * SCALE[k]]
             for k, v in feat.items()})


def _stats(model):
    return {k: float(v) for k, v in
            model.dyn_agg_restore.offset_stats().items()}


def _counts():
    return RestorationNet.valid_crops, RestorationNet.masked_forwards


@pytest.mark.parametrize('pad', ('zero', 'random'))
@pytest.mark.parametrize('name', list(VALID))
def test_valid_crop_is_the_exact_shape_net(net, name, pad):
    valid = VALID[name]
    vh, vw = valid
    x, pre, feat = _inputs(valid, pad)
    before = _counts()
    with torch.no_grad():
        got = net(x, pre, feat, valid)
        after = _counts()
        got_stats = _stats(net)
        want = net(*_crop(x, pre, feat, valid))
        want_stats = _stats(net)
    assert after == (before[0] + 1, before[1])
    assert _counts() == after
    assert got.shape == (2, 4 * PADDED, 4 * PADDED, 3)
    assert want.shape == (2, 4 * vh, 4 * vw, 3)
    np.testing.assert_allclose(got[:, :4 * vh, :4 * vw].numpy(),
                               want.numpy(), rtol=0, atol=TOL)
    assert not got[:, 4 * vh:].any() and not got[:, :, 4 * vw:].any()
    assert set(got_stats) == set(want_stats) and len(want_stats) == 3
    for k, v in want_stats.items():
        assert v > 0.1      # the learned offsets really take part
        np.testing.assert_allclose(got_stats[k], v, rtol=1e-6, atol=0)


@pytest.mark.parametrize('name', list(VALID))
def test_valid_crop_is_the_masked_forward(net, name):
    """With zero pad bands the crop gives the masked forward on the padded
    grid (the banded path's arithmetic, here without a band) on the valid
    region, and the same valid-pixel offset statistics."""
    valid = VALID[name]
    vh, vw = valid
    x, pre, feat = _inputs(valid, 'zero', seed=1)
    with torch.no_grad():
        got = net(x, pre, feat, valid)
        got_stats = _stats(net)
        masked = net._forward(x, pre, feat, valid, None)
        masked_stats = _stats(net)
    np.testing.assert_allclose(got[:, :4 * vh, :4 * vw].numpy(),
                               masked[:, :4 * vh, :4 * vw].numpy(), rtol=0,
                               atol=TOL)
    for k, v in masked_stats.items():
        np.testing.assert_allclose(got_stats[k], v, rtol=TOL, atol=0)


def _model_opt(path, train):
    opt = options.load(path)
    out = {k: copy.deepcopy(opt[k]) for k in
           ('network_g', 'network_map', 'network_extractor')}
    out['network_g'].update(ngf=16, n_blocks=1)
    out.update(manual_seed=0, crop_border=None, is_train=train)
    if train:
        out['train'] = copy.deepcopy(opt['train'])
    return out


def _batch(hr_h, hr_w, train, seed=0):
    gen = torch.Generator().manual_seed(seed)
    batch = {'img_in_lq': torch.rand(1, hr_h // 4, hr_w // 4, 3,
                                     generator=gen),
             'img_in_up': torch.rand(1, hr_h, hr_w, 3, generator=gen),
             'img_ref': torch.rand(1, hr_h, hr_w, 3, generator=gen)}
    if train:
        batch['img_in'] = torch.rand(1, hr_h, hr_w, 3, generator=gen)
    return batch


@pytest.mark.parametrize('case,hr,crops', [
    ('off_bucket_request', (64, 48), 1),
    ('on_bucket_request', (64, 64), 0),
    ('training_step', (64, 64), 0)])
def test_model_counts_its_crops(case, hr, crops):
    train = case == 'training_step'
    model = RefRestorationModel(
        _model_opt(TRAIN if train else SERVING, train), 'cpu')
    before = _counts()
    model.feed_data(_batch(*hr, train))
    if train:
        model.optimize_parameters(1)
    else:
        model.test()
        assert model.cropped_output().shape == (1, *hr, 3)
    assert _counts() == (before[0] + crops, before[1])
