"""The port runs every request at its own shape; the JAX package pads a
batch to its 16-LR-pixel bucket and masks the pad bands, and its contract
is that the padded run, cut to the valid region, is the exact-shape run.

On LR inputs off the bucket in rows, in columns, in both, and at odd
sizes (float32, the DynAggs' offset convs made non-zero so that the
learned offsets take part; weights the JAX package's, carried by
``utils/weights.py``):

- the port's ``RestorationNet`` on the exact inputs equals the JAX
  package's on the zero-padded batch with ``valid_shape``, cut to the
  valid region, whether the port gets contiguous inputs or views of a
  batch whose pad bands hold random values (it reads nothing outside its
  crop);
- its offset statistics are the exact-shape run's: the mean |learned
  offset| over the valid region of the JAX package's padded run (its
  ``conv_offset_mask`` outputs, captured), where the zero pad bands make
  the offsets the exact run's;
- through ``RefRestorationModel`` an off-bucket request, an on-bucket
  request and a training step keep the request's shape in ``model.batch``
  and in the output.
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2matching_tpu.models import archs as jax_archs
from c2matching_tpu_torch.models import RefRestorationModel
from c2matching_tpu_torch.models.archs import RestorationNet
from c2matching_tpu_torch.utils import options, weights

REPO = Path(__file__).resolve().parents[1]
SERVING = REPO / 'options' / 'test' / 'test_C2_matching.yml'
TRAIN = REPO / 'options' / 'train' / 'stage3_restoration_mse.yml'
BUCKET = 16                 # the JAX package's LR bucket
# exact LR sizes: off the bucket in rows, in columns, in both, and odd
VALID = {'rows_off': (11, 16), 'cols_off': (16, 13), 'both_off': (11, 13),
         'odd_13x9': (13, 9), 'odd_17x15': (17, 15)}
SCALE = {'relu3_1': 1, 'relu2_1': 2, 'relu1_1': 4}
CHANNELS = {'relu3_1': 256, 'relu2_1': 128, 'relu1_1': 64}
TOL = 1e-4      # f32 convs in XLA:CPU and torch sum in other orders
NGF, N_BLOCKS = 16, 1


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _padded(valid):
    return tuple(-(-v // BUCKET) * BUCKET for v in valid)


def _inputs(valid, seed=0):
    """Exact-size (x, pre-offsets, reference features), numpy."""
    rng = np.random.RandomState(seed)
    vh, vw = valid
    x = rng.rand(2, vh, vw, 3).astype(np.float32)
    pre, feat = {}, {}
    for key, s in SCALE.items():
        pre[key] = rng.randint(-3, 4, (2, 9, vh * s, vw * s, 2)).astype(
            np.float32)
        feat[key] = rng.randn(2, vh * s, vw * s, CHANNELS[key]).astype(
            np.float32)
    return x, pre, feat


def _pad(a, row_axis, hw, fill):
    """``a`` padded bottom/right to ``hw`` along ``row_axis`` and the next,
    with zeros or (``fill`` a RandomState) random values."""
    shape = list(a.shape)
    shape[row_axis:row_axis + 2] = hw
    out = (np.zeros(shape, np.float32) if fill is None else
           fill.randn(*shape).astype(np.float32))
    out[(slice(None),) * row_axis + (slice(0, a.shape[row_axis]),
                                     slice(0, a.shape[row_axis + 1]))] = a
    return out


def _to_bucket(x, pre, feat, valid, fill=None):
    """The inputs padded to the bucket, the relu2 and relu1 inputs to twice
    and four times it."""
    ph, pw = _padded(valid)
    return (_pad(x, 1, (ph, pw), fill),
            {k: _pad(v, 2, (ph * SCALE[k], pw * SCALE[k]), fill)
             for k, v in pre.items()},
            {k: _pad(v, 1, (ph * SCALE[k], pw * SCALE[k]), fill)
             for k, v in feat.items()})


def _views(x, pre, feat, valid):
    """Views of the exact region of a batch whose pad bands are random."""
    vh, vw = valid
    xp, prep, featp = _to_bucket(x, pre, feat, valid,
                                 np.random.RandomState(9))
    return (torch.from_numpy(xp)[:, :vh, :vw],
            {k: torch.from_numpy(v)[:, :, :vh * SCALE[k], :vw * SCALE[k]]
             for k, v in prep.items()},
            {k: torch.from_numpy(v)[:, :vh * SCALE[k], :vw * SCALE[k]]
             for k, v in featp.items()})


@pytest.fixture(scope='module')
def nets():
    """The JAX RestorationNet with its params and the port's on them."""
    jnet = jax_archs.RestorationNet(ngf=NGF, n_blocks=N_BLOCKS, groups=8)
    x, pre, feat = _inputs((4, 4))
    params = jax.tree.map(np.array, jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jax.tree.map(jnp.asarray, pre),
        jax.tree.map(jnp.asarray, feat))['params'])
    rng = np.random.RandomState(5)
    for scale in ('small', 'medium', 'large'):
        com = params['dyn_agg_restore'][f'{scale}_dyn_agg'][
            'conv_offset_mask']
        com['kernel'] = (0.05 * rng.randn(*com['kernel'].shape)).astype(
            np.float32)
        com['bias'] = (0.1 * rng.randn(*com['bias'].shape)).astype(np.float32)
    net = RestorationNet(ngf=NGF, n_blocks=N_BLOCKS, groups=8)
    net.load_state_dict(weights.restoration_net_state_dict(params),
                        strict=True)
    return jnet, params, net.eval()


@pytest.fixture(scope='module')
def jax_runs(nets):
    """{name: (output, offset statistics)} of the JAX package's run on the
    zero-padded batch with ``valid_shape``, each made once."""
    jnet, params, _ = nets
    cache = {}

    def run(name):
        if name not in cache:
            valid = VALID[name]
            x, pre, feat = _to_bucket(*_inputs(valid), valid)
            out, aux = jnet.apply(
                {'params': params}, jnp.asarray(x),
                jax.tree.map(jnp.asarray, pre),
                jax.tree.map(jnp.asarray, feat), valid,
                mutable=['intermediates'], capture_intermediates=True)
            cache[name] = np.asarray(out), _valid_stats(
                aux['intermediates']['dyn_agg_restore'], valid)
        return cache[name]
    return run


def _valid_stats(captured, valid):
    """The mean |learned offset| of each DynAgg over the valid region:
    the first 2 x 8 x 9 channels of its ``conv_offset_mask`` output."""
    out = {}
    for scale, (_, s) in zip(('small', 'medium', 'large'), SCALE.items()):
        o = np.asarray(captured[f'{scale}_dyn_agg']['conv_offset_mask'][
            '__call__'][0], np.float64)
        out[f'offset_absmean_{scale}'] = float(np.abs(
            o[:, :valid[0] * s, :valid[1] * s, :2 * 8 * 9]).mean())
    return out


def _port(nets, x, pre, feat):
    net = nets[2]
    with torch.no_grad():
        out = net(x, pre, feat)
    return out.numpy(), {k: float(v) for k, v in
                         net.dyn_agg_restore.offset_stats().items()}


def _torch(x, pre, feat):
    return (torch.from_numpy(x), {k: torch.from_numpy(v)
                                  for k, v in pre.items()},
            {k: torch.from_numpy(v) for k, v in feat.items()})


@pytest.mark.parametrize('pad', ('zero', 'random'))
@pytest.mark.parametrize('name', list(VALID))
def test_exact_shape_net_equals_jax_padded(nets, jax_runs, name, pad):
    valid = VALID[name]
    vh, vw = valid
    x, pre, feat = _inputs(valid)
    want, _ = jax_runs(name)
    args = _torch(x, pre, feat) if pad == 'zero' else _views(x, pre, feat,
                                                             valid)
    got, _ = _port(nets, *args)
    assert got.shape == (2, 4 * vh, 4 * vw, 3)
    assert want.shape == (2, 4 * _padded(valid)[0], 4 * _padded(valid)[1], 3)
    np.testing.assert_allclose(got, want[:, :4 * vh, :4 * vw], rtol=0,
                               atol=TOL)


@pytest.mark.parametrize('name', list(VALID))
def test_offset_stats_are_the_exact_runs(nets, jax_runs, name):
    """The DynAggs' mean |learned offset| counts the request's pixels, as
    the exact-shape run does."""
    _, want = jax_runs(name)
    _, got = _port(nets, *_torch(*_inputs(VALID[name])))
    assert set(got) == set(want) and len(want) == 3
    for k, v in want.items():
        assert v > 0.1      # the learned offsets really take part
        np.testing.assert_allclose(got[k], v, rtol=0, atol=TOL)


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


@pytest.mark.parametrize('case,hr', [
    ('off_bucket_request', (64, 48)),
    ('on_bucket_request', (64, 64)),
    ('training_step', (64, 64))])
def test_model_keeps_the_request_shape(case, hr):
    train = case == 'training_step'
    model = RefRestorationModel(
        _model_opt(TRAIN if train else SERVING, train), 'cpu')
    batch = _batch(*hr, train)
    model.feed_data(batch)
    assert {k: tuple(v.shape) for k, v in model.batch.items()} == {
        k: tuple(v.shape) for k, v in batch.items()}
    if train:
        model.optimize_parameters(1)
    else:
        model.test()
        assert model.cropped_output() is model.output
    assert model.output.shape == (1, *hr, 3)
