"""Banded batch-1 evaluation (``val_spatial_shard``, the port's
``parallel/spatial.py``) at 2, 3 and 4 gloo processes on the CPU
(``tests/torch_dist_child.py``), against one process and against the JAX
package's ``model.test()`` on its 8 CPU devices.

- The tiny eval model of ``tests/test_parallel.py`` (ngf 8, 1 block,
  groups 8; the VGGs as shipped) on the JAX model's weights, carried by
  ``utils/weights.py``, its DynAggs' offset convs made non-zero: at world
  2, 3 and 4 every rank's gathered output is within 1e-5 of one
  process's and within 1e-4 of the JAX package's with and without
  ``val_spatial_shard`` (the tolerance of ``tests/test_parallel.py:140``),
  on an on-bucket HR 64x64 request, an off-bucket HR 56x60 one and an
  HR 20x32 one, which the port runs at their own 16, 14 and 5 LR rows
  and the JAX package pads to 16 and cuts back. The port splits any
  height into bands that differ by a row at most (14 rows at world 4:
  3, 4, 3, 4); the offset statistics are the whole image's. Where the
  bands would be under 2 rows (5 rows at world 3 and 4) every rank
  computes the whole image, and logs it.
- The banded ops, 2 ranks against one process on the same inputs:
  ``exchange_halo``, a Conv2d + residual stack, ``upscale``,
  ``batched_patch_match`` with ``batched_pre_offsets`` (bands of 4 rows,
  of 2, where the last band holds no query row, and of 3 and 4), the
  deformable im2col and conv at padding ``1 - row0``, bit for bit on the
  plain version; ``torch.library.opcheck`` of the im2col operator there.
- ``validation`` at 2 ranks with the option on a 3-image synth set: the
  averages of one process on every rank, each image saved once and
  logged by rank 0 alone; ``python -m c2matching_tpu_torch.test
  --launcher pytorch --device cpu`` at 2 ranks: the images and averages
  of one process.
"""
import json
import logging
import os
import os.path as osp
import re

import jax
import numpy as np
import pytest
import torch

import torch_dist_child as child
from c2matching_tpu.models import create_model as jax_create_model
from c2matching_tpu.utils import dict_to_nonedict as jax_nonedict
from c2matching_tpu_torch import data, parallel
from c2matching_tpu_torch.models import create_model
from c2matching_tpu_torch.parallel import spatial
from c2matching_tpu_torch.scripts import make_synth_dataset as synth
from c2matching_tpu_torch.test import run as run_runner
from c2matching_tpu_torch.utils import dict_to_nonedict, png, weights

REPO = child.REPO
SMOKE = osp.join(REPO, 'options', 'test', 'test_synth_smoke.yml')
REQUESTS = {'on_bucket': (64, 64), 'off_bucket': (56, 60),
            'few_rows': (20, 32)}
WORLDS = (2, 3, 4)
PORT_TOL = 1e-5      # banded vs one process of the port
JAX_TOL = 1e-4       # the port vs the JAX package (f32 convs in XLA:CPU and
                     # torch sum in other orders; values of O(1))
N_VAL, VAL_SIZE = 3, 64


def _request(seed, hr_h, hr_w):
    """A smooth random HR image, its x4 LR, a noisy copy as the upsampled
    LR and a shifted copy as the reference: matches well separated."""
    rng = np.random.RandomState(seed)
    gt = rng.rand(hr_h, hr_w, 3).astype(np.float32)
    for shift in ((1, 0), (0, 1), (2, 0), (0, 2)):
        gt = gt + np.roll(gt, shift, (0, 1))
    gt = gt / gt.max()
    lq = gt.reshape(hr_h // 4, 4, hr_w // 4, 4, 3).mean(axis=(1, 3))
    up = np.clip(gt + 0.02 * rng.randn(*gt.shape), 0, 1).astype(np.float32)
    ref = np.roll(gt, (5, 3), (0, 1))
    return {'img_in_lq': lq[None], 'img_in_up': up[None],
            'img_ref': ref[None], 'img_in': gt[None]}


def _jax_model():
    """The tiny JAX eval model of tests/test_parallel.py."""
    return jax_create_model(jax_nonedict(dict(
        child.SPATIAL_NETS, name='spatial', is_train=False, dist=False,
        scale=4, crop_border=4, model_type='RefRestorationModel',
        val_spatial_shard=False, manual_seed=0,
        path={'models': '.', 'training_state': '.'})))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _val_opt(root, out, spatial_opt=True):
    return {
        'name': 'spatial_val', 'is_train': False,
        'model_type': 'RefRestorationModel', 'scale': 4, 'crop_border': 4,
        'manual_seed': 3, 'val_spatial_shard': spatial_opt,
        'network_g': {'type': 'RestorationNet', 'ngf': 8, 'n_blocks': 1,
                      'groups': 8},
        'network_map': {'type': 'CorrespondenceGenerationArch'},
        'network_extractor': {'type': 'ContrasExtractorSep'},
        'path': {'visualization': f'{out}/visualization'},
        'datasets': {'val': {
            'name': 'synth', 'type': 'RefCUFEDDataset', 'phase': 'val',
            'scale': 4,
            'dataroot_in': f'{root}/input', 'dataroot_ref': f'{root}/ref',
            'io_backend': {'type': 'disk'}, 'bicubic_model': 'PIL',
            'ann_file': f'{root}/pairs.txt'}}}


def _cli_options(root, out):
    """test_synth_smoke.yml at ngf 8, 1 block on the synth set, with
    val_spatial_shard (random init from the default seed, the same in
    every process)."""
    with open(SMOKE) as f:
        text = (f.read().replace('./datasets/synth', root)
                .replace('ngf: 64', 'ngf: 8')
                .replace('n_blocks: 16', 'n_blocks: 1')
                + '\nval_spatial_shard: true\ndist_params:\n'
                  '  backend: gloo\n')
    path = osp.join(out, 'cli.yml')
    with open(path, 'w') as f:
        f.write(text)
    return path


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Every multi-process run, started at once; meanwhile the JAX
    package's outputs and the port's one-process ones."""
    tmp = tmp_path_factory.mktemp('spatial')
    # the JAX model's weights, its offset convs made non-zero so that the
    # learned offsets and the modulation take part
    model_r = _jax_model()
    params = _np_tree(model_r.vars_g['params'])
    r = np.random.RandomState(5)
    for scale in ('small', 'medium', 'large'):
        com = params['dyn_agg_restore'][f'{scale}_dyn_agg'][
            'conv_offset_mask']
        com['kernel'] = (0.05 * r.randn(*com['kernel'].shape)).astype(
            np.float32)
        com['bias'] = (0.1 * r.randn(*com['bias'].shape)).astype(np.float32)
    model_r.vars_g = dict(model_r.vars_g, params=model_r.replicate(params))
    state = {'g': weights.restoration_net_state_dict(params),
             'extractor': weights.contras_extractor_state_dict(
                 _np_tree(model_r.vars_extractor)),
             'map': weights.corres_generation_state_dict(
                 _np_tree(model_r.vars_map))}
    torch.save(state, tmp / 'weights.pt')
    requests = {}
    for i, (name, (h, w)) in enumerate(REQUESTS.items()):
        for k, v in _request(i, h, w).items():
            requests[f'{name}/{k}'] = v
    np.savez(tmp / 'requests.npz', **requests)

    root = str(tmp / 'synth')
    synth.write_dataset(root, n=N_VAL, size=(VAL_SIZE,))
    with open(tmp / 'val.json', 'w') as f:
        json.dump(_val_opt(root, str(tmp / 'val')), f)
    cli = _cli_options(root, str(tmp))

    spatial_args = [str(tmp / 'requests.npz'), str(tmp / 'weights.pt')]
    old_root = os.environ.get('C2MATCHING_ROOT')
    os.environ['C2MATCHING_ROOT'] = str(tmp / 'cli2')
    try:
        wait_cli = child.start([(['-opt', cli, '--device', 'cpu',
                                  '--launcher', 'pytorch'], 2)],
                               script='c2matching_tpu_torch.test')
    finally:
        if old_root is None:
            del os.environ['C2MATCHING_ROOT']
        else:
            os.environ['C2MATCHING_ROOT'] = old_root
    wait = child.start(
        [(['spatial'] + spatial_args + [str(tmp / f'world{n}')], n)
         for n in WORLDS]
        + [(['spatial_units', str(tmp / 'units')], 2),
           (['validate_spatial', str(tmp / 'val.json'),
             str(tmp / 'val_means')], 2)])
    try:
        old = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            jax_out = {}
            for spatial_opt in (False, True):
                # feed_data reads the option at each call
                model_r.opt['val_spatial_shard'] = spatial_opt
                for name in REQUESTS:
                    model_r.feed_data({k.split('/')[1]: v
                                       for k, v in requests.items()
                                       if k.startswith(f'{name}/')})
                    if spatial_opt:   # each image split into 8 bands
                        assert all(
                            s.data.shape[1] == 2 for s in
                            model_r.batch['img_in_lq'].addressable_shards)
                    model_r.test()
                    h, w = REQUESTS[name]
                    jax_out[name, spatial_opt] = np.asarray(
                        jax.device_get(model_r.output))[:, :h, :w]
            one = child.spatial_outputs(child.spatial_model(state),
                                        requests)
            units = {h: child.unit_ops(child.unit_inputs(h))
                     for h in child.UNIT_HEIGHTS}
            val_one = _one_process_validation(root, str(tmp / 'val1'))
            os.environ['C2MATCHING_ROOT'] = str(tmp / 'cli1')
            try:
                cli_one = run_runner(cli, 'cpu')
            finally:
                if old_root is None:
                    del os.environ['C2MATCHING_ROOT']
                else:
                    os.environ['C2MATCHING_ROOT'] = old_root
        finally:
            torch.set_num_threads(old)
        results = wait(150)
        cli_out, = wait_cli(150)
    finally:
        wait.stop()
        wait_cli.stop()
    for out in results + [cli_out]:
        for rc, text in out:
            assert rc == 0, text[-4000:]
    ranks = {n: [torch.load(f'{tmp}/world{n}.rank{r}', weights_only=False)
                 for r in range(n)] for n in WORLDS}
    return {'tmp': tmp, 'jax': jax_out, 'one': one, 'ranks': ranks,
            'texts': dict(zip(WORLDS, results[:3])),
            'units_one': units,
            'units': [torch.load(f'{tmp}/units.rank{r}', weights_only=False)
                      for r in range(2)],
            'val_one': val_one, 'val_text': results[4],
            'cli_one': cli_one, 'cli_text': cli_out}


def _one_process_validation(root, out):
    opt = dict_to_nonedict(_val_opt(root, out))
    model = create_model(opt, 'cpu')
    val_opt = opt['datasets']['val']
    loader = data.create_dataloader(data.create_dataset(val_opt), val_opt)
    return model.validation(loader, 0, None)


def _split(lr, world):
    """The LR band bounds of ``lr`` rows over ``world`` ranks, or None
    where the bands would be under 2 rows."""
    if lr // world < 2:
        return None
    return tuple(k * lr // world for k in range(world + 1))


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', list(REQUESTS))
def test_banded_test_equals_one_process(runs, world, name):
    """Each rank computed its band of the request's own LR rows (rows
    floor(r h / world) on), and holds the whole gathered output; only the
    5-row request at world 3 and 4 is computed whole."""
    want = runs['one'][name]['out']
    assert runs['one'][name]['band'] is None
    h, w = REQUESTS[name]
    assert want.shape == (1, h, w, 3)
    bounds = _split(h // 4, world)
    assert (bounds is None) == (name == 'few_rows' and world > 2)
    for rank, got in enumerate(runs['ranks'][world]):
        band = got[name]['band']
        assert band == (None if bounds is None
                        else parallel.Band(rank, bounds))
        assert got[name]['out'].shape == want.shape
        np.testing.assert_allclose(got[name]['out'], want, rtol=0,
                                   atol=PORT_TOL)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', list(REQUESTS))
@pytest.mark.parametrize('spatial_opt', (True, False),
                         ids=('jax_spatial', 'jax_replicated'))
def test_banded_test_matches_jax(runs, world, name, spatial_opt):
    want = runs['jax'][name, spatial_opt]
    for got in runs['ranks'][world]:
        np.testing.assert_allclose(got[name]['out'], want, rtol=0,
                                   atol=JAX_TOL)


@pytest.mark.parametrize('world', WORLDS)
def test_offset_stats_are_the_whole_images(runs, world):
    """The DynAggs' mean |learned offset|: each band's sum and count,
    all-reduced, against one process's mean."""
    for got in runs['ranks'][world]:
        for name in REQUESTS:
            want = runs['one'][name]['stats']
            assert set(got[name]['stats']) == set(want) and len(want) == 3
            for k, v in want.items():
                assert v > 0
                assert abs(got[name]['stats'][k] - v) <= 1e-6 * v, (k, v)
            if got[name]['band'] is None:
                continue
            stats = got[name]['collectives']
            assert stats['halo_exchanges'] > 0 and stats['halo_bytes'] > 0
            # the reference's features (contrastive, VGG19 x 3) and the
            # output
            assert stats['gathers'] == 5
            assert stats['allreduces'] == 1      # offset statistics


def test_whole_image_where_rows_do_not_split(runs):
    """5 LR rows over 3 and 4 ranks: every rank computes the whole image
    (the JAX package's replicate branch), with the same output, without a
    collective, and logs it once a shape."""
    for world in (3, 4):
        for rank, got in enumerate(runs['ranks'][world]):
            got = got['few_rows']
            assert got['band'] is None
            np.testing.assert_allclose(got['out'],
                                       runs['one']['few_rows']['out'],
                                       rtol=0, atol=PORT_TOL)
            assert not any(got['collectives'].values())
            text = runs['texts'][world][rank][1]
            assert text.count(f'LR height 5 does not split into {world} '
                              'bands') == 1


def test_band_for(caplog):
    assert parallel.band_for(16, 0, 1) is None
    assert parallel.band_for(16, 3, 4) == parallel.Band(3, (0, 4, 8, 12, 16))
    band = parallel.band_for(14, 1, 4)
    assert (band.row0, band.rows, band.total, band.world) == (3, 4, 14, 4)
    assert band.sizes() == [3, 4, 3, 4]
    assert parallel.band_for(32, 1, 2).scaled(4) == parallel.Band(
        1, (0, 64, 128))
    assert parallel.band_for(32, 1, 2).scaled(4).scaled(1 / 2).row0 == 32
    assert parallel.band_for(85, 1, 2).scaled(4).stop == 340
    with pytest.raises(ValueError, match='does not scale'):
        parallel.band_for(16, 1, 8).scaled(1 / 4)
    logger = logging.getLogger('base')
    propagate = logger.propagate
    logger.propagate = True
    try:
        with caplog.at_level(logging.WARNING, logger='base'):
            assert parallel.band_for(16, 0, 16) is None    # bands of 1 row
            assert parallel.band_for(16, 0, 16) is None
            assert parallel.band_for(48, 1, 5).rows == 10  # 9 or 10 rows
            assert parallel.band_for(9, 2, 5) is None      # 1 or 2 rows
    finally:
        logger.propagate = propagate
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 2, lines
    assert 'LR height 16' in lines[0] and 'LR height 9' in lines[1]


def _whole_rows(runs, h, name, rank, scale=1):
    band = parallel.band_for(h, rank, 2).scaled(scale)
    return band, band.take(runs['units_one'][h][name])


@pytest.mark.parametrize('h', child.UNIT_HEIGHTS)
def test_exchange_halo(runs, h):
    """2 rows from above and 1 from below: the whole image's rows around
    the band, zeros past its top and bottom."""
    image = child.unit_inputs(h)['image']
    padded = torch.nn.functional.pad(image, (0, 0, 0, 0, 2, 1))
    for rank in range(2):
        band = parallel.band_for(h, rank, 2)
        got = runs['units'][rank][h]['halo']
        assert torch.equal(got, padded[:, band.row0:band.stop + 3])


@pytest.mark.parametrize('h', child.UNIT_HEIGHTS)
@pytest.mark.parametrize('name,scale', (('convs', 1), ('upscale', 4)))
def test_banded_convs_and_upscale(runs, h, name, scale):
    """A Conv2d and two residual blocks, and the bilinear x4: the band's
    rows of the whole image's result."""
    for rank in range(2):
        _, want = _whole_rows(runs, h, name, rank, scale)
        got = runs['units'][rank][h][name]
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=PORT_TOL)


@pytest.mark.parametrize('h', child.UNIT_HEIGHTS)
def test_banded_patch_match_and_pre_offsets(runs, h):
    """The band's query rows against the whole reference: the indices and
    scores of the whole image's match on those rows, none on a band below
    the last query row, and the band's rows of the pre-offsets at each
    scale."""
    whole = runs['units_one'][h]
    for rank in range(2):
        band = parallel.band_for(h, rank, 2)
        got = runs['units'][rank][h]
        stop = min(band.stop, h - 2)
        assert got['match_idx'].shape[1] == max(0, stop - band.row0)
        assert torch.equal(got['match_idx'],
                           whole['match_idx'][:, band.row0:stop])
        np.testing.assert_allclose(got['match_val'].numpy(),
                                   whole['match_val'][:, band.row0:stop],
                                   rtol=0, atol=1e-6)
        for key, f in (('relu3_1', 1), ('relu2_1', 2), ('relu1_1', 4)):
            b = band.scaled(f)
            assert torch.equal(got[f'pre_{key}'],
                               whole[f'pre_{key}'][:, :, b.row0:b.stop])
    assert runs['units'][1][4]['match_idx'].shape[1] == 0


@pytest.mark.parametrize('h', child.UNIT_HEIGHTS)
def test_banded_deform_conv(runs, h):
    """The deformable im2col at padding 1 - row0 on the whole x gives the
    whole image's columns of the band's pixels bit for bit (the plain
    version), and the conv those rows."""
    whole = runs['units_one'][h]
    for rank in range(2):
        band = parallel.band_for(h, rank, 2)
        got = runs['units'][rank][h]
        w = whole['mdc'].shape[2]
        assert torch.equal(got['cols'],
                           whole['cols'][band.row0 * w:band.stop * w])
        np.testing.assert_allclose(got['mdc'].numpy(),
                                   band.take(whole['mdc']).numpy(), rtol=0,
                                   atol=1e-6)


def test_deform_im2col_operator_at_band_padding():
    """The operator (its fake too) at a band's arguments: output rows
    other than the input's, negative padding."""
    inputs = child.unit_inputs(8)
    band = parallel.band_for(8, 1, 2)
    torch.library.opcheck(torch.ops.c2matching.deform_im2col, (
        inputs['x'][0], band.take(inputs['offset'])[0],
        band.take(inputs['mask'])[0], [3, 3], [1, 1], [1 - band.row0, 1],
        [1, 1]))


def test_spatial_validation_equals_one_process(runs):
    """Every rank walks every image; the averages are one process's on
    every rank; rank 0 alone saves and logs each image."""
    want = runs['val_one']
    assert set(want) == {'psnr', 'psnr_y', 'ssim_y'}
    tmp = runs['tmp']
    for rank in range(2):
        with open(f'{tmp}/val_means.rank{rank}') as f:
            got = json.load(f)
        for k, v in want.items():
            assert abs(got['avgs'][k] - v) <= 1e-6 * abs(v), (rank, k)
        assert len(got['saved']) == (N_VAL if rank == 0 else 0)
        text = runs['val_text'][rank][1]
        assert len(re.findall(r'# img \S+ # PSNR', text)) == (
            N_VAL if rank == 0 else 0)
    saved = os.listdir(f'{tmp}/val/visualization/synth')
    assert len(saved) == N_VAL


def _pngs(out):
    imgs = {}
    for name in sorted(os.listdir(out)):
        with open(osp.join(out, name), 'rb') as f:
            imgs[name] = png.decode(f.read()).astype(np.int16)
    return imgs


def test_test_cli_two_ranks_equals_one_process(runs):
    """``python -m c2matching_tpu_torch.test --launcher pytorch`` at two
    ranks with val_spatial_shard: the PNGs of one process within one uint8
    step, and its averages in the log."""
    tmp = runs['tmp']
    vis = 'results/synth_smoke/visualization/synth'
    two, one = _pngs(tmp / 'cli2' / vis), _pngs(tmp / 'cli1' / vis)
    assert list(two) == list(one) and len(one) == N_VAL
    assert max(int(np.abs(two[k] - one[k]).max()) for k in one) <= 1
    logs = [n for n in os.listdir(tmp / 'cli2' / 'results' / 'synth_smoke')
            if n.endswith('.log')]
    assert len(logs) == 1
    with open(tmp / 'cli2' / 'results' / 'synth_smoke' / logs[0]) as f:
        log = f.read()
    want = runs['cli_one']['synth']
    line = re.search(r'# Validation synth (.*)\.', log).group(1)
    got = dict(re.findall(r'# (\w+): (\S+)', line))
    for k, label in (('psnr', 'PSNR'), ('psnr_y', 'PSNR_Y'),
                     ('ssim_y', 'SSIM_Y')):
        assert abs(float(got[label]) - want[k]) <= 5e-5 * abs(want[k])
    assert len(re.findall(r'# img ', log)) == N_VAL
    rank1 = runs['cli_text'][1][1]
    assert '# img' not in rank1 and 'Validation' not in rank1


def test_stats_reset():
    spatial.stats['halo_exchanges'] += 3
    spatial.reset_stats()
    assert set(spatial.stats.values()) == {0}
