"""The port's data parallelism (``c2matching_tpu_torch/parallel/``) against
the JAX package's, and its distributed validation and serving against one
process (two gloo processes on the CPU, ``tests/torch_dist_child.py``).

- ``shard_batch``, ``pad_batch_to``, the sampler's per-rank split and the
  train loader's per-process batch against ``c2matching_tpu.parallel`` /
  ``c2matching_tpu.data`` on the same numpy inputs; the backend of
  ``dist_params.backend``; world size 1 without a process group.
- ``validation`` at world size 2 (rank r scores every second image, the
  sums and the count all-reduced) equals one process on the whole set at
  1e-12 (``tests/test_parallel.py:143`` holds the JAX package so).
- ``python -m c2matching_tpu_torch.scripts.serve --launcher pytorch
  --device cpu`` at 2 ranks writes the same PNGs as one process (rank r
  writes the flushes r, r + 2, ...), within one uint8 step; they are equal.
"""
import json
import os
import os.path as osp

import jax
import numpy as np
import pytest
import torch

import torch_dist_child
from c2matching_tpu import data as jax_data
from c2matching_tpu.parallel import mesh as jax_mesh
from c2matching_tpu_torch import data, parallel
from c2matching_tpu_torch.models import create_model
from c2matching_tpu_torch.scripts import make_synth_dataset as synth
from c2matching_tpu_torch.utils import dict_to_nonedict, png

REPO = torch_dist_child.REPO
SMOKE = osp.join(REPO, 'options', 'test', 'test_synth_smoke.yml')
N_VAL, SIZE = 5, 64


def _global_batch(n, seed=0):
    rng = np.random.RandomState(seed)
    return {'img_in': rng.rand(n, 8, 6, 3).astype(np.float32),
            'idx': np.arange(n), 'lq_path': [f'{i}.png' for i in range(n)]}


@pytest.mark.parametrize('n', (16, 8))
def test_shard_batch_is_the_mesh_layout(n):
    """Rank r's slice is what the JAX package's sharded batch puts on
    device r of its 8-device mesh."""
    batch = _global_batch(n)
    mesh = jax_mesh.get_mesh()
    world = mesh.devices.size
    sharded = jax_mesh.shard_batch(batch, mesh)
    for key in ('img_in', 'idx'):
        by_device = {s.device: np.asarray(s.data)
                     for s in sharded[key].addressable_shards}
        for rank, device in enumerate(mesh.devices.flat):
            got = parallel.shard_batch(batch, rank, world)
            np.testing.assert_array_equal(got[key], by_device[device])
    assert parallel.shard_batch(batch, 3, world)['lq_path'] is \
        batch['lq_path']


def test_shard_batch_indivisible_takes_the_whole_batch():
    """The JAX package replicates a batch axis that does not divide; the
    port's rank then takes it whole."""
    batch = _global_batch(5)
    sharded = jax_mesh.shard_batch(batch, jax_mesh.get_mesh())
    for s in sharded['img_in'].addressable_shards:
        np.testing.assert_array_equal(np.asarray(s.data), batch['img_in'])
    np.testing.assert_array_equal(
        parallel.shard_batch(batch, 1, 8)['img_in'], batch['img_in'])


@pytest.mark.parametrize('n,to', ((3, 8), (8, 8), (1, 4)))
def test_pad_batch_to_equals_jax(n, to):
    batch = _global_batch(n)
    got, n_got = parallel.pad_batch_to(batch, to)
    want, n_want = jax_mesh.pad_batch_to(batch, to)
    assert n_got == n_want == n
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]))


@pytest.mark.parametrize('size,world,ratio', ((10, 2, 1), (7, 2, 3),
                                               (9, 4, 100), (5, 3, 2)))
def test_sampler_split_equals_jax(size, world, ratio):
    opt = {'dataset_enlarge_ratio': ratio}
    dataset = list(range(size))
    for rank in range(world):
        got = data.create_train_sampler(dataset, opt, world, rank)
        want = jax_data.create_train_sampler(dataset, opt, world, rank)
        assert len(got) == len(want)
        for epoch in (0, 3):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert list(got) == list(want)


def test_loader_batch_is_split_over_processes():
    opt = {'phase': 'train', 'batch_size': 8, 'n_workers': 1}
    dataset = [{'x': np.full((2,), i, np.float32)} for i in range(32)]
    for world in (1, 2, 4):
        sampler = data.create_train_sampler(dataset, opt, world, 0)
        loader = data.create_dataloader(dataset, opt, world, 0, sampler)
        jax_loader = jax_data.create_dataloader(
            dataset, opt, world, 0,
            jax_data.create_train_sampler(dataset, opt, world, 0))
        assert loader.batch_size == jax_loader.batch_size == 8 // world
        assert len(loader) == len(jax_loader)
        first = next(iter(loader))['x']
        assert first.shape == (8 // world, 2)
    with pytest.raises(ValueError, match='per-process batch'):
        data.create_dataloader(dataset, dict(opt, batch_size=1), 2, 0)


def test_backend_and_world_size_one():
    cpu, cuda = torch.device('cpu'), torch.device('cuda')
    assert parallel.backend_for({'dist_params': {'backend': 'ici'}},
                                cuda) == 'nccl'
    assert parallel.backend_for({'dist_params': {'backend': 'ici'}},
                                cpu) == 'gloo'
    assert parallel.backend_for({}, cpu) == 'gloo'
    assert parallel.backend_for({'dist_params': {'backend': 'gloo'}},
                                cuda) == 'gloo'
    with pytest.raises(ValueError, match='CUDA'):
        parallel.backend_for({'dist_params': {'backend': 'nccl'}}, cpu)
    with pytest.raises(ValueError, match='mpi'):
        parallel.backend_for({'dist_params': {'backend': 'mpi'}}, cpu)
    assert parallel.init_distributed({}, 'none', 'cpu') == (0, 1, cpu)
    assert parallel.get_rank() == 0 and parallel.get_world_size() == 1
    values = np.array([1.5, 2.0])
    np.testing.assert_array_equal(
        parallel.allreduce_sum_across_processes(values), values)
    assert jax.process_count() == 1
    np.testing.assert_array_equal(
        jax_mesh.allreduce_sum_across_processes(values), values)
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.)
    parallel.average_gradients([p])
    assert torch.equal(p.grad, torch.full((3,), 2.))
    x = torch.ones(2, requires_grad=True)
    assert parallel.all_reduce_sum(x) is x


def _val_opt(root, out):
    return dict_to_nonedict({
        'name': 'parallel_val', 'is_train': False,
        'model_type': 'RefRestorationModel', 'scale': 4, 'crop_border': 4,
        'manual_seed': 3,
        'network_g': {'type': 'RestorationNet', 'ngf': 16, 'n_blocks': 1,
                      'groups': 8},
        'network_map': {'type': 'CorrespondenceGenerationArch',
                        'vgg_layer_list': ['relu1_1', 'relu2_1', 'relu3_1'],
                        'vgg_type': 'vgg19'},
        'network_extractor': {'type': 'ContrasExtractorSep'},
        'path': {'visualization': f'{out}/visualization'},
        'datasets': {'val': {
            'name': 'synth', 'type': 'RefCUFEDDataset', 'phase': 'val',
            'scale': 4,
            'dataroot_in': f'{root}/input', 'dataroot_ref': f'{root}/ref',
            'io_backend': {'type': 'disk'}, 'bicubic_model': 'PIL',
            'ann_file': f'{root}/pairs.txt'}}})


def _serve_options(root, out):
    """test_synth_smoke.yml at ngf 16, 2 blocks on the synth set (random
    init from the default seed, the same in every process)."""
    with open(SMOKE) as f:
        text = (f.read().replace('./datasets/synth', root)
                .replace('ngf: 64', 'ngf: 16')
                .replace('n_blocks: 16', 'n_blocks: 2'))
    path = osp.join(out, 'serve.yml')
    with open(path, 'w') as f:
        f.write(text)
    return path


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The 2-rank validation's and the 2- and 1-rank serving runs'
    outputs, started at once."""
    tmp = tmp_path_factory.mktemp('parallel')
    root = str(tmp / 'synth')
    synth.write_dataset(root, n=N_VAL, size=(SIZE,))
    with open(tmp / 'val.json', 'w') as f:
        json.dump(_val_opt(root, str(tmp)), f)
    serve_opt = _serve_options(root, str(tmp))
    serve = ['-opt', serve_opt, '--batch', '2', '--device', 'cpu']
    val, = torch_dist_child.spawn(
        [(['validate', str(tmp / 'val.json'), str(tmp / 'val_means')], 2)],
        timeout=150)
    served = torch_dist_child.spawn(
        [(serve + ['--out', str(tmp / 'serve2'), '--launcher', 'pytorch'],
          2), (serve + ['--out', str(tmp / 'serve1')], 1)],
        timeout=150, script='c2matching_tpu_torch.scripts.serve')
    for out in [val] + served:
        for rc, text in out:
            assert rc == 0, text[-4000:]
    return tmp, root, served


def test_distributed_validation_equals_one_process(runs):
    tmp, root, _ = runs
    opt = _val_opt(root, str(tmp))
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model = create_model(opt, 'cpu')
        val_opt = opt['datasets']['val']
        loader = data.create_dataloader(data.create_dataset(val_opt),
                                        val_opt)
        assert len(loader) == N_VAL
        want = model.validation(loader, 0, None)
    finally:
        torch.set_num_threads(old)
    for rank in range(2):
        with open(f'{tmp}/val_means.rank{rank}') as f:
            got = json.load(f)
        assert set(got) == set(want) == {'psnr', 'psnr_y', 'ssim_y'}
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-12 * abs(v), (rank, k, got[k], v)


def _pngs(out):
    imgs = {}
    for name in sorted(n for n in os.listdir(out) if n.endswith('.png')):
        with open(osp.join(out, name), 'rb') as f:
            imgs[name] = png.decode(f.read()).astype(np.int16)
    return imgs


def test_serve_two_ranks_equals_one_process(runs):
    tmp, _, served = runs
    two, one = _pngs(tmp / 'serve2'), _pngs(tmp / 'serve1')
    assert list(two) == list(one) and len(one) == N_VAL
    diffs = {name: int(np.abs(two[name] - one[name]).max()) for name in one}
    assert max(diffs.values()) <= 1, diffs
    # the same nets on the same batches compute the same bits here
    assert max(diffs.values()) == 0, diffs
    with open(tmp / 'serve2' / 'serve.log') as f:
        log = f.read()
    assert f'{N_VAL} images in' in log and 'over 2 ranks' in log
    rank1 = served[0][1][1]
    assert 'served' not in rank1    # rank 1 logs errors only


def test_val_spatial_shard_in_training_changes_nothing(monkeypatch):
    """The JAX package reads val_spatial_shard in evaluation only: at world
    size 2 a training model with the option builds and trains (one
    G-pretrain step), and nothing is banded; an evaluation model takes
    the bands (``tests/test_torch_spatial.py`` runs them)."""
    monkeypatch.setattr(parallel, 'get_world_size', lambda: 2)
    eval_opt = dict(_val_opt('.', '.'), val_spatial_shard=True)
    assert create_model(eval_opt, 'cpu').spatial
    opt = dict_to_nonedict(dict(
        _val_opt('.', '.'), is_train=True, val_spatial_shard=True,
        train={'lr_g': 1e-4, 'pixel_criterion': 'L1Loss',
               'pixel_weight': 1.0, 'net_g_pretrain_steps': 10}))
    model = create_model(opt, 'cpu')
    assert model.world == 2 and not model.spatial
    rng = np.random.RandomState(0)
    model.feed_data({
        'img_in_lq': rng.rand(1, 16, 12, 3).astype(np.float32),
        'img_in_up': rng.rand(1, 64, 48, 3).astype(np.float32),
        'img_ref': rng.rand(1, 64, 48, 3).astype(np.float32),
        'img_in': rng.rand(1, 64, 48, 3).astype(np.float32)})
    assert model._band is None
    assert model.batch['img_in_lq'].shape == (1, 16, 12, 3)
    before = [p.detach().clone() for p in model.net_g.parameters()]
    model.optimize_parameters(1)
    assert model.output.shape == (1, 64, 48, 3)
    assert np.isfinite(float(model.log_dict['l_pix']))
    assert any(not torch.equal(a, b) for a, b in
               zip(before, model.net_g.parameters()))
