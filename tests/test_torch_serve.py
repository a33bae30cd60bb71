"""The port's batch serving CLI (``c2matching_tpu_torch/scripts/serve.py``)
against the JAX package's (``scripts/serve.py``).

``bucket_batches`` gives the JAX version's groups and names. The CLI, run
as ``python -m c2matching_tpu_torch.scripts.serve --device cpu`` with
jax, c2matching_tpu, cv2, PIL and yaml unimportable, serves the 3-pair
synth set at a small width (ngf 16, 2 blocks; f32) from the JAX model's
seeded weights bridged to ``.pth`` files (``utils/weights.py``): at batch
2 (a full flush and a padded partial one) and at batch 1 its PNGs agree
within one uint8 step (the bound of ``tests/test_serve_cli.py``), and the
batch-2 PNGs agree within one uint8 step with the JAX model run in
process through ``feed_data`` / ``test`` on the same batches.
"""
import os
import os.path as osp
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from c2matching_tpu.data.loader import default_collate as jax_collate
from c2matching_tpu.models import create_model as jax_create_model
from c2matching_tpu.utils import dict_to_nonedict
from c2matching_tpu.utils.options import parse as jax_parse
from c2matching_tpu_torch.data import create_dataset
from c2matching_tpu_torch.scripts.serve import bucket_batches
from c2matching_tpu_torch.utils import dict_to_nonedict as port_nonedict
from c2matching_tpu_torch.utils import png, tensor2img, weights
from c2matching_tpu_torch.utils.options import parse as port_parse

REPO = osp.abspath(osp.join(osp.dirname(__file__), osp.pardir))
sys.path.insert(0, osp.join(REPO, 'scripts'))

from serve import bucket_batches as jax_bucket_batches  # noqa: E402

SMOKE = osp.join(REPO, 'options', 'test', 'test_synth_smoke.yml')
SMALL = {'ngf': 16, 'n_blocks': 2}
BLOCKED = ('jax', 'c2matching_tpu', 'cv2', 'PIL', 'yaml')
# runs a module's CLI in a fresh interpreter where importing any of
# BLOCKED fails
GUARD = '''
import importlib.abc, runpy, sys
BLOCKED = {blocked!r}
for name in list(sys.modules):
    if name.split('.')[0] in BLOCKED:
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(f'{{name}} is blocked for this run')
        return None

sys.meta_path.insert(0, Block())
sys.argv = [{module!r}] + sys.argv[1:]
runpy.run_module({module!r}, run_name='__main__')
'''


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def bridged_options(root, synth_root=None, template=SMOKE):
    """(JAX model, port options path): the JAX model of ``template`` at
    the small width, and an options file for the port with its seeded
    weights bridged to .pth files under ``root`` (and the synth set at
    ``synth_root``, when given)."""
    opt = jax_parse(template, is_train=False)
    opt['network_g'].update(SMALL, trunk_unroll=1)
    model = jax_create_model(dict_to_nonedict(opt))
    files = {
        'pretrain_model_g': weights.restoration_net_state_dict(
            jax.device_get(model.vars_g)),
        'pretrain_model_feature_extractor':
            weights.contras_extractor_state_dict(
                jax.device_get(model.vars_extractor)),
        'pretrain_model_vgg': weights.torchvision_vgg_state_dict(
            jax.device_get(model.vars_map)),
    }
    with open(template) as f:
        text = f.read()
    if synth_root is not None:
        text = text.replace('./datasets/synth', synth_root)
    text = (text.replace('ngf: 64', f"ngf: {SMALL['ngf']}")
            .replace('n_blocks: 16', f"n_blocks: {SMALL['n_blocks']}"))
    for key, state in files.items():
        path = osp.join(root, f'{key}.pth')
        torch.save(state, path)
        if f'  {key}: ~' in text:
            text = text.replace(f'  {key}: ~', f'  {key}: {path}')
        else:
            text = text.replace('  strict_load: true',
                                f'  {key}: {path}\n  strict_load: true')
    path = osp.join(root, 'small.yml')
    with open(path, 'w') as f:
        f.write(text)
    return model, path


def run_guarded(module, args, cwd, timeout=300):
    """``python -m module args`` with BLOCKED unimportable; its output."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='2')
    proc = subprocess.run(
        [sys.executable, '-c', GUARD.format(blocked=BLOCKED, module=module),
         *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    return log


def _item(lq_hw, gt_hw, name):
    return {'img_in_lq': np.zeros(lq_hw + (3,), np.float32),
            'img_in': np.zeros(gt_hw + (3,), np.float32),
            'lq_path': f'/data/{name}.png'}


@pytest.mark.parametrize('batch_size', [1, 2, 3])
def test_bucket_batches_equals_jax(batch_size):
    """A mixed stream, with two items of one LR shape and different GT
    shapes (the JAX test_bucket_batches_separates_mixed_gt_sizes case):
    the same flushes, in the same order, with the same names."""
    items = [_item((125, 83), (500, 332), 'a'),
             _item((125, 83), (400, 300), 'b'),
             _item((125, 83), (500, 332), 'c'),
             _item((125, 83), (500, 332), 'd'),
             _item((100, 83), (400, 332), 'e'),
             _item((100, 83), (400, 332), 'f'),
             _item((125, 83), (400, 300), 'g')]
    items.append({k: v for k, v in _item((40, 40), (160, 160), 'x').items()
                  if k != 'lq_path'})
    got = list(bucket_batches(iter(items), batch_size))
    want = list(jax_bucket_batches(iter(items), batch_size))
    assert [names for _, names in got] == [names for _, names in want]
    assert [[id(it) for it in its] for its, _ in got] == \
        [[id(it) for it in its] for its, _ in want]
    for its, _ in got:
        assert len({(it['img_in_lq'].shape, it['img_in'].shape)
                    for it in its}) == 1
    assert sum(len(its) for its, _ in got) == len(items)


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """The CLI's outputs at batch 2 and batch 1, and the JAX model."""
    root = tmp_path_factory.mktemp('serve')
    synth = root / 'synth'
    subprocess.run([sys.executable, '-m',
                    'c2matching_tpu_torch.scripts.make_synth_dataset',
                    str(synth), '--n', '3', '--size', '160'], check=True,
                   cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    model, opt_path = bridged_options(str(root), str(synth))
    outs = {}
    for batch in (2, 1):
        out = root / f'b{batch}'
        log = run_guarded('c2matching_tpu_torch.scripts.serve',
                          ['-opt', opt_path, '--batch', str(batch), '--out',
                           str(out), '--device', 'cpu'], cwd=str(root))
        assert 'img/s' in log
        outs[batch] = out
    return outs, model, opt_path


def _pngs(out):
    names = sorted(n for n in os.listdir(out) if n.endswith('.png'))
    imgs = {}
    for name in names:
        with open(osp.join(out, name), 'rb') as f:
            imgs[name] = png.decode(f.read()).astype(np.int16)
    return imgs


def test_serve_batch2_equals_batch1(served):
    outs, _, _ = served
    b2, b1 = _pngs(outs[2]), _pngs(outs[1])
    assert list(b2) == list(b1) == [f'00{i}_1_00000{i}.png' for i in range(3)]
    for name in b2:
        assert b2[name].shape == (160, 160, 3)
        assert np.abs(b2[name] - b1[name]).max() <= 1, name
    assert osp.exists(osp.join(outs[2], 'serve.log'))


def test_serve_equals_jax_model_on_the_same_batches(served):
    """The JAX model on the bridged weights, through feed_data / test on
    the batches the port's bucketing makes (padded partial flush
    included), writes the same images within one uint8 step."""
    outs, model, opt_path = served
    opt = port_nonedict(port_parse(opt_path, is_train=False))
    dataset = create_dataset(opt['datasets']['test_1'])
    b2 = _pngs(outs[2])
    stream = (dataset[i] for i in range(len(dataset)))
    n_checked = 0
    for items, names in bucket_batches(stream, 2):
        padded = items + [items[-1]] * (2 - len(items))
        model.feed_data(jax_collate(padded))
        model.test()
        # the JAX model's output on its bucket, cut to the batch's shape
        h, w = np.asarray(items[0]['img_in_up']).shape[:2]
        out = np.asarray(jax.device_get(model.output))[:, :h, :w]
        for i, name in enumerate(names):
            want = tensor2img(out[i]).astype(np.int16)
            assert np.abs(b2[f'{name}.png'] - want).max() <= 1, name
            n_checked += 1
    assert n_checked == 3
