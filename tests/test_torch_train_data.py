"""The port's training data and its train runner.

- ``RefCUFEDDataset``'s train phase (the ref resized to ``gt_size`` with
  PIL's bicubic, flips and rotations drawn from ``random``) against the
  JAX package's dataset, bit for bit under the same ``random.seed``;
- ``EnlargedIterSampler``'s indices and the train loader's batches
  (shuffle by epoch, sampler, ``drop_last``, prefetch threads) against
  the JAX package's;
- ``python -m c2matching_tpu_torch.train -opt <debug config> --device
  cpu`` end to end, with jax, c2matching_tpu, cv2, PIL and yaml
  unimportable: debug_stage3_synth.yml at a small width (ngf 16, 2
  blocks, ndf 4) on a 64-px synth set, its 12 iterations, the
  validation at 8, the .pth checkpoints and the .state; then a resume
  from that .state to the end; a SIGTERM during an iteration, which
  saves that iteration's checkpoint and returns; and without
  ``--device`` on a host with no card, an error rather than a run on the
  CPU.
"""
import os
import os.path as osp
import random
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from c2matching_tpu.data import DataLoader as JaxLoader
from c2matching_tpu.data import EnlargedIterSampler as JaxSampler
from c2matching_tpu.data import RefCUFEDDataset as JaxDataset
from c2matching_tpu_torch.data import (EnlargedIterSampler, RefCUFEDDataset,
                                       create_dataloader, create_dataset,
                                       create_train_sampler)
from c2matching_tpu_torch.models.ref_restoration_model import \
    RefRestorationModel
from c2matching_tpu_torch.train import run

REPO = osp.abspath(osp.join(osp.dirname(__file__), osp.pardir))
DEBUG_CFG = osp.join(REPO, 'options', 'train', 'debug_stage3_synth.yml')
BLOCKED = ('jax', 'c2matching_tpu', 'cv2', 'PIL', 'yaml')
# runs the train CLI in a fresh interpreter where importing any of BLOCKED
# fails
_GUARD = '''
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
sys.argv = ['c2matching_tpu_torch.train'] + sys.argv[1:]
runpy.run_module('c2matching_tpu_torch.train', run_name='__main__')
'''


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope='module')
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('synth_train_data')
    subprocess.run([sys.executable,
                    osp.join(REPO, 'scripts', 'make_synth_dataset.py'),
                    str(root), '--n', '4', '--size', '64'], check=True)
    return str(root)


def _train_opt(root, gt_size, flip=True, rot=True):
    return dict(name='synth', type='RefCUFEDDataset', phase='train', scale=4,
                dataroot_in=osp.join(root, 'input'),
                dataroot_ref=osp.join(root, 'ref'),
                io_backend={'type': 'disk'},
                ann_file=osp.join(root, 'pairs.txt'), gt_size=gt_size,
                use_flip=flip, use_rot=rot, batch_size=3, n_workers=2,
                use_shuffle=True, dataset_enlarge_ratio=5)


@pytest.mark.parametrize('gt_size', [64, 48])
def test_train_items_equal_jax(synth_root, gt_size):
    """The same items, bit for bit, over enough seeds that every flip and
    rotation comes up; at gt 48 the ref goes through the bicubic resize."""
    opt = _train_opt(synth_root, gt_size)
    port, ref = RefCUFEDDataset(dict(opt)), JaxDataset(dict(opt))
    for seed in range(8):
        for i in range(len(ref)):
            random.seed(seed)
            want = ref[i]
            random.seed(seed)
            got = port[i]
            assert list(got) == list(want)
            for key, w in want.items():
                assert got[key].dtype == w.dtype, key
                np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert got['img_ref'].shape == (gt_size, gt_size, 3)
    assert 'lq_path' not in got


def test_sampler_equals_jax():
    for size, ratio in ((4, 5), (7, 3), (10, 1)):
        port, ref = EnlargedIterSampler(size, ratio=ratio), \
            JaxSampler(size, ratio=ratio)
        assert len(port) == len(ref)
        for epoch in (0, 1, 5):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(port) == list(ref)


@pytest.mark.parametrize('with_sampler', [False, True])
def test_train_loader_batches_equal_jax(synth_root, with_sampler):
    """The train loader against the JAX one over two epochs: the same
    items in the same batches (no augmentation, so the threads' order
    cannot change a draw)."""
    opt = _train_opt(synth_root, 64, flip=False, rot=False)
    dataset = create_dataset(opt)
    sampler = create_train_sampler(dataset, opt) if with_sampler else None
    loader = create_dataloader(dataset, opt, sampler=sampler, seed=10)
    ref = JaxLoader(JaxDataset(dict(opt)), batch_size=3,
                    sampler=JaxSampler(4, ratio=5) if with_sampler else None,
                    shuffle=not with_sampler, num_workers=2, drop_last=True,
                    seed=10)
    assert len(loader) == len(ref) == (20 // 3 if with_sampler else 1)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(loader), list(ref)
        assert len(got) == len(want) == len(loader)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _options(root, out_dir, resume=None):
    """debug_stage3_synth.yml at a small width on the 64-px synth set."""
    with open(DEBUG_CFG) as f:
        text = f.read()
    text = text.replace('./datasets/synth', root)
    text = text.replace('gt_size: 160', 'gt_size: 64')
    text = text.replace('  ngf: 64\n  n_blocks: 16\n',
                        '  ngf: 16\n  n_blocks: 2\n')
    text = text.replace('  ndf: 32\n', '  ndf: 4\n')
    if resume:
        text = text.replace('  resume_state: ~', f'  resume_state: {resume}')
    path = osp.join(out_dir, 'resume.yml' if resume else 'debug.yml')
    with open(path, 'w') as f:
        f.write(text)
    return path


def _cli(opt_path, root_dir):
    env = dict(os.environ, C2MATCHING_ROOT=root_dir, PYTHONPATH=REPO,
               OMP_NUM_THREADS='2')
    proc = subprocess.run(
        [sys.executable, '-c', _GUARD.format(blocked=BLOCKED), '-opt',
         opt_path, '--device', 'cpu'],
        cwd=root_dir, env=env, capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    return log


def test_cli_trains_and_resumes_without_jax_cv2_pil_yaml(synth_root,
                                                         tmp_path):
    out = str(tmp_path)
    log = _cli(_options(synth_root, out), out)
    iters = [int(v) for v in re.findall(r'iter:\s+(\d+),', log)]
    assert iters == list(range(1, 13))
    assert '# Validation val_synth # PSNR' in log
    exp = osp.join(out, 'experiments', 'debug_stage3_synth')
    models = sorted(os.listdir(osp.join(exp, 'models')))
    assert models == ['net_d_8.pth', 'net_d_latest.pth', 'net_g_8.pth',
                      'net_g_latest.pth']
    state = osp.join(exp, 'training_state', '8.state')
    assert os.listdir(osp.join(exp, 'training_state')) == ['8.state']
    saved = torch.load(state, weights_only=True)
    assert (saved['epoch'], saved['iter']) == (0, 8)
    assert saved['counts'] == {'g': 8, 'd': 8}
    for line in log.splitlines():
        if 'iter:      12' in line:
            assert all(np.isfinite(float(v)) for v in
                       re.findall(r'l_\w+: (\S+)', line))

    log = _cli(_options(synth_root, out, resume=state), out)
    assert 'Resuming training from epoch: 0, iter: 8.' in log
    iters = [int(v) for v in re.findall(r'iter:\s+(\d+),', log)]
    assert iters == [9, 10, 11, 12]
    assert 'End of training.' in log


def test_runner_needs_a_card_unless_told(synth_root, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA card')
    monkeypatch.setenv('C2MATCHING_ROOT', str(tmp_path))
    with pytest.raises(RuntimeError, match='no CUDA card'):
        run(_options(synth_root, str(tmp_path)))


def test_sigterm_saves_a_resumable_checkpoint(synth_root, tmp_path,
                                              monkeypatch):
    """A SIGTERM that lands during iteration 3 lets it finish, saves its
    nets and 3.state, and returns; the signal handlers are put back."""
    monkeypatch.setenv('C2MATCHING_ROOT', str(tmp_path))
    real = RefRestorationModel.optimize_parameters

    def step(self, current_iter):
        real(self, current_iter)
        if current_iter == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(RefRestorationModel, 'optimize_parameters', step)
    before = signal.getsignal(signal.SIGTERM)
    model = run(_options(synth_root, str(tmp_path)), device='cpu')
    assert signal.getsignal(signal.SIGTERM) is before
    exp = osp.join(str(tmp_path), 'experiments', 'debug_stage3_synth')
    assert os.listdir(osp.join(exp, 'training_state')) == ['3.state']
    assert sorted(os.listdir(osp.join(exp, 'models'))) == [
        'net_d_3.pth', 'net_d_latest.pth', 'net_g_3.pth', 'net_g_latest.pth']
    # three G-pretrain updates; D's count starts after the 4 pretrain steps
    assert model.schedules.counts == {'g': 3, 'd': 4}
