"""The stage-3 GAN iteration of the port at world size 2 (two gloo
processes on the CPU, ``c2matching_tpu_torch/scripts/dist_step.py``)
against one process on the same global batch.

The small model of ``torch_train_common`` (ngf 16, 2 blocks, D ndf 4,
the relu5_1 perceptual loss; debug_stage3_synth.yml's train block with one
G-pretrain step) at a global batch of 4 at gt 64, 2 a rank: step 1 (G
pretrain), step 2 (GAN: the D update with the gradient penalty, then the
G update), a save after step 2, the model built anew on both ranks from
those files and the ``.state``, and step 3. Each rank's gradients are
averaged over the ranks before Adam, D's BatchNorm takes the global
batch's statistics, and the gradient-penalty coefficients are drawn for
the global batch. The one-process run starts each step after the first
from the two-rank run's parameters and buffers (``dist_step``'s
``follow``: Adam moves a parameter by about its LR whatever the size of
its gradient, so where a gradient is rounding noise, such as that of D's
conv biases before a BatchNorm, which is zero in exact arithmetic, the
two runs part by up to twice the LR, and a free-running comparison of
later steps would start from different nets). Bounds, each step: every
averaged gradient within 1e-5 of its net's largest gradient; the logged
values within 1e-5 relative; D's running statistics just before D's Adam
step (after its passes over the real and the fake batch) within 1e-6;
the parameters after Adam within 2 x their LR (the bound of
``tests/test_parallel_production.py``).
"""
import json
import math
import os
import os.path as osp
import random

import numpy as np
import pytest
import torch

import torch_dist_child
import torch_train_common as common
from c2matching_tpu_torch.models import create_model
from c2matching_tpu_torch.models.ref_restoration_model import (group_lrs,
                                                               lr_group)
from c2matching_tpu_torch.scripts import dist_step

GRAD_REL = 1e-5
STATS_TOL = 1e-6
LOG_REL = 1e-5
STEPS = 3
RESUME_AFTER = 2


def _opt(root, out):
    return common.small_opt(root, out, with_d=True, perceptual=True,
                            net_g_pretrain_steps=1)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """(options, the one-process records, rank 0's and rank 1's records,
    the two ranks' output, the world-2 run's directory)."""
    tmp = tmp_path_factory.mktemp('parallel_gan')
    root = common.make_synth(tmp / 'synth', n=4, size=64)
    batches = []
    for step in range(STEPS):
        random.seed(step)
        np.random.seed(step)
        batches.append(common.batch(_opt(root, str(tmp)), n=4))
    torch.save(batches, tmp / 'batches.pt')
    opt2 = _opt(root, str(tmp / 'world2'))
    with open(tmp / 'opt2.json', 'w') as f:
        json.dump(opt2, f)
    out, = torch_dist_child.spawn([(
        ['step', '-opt', str(tmp / 'opt2.json'), '--batches',
         str(tmp / 'batches.pt'), '--out', str(tmp / 'world2'),
         '--launcher', 'pytorch', '--device', 'cpu', '--resume-after',
         str(RESUME_AFTER)], 2)], timeout=150)
    for rc, text in out:
        assert rc == 0, text[-4000:]
    ranks = [torch.load(tmp / 'world2' / f'rank{r}.pt', weights_only=False)
             for r in range(2)]
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        opt1 = _opt(root, str(tmp / 'world1'))
        one, _ = dist_step.run_steps(opt1, batches, 'cpu',
                                     resume_after=RESUME_AFTER,
                                     follow=ranks[0])
    finally:
        torch.set_num_threads(old)
    return opt1, one, ranks, out, tmp / 'world2'


def _close_grads(got, want, label):
    top = max(float(g.abs().max()) for g in want.values())
    assert top > 0 and set(got) == set(want)
    for name, g in want.items():
        err = float((got[name] - g).abs().max())
        assert err <= GRAD_REL * top, (label, name, err, top)


def _lr(opt, label, name):
    if label == 'net_d':
        return opt['train']['lr_d']
    return group_lrs(opt['train'])[lr_group(name)]


@pytest.mark.parametrize('step', range(1, STEPS + 1))
def test_gradients_before_adam_match_one_process(runs, step):
    _, one, ranks, _, _ = runs
    want, got = one[step - 1], ranks[0][step - 1]
    assert set(got['grads']) == ({'net_g'} if step == 1
                                 else {'net_g', 'net_d'})
    for label, grads in want['grads'].items():
        _close_grads(got['grads'][label], grads, label)


@pytest.mark.parametrize('step', range(1, STEPS + 1))
def test_logs_are_the_global_batch(runs, step):
    _, one, ranks, _, _ = runs
    want = one[step - 1]['logs']
    for rank in range(2):
        got = ranks[rank][step - 1]['logs']
        assert set(got) == set(want)
        for k, v in want.items():
            assert math.isfinite(got[k])
            assert abs(got[k] - v) <= LOG_REL * abs(v), (step, rank, k,
                                                          got[k], v)
    if step > 1:
        assert 'l_grad_penalty' in want


@pytest.mark.parametrize('step', (2, 3))
def test_discriminator_batchnorm_takes_global_statistics(runs, step):
    _, one, ranks, _, _ = runs
    want = one[step - 1]['d_stats']
    n_bn = 0
    for rank in range(2):
        got = ranks[rank][step - 1]['d_stats']
        assert set(got) == set(want)
        for name, b in want.items():
            if name.endswith(('running_mean', 'running_var')):
                err = float((got[name] - b).abs().max())
                assert err <= STATS_TOL, (rank, name, err)
                n_bn += 1
            else:
                assert torch.equal(got[name], b), name
    assert n_bn == 2 * 20
    # statistics of each rank's own half would differ between the ranks
    for name, b in ranks[1][step - 1]['d_stats'].items():
        assert torch.equal(b, ranks[0][step - 1]['d_stats'][name]), name


@pytest.mark.parametrize('step', range(1, STEPS + 1))
def test_parameters_after_adam_within_twice_the_lr(runs, step):
    opt, one, ranks, _, _ = runs
    want = one[step - 1]['params']
    for label, params in want.items():
        for name, p in params.items():
            lr = _lr(opt, label, name)
            err = float((ranks[0][step - 1]['params'][label][name]
                         - p).abs().max())
            assert err <= 2 * lr, (step, label, name, err, lr)
            assert torch.equal(ranks[0][step - 1]['params'][label][name],
                               ranks[1][step - 1]['params'][label][name])


def test_rank0_alone_writes_checkpoints_and_resume_continues(runs, tmp_path):
    opt, one, ranks, out, world2 = runs
    models = sorted(os.listdir(world2 / 'models'))
    assert models == ['net_d_2.pth', 'net_d_latest.pth', 'net_g_2.pth',
                      'net_g_latest.pth']
    assert os.listdir(world2 / 'training_state') == ['2.state']
    # the step after the resume ran on both ranks from the saved state
    for rank in range(2):
        last = ranks[rank][RESUME_AFTER]
        assert all(math.isfinite(v) for v in last['logs'].values())
    # rank 1 writes nothing
    model = create_model(dict(opt, path=dict(
        opt['path'], models=str(tmp_path / 'models'),
        training_state=str(tmp_path / 'state'))), 'cpu')
    model.rank = 1
    model.save(0, 5)
    assert not osp.exists(tmp_path / 'models')
    assert not osp.exists(tmp_path / 'state')
    for _, text in out:
        line = [ln for ln in text.splitlines() if ln.startswith('{"rank"')]
        assert len(line) == 1
        rec = json.loads(line[0])
        assert rec['world'] == 2 and len(rec['steps']) == STEPS
        assert all(s['allreduce_ms'] > 0 for s in rec['steps'])
