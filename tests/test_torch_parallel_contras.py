"""Stages 1 and 2 of the port at world size 2 (two gloo processes on the
CPU, ``c2matching_tpu_torch/scripts/dist_step.py --float64``) against one
process on the same global batch, in float64 (the models'
``float64_grads``: nets and batch in double, the logs and the gradients of
one step, no update).

The global batch holds 4 ContrasDataset items at gt 96 (debug_stage{1,2}
_synth.yml's train block), 2 a rank; in the first batch sample 0, in the
second sample 3, has its homography grid moved off the image, so it has no
valid correspondence and fails the 128-correspondence gate: the ranks
hold 1 and 2 samples over the gate. The JAX loss divides by the global
count (``c2matching_tpu/models/contras_losses.py:126-129``), 3 here; so
does the port's, which hands each rank its share. Held: the logs (the
global count among them) and every gradient leaf, after the average over
the ranks, within 1e-12 of the one-process step (of each log, and of the
net's largest gradient). The naive form, each rank's loss over its own
count averaged over the ranks, misses that bound by orders of magnitude.
"""
import json
import random

import numpy as np
import pytest
import torch

import torch_dist_child
from c2matching_tpu_torch.data import ContrasDataset, default_collate
from c2matching_tpu_torch.scripts import dist_step, make_synth_dataset as synth
from c2matching_tpu_torch.utils import dict_to_nonedict, options

GT, GLOBAL_BATCH = 96, 4
REL64 = 1e-12
MODEL = {1: 'TeacherContrasModel', 2: 'StudentContrasDistillationModel'}


def _opt(stage, root, out):
    nets = ({'network_g': {'type': 'ContrasExtractorSep'}} if stage == 1 else
            {'network_student': {'type': 'ContrasExtractorSep'},
             'network_teacher': {'type': 'ContrasExtractorSep'}})
    cfg = f'options/train/debug_stage{stage}_synth.yml'
    return dict_to_nonedict({
        'name': f'parallel_s{stage}', 'is_train': True,
        'model_type': MODEL[stage], 'scale': 4, 'manual_seed': 0, **nets,
        'path': {'models': f'{out}/models',
                 'training_state': f'{out}/training_state'},
        'train': dict(options.load(f'{torch_dist_child.REPO}/{cfg}')[
            'train']),
    })


def _batches(root):
    data = ContrasDataset({
        'name': 'synth', 'phase': 'train', 'scale': 4, 'gt_size': GT,
        'use_flip': True, 'use_rot': True, 'dataroot_in': f'{root}/input',
        'dataroot_ref': f'{root}/ref', 'io_backend': {'type': 'disk'},
        'ann_file': f'{root}/pairs.txt'})
    out = []
    for seed, gated in ((0, 0), (1, 3)):
        random.seed(seed)
        np.random.seed(seed)
        batch = default_collate([data[i] for i in range(GLOBAL_BATCH)])
        batch['transformed_coordinate'][gated] -= 1000.
        out.append(batch)
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """{(stage, 'world1' | 'world2' | 'naive'): rank 0's records}."""
    tmp = tmp_path_factory.mktemp('parallel_contras')
    root = str(tmp / 'synth')
    synth.write_dataset(root, n=4, size=(GT,))
    batches = _batches(root)
    torch.save(batches, tmp / 'batches.pt')
    jobs, keys = [], []
    for stage, mode in ((1, 'step'), (2, 'step'), (1, 'naive')):
        key = (stage, 'world2' if mode == 'step' else 'naive')
        out = tmp / f'{key[0]}_{key[1]}'
        with open(tmp / f'{key[0]}_{key[1]}.json', 'w') as f:
            json.dump(_opt(stage, root, str(out)), f)
        jobs.append(([mode, '-opt', str(tmp / f'{key[0]}_{key[1]}.json'),
                      '--batches', str(tmp / 'batches.pt'), '--out',
                      str(out), '--launcher', 'pytorch', '--device', 'cpu',
                      '--float64'], 2))
        keys.append(key)
    outputs = torch_dist_child.spawn(jobs, timeout=150)
    for out in outputs:
        for rc, text in out:
            assert rc == 0, text[-4000:]
    records = {}
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for stage in (1, 2):
            records[(stage, 'world1')], _ = dist_step.run_steps(
                _opt(stage, root, str(tmp / f'{stage}_world1')), batches,
                'cpu', float64=True)
    finally:
        torch.set_num_threads(old)
    for key in keys:
        ranks = [torch.load(tmp / f'{key[0]}_{key[1]}' / f'rank{r}.pt',
                            weights_only=False) for r in range(2)]
        for a, b in zip(*ranks):
            assert a['logs'] == b['logs']
            for label, grads in a['grads'].items():
                for name, g in grads.items():
                    assert torch.equal(g, b['grads'][label][name]), name
        records[key] = ranks[0]
    return records


def _grad_err(got, want):
    """(max |got - want| over the leaves, the largest |want|)."""
    label, = want
    top = max(float(g.abs().max()) for g in want[label].values())
    err = max(float((got[label][k] - g).abs().max())
              for k, g in want[label].items())
    return err, top


@pytest.mark.parametrize('stage', (1, 2))
@pytest.mark.parametrize('step', (0, 1))
def test_float64_step_matches_one_process(runs, stage, step):
    want = runs[(stage, 'world1')][step]
    got = runs[(stage, 'world2')][step]
    assert want['logs']['n_valid'] == got['logs']['n_valid'] == 3
    assert set(got['logs']) == set(want['logs'])
    for k, v in want['logs'].items():
        assert abs(got['logs'][k] - v) <= REL64 * abs(v), (k, got['logs'][k],
                                                           v)
    for g in got['grads'].values():
        assert all(t.dtype == torch.float64 for t in g.values())
    err, top = _grad_err(got['grads'], want['grads'])
    assert top > 0 and err <= REL64 * top, (err, top)


@pytest.mark.parametrize('step', (0, 1))
def test_per_rank_mean_fails_the_bound(runs, step):
    """Each rank over its own count of samples over the gate (1 and 2):
    the gradient is no longer the global batch's."""
    want = runs[(1, 'world1')][step]
    naive = runs[(1, 'naive')][step]
    err, top = _grad_err(naive['grads'], want['grads'])
    assert err > 1e6 * REL64 * top, (err, top)
    assert abs(naive['logs']['loss'] - want['logs']['loss']) > \
        1e6 * REL64 * abs(want['logs']['loss'])
