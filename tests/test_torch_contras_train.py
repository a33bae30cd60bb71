"""The port's stage-1 and stage-2 training against the JAX package's, on
the CPU.

A ``TeacherContrasModel`` and a ``StudentContrasDistillationModel`` of
each side, at full width (``ContrasExtractorSep`` has no width knob) on
batches of 2 at gt 96 from the contrastive dataset; the port's nets get
the JAX variables through ``utils/weights.py``. Held against JAX:

- one step of each model against the JAX model's own jitted step (its
  optimizer wrapped so that its state keeps the step's gradient), at six
  batches (seeds 0-5); every sample passes the 128-correspondence gate
  (n_valid 2):
  - in float64 on both sides (the port's ``float64_grads``; the JAX model
    with ``dtype: float64`` nets under x64, ``_jax_float64``): the logs at
    rel 1e-12 and every leaf's gradient within 1e-12 of the largest
    (measured: 1.1e-15 and 6.2e-15 at worst);
  - in float32: the logs at rel 1e-5 against the JAX model's float32
    step, and the updated parameters where the gradient's sign is clear
    of the two sides' disagreement (``torch_train_common.close_deltas``).
  The gradients are held in float64 because float32 ones cannot be held
  leaf by leaf at 1e-4 at every batch: a hardest negative whose two best candidates lie within float32's noise (~1e-6
  of the features) is taken at one position on one side and at another
  on the other, which moves one term of the gradient. At these six
  batches the float32 gradients of the two sides lie up to 1.3e-3 of the
  largest apart; each side's lies 1e-4 or more from the float64 step at
  6 (JAX) and 6 (port) of the 12 steps, at most 2.1e-3 (measured; each
  step records the three as its junit properties ``grad32_*``). The
  loss's own gradients, ties included, are held in float32 in
  ``test_torch_contras_losses.py``, where both sides get the same
  features;
- the student's step leaves the teacher bit for bit as it was;
- a validation pass's means against the JAX model's own ``test`` over
  the same items;
- save -> resume: the next step gives the same bits;
- ``python -m c2matching_tpu_torch.train --device cpu`` on
  ``debug_stage1_synth.yml``, then on ``debug_stage2_synth.yml`` with the
  teacher path set to stage 1's ``net_g_latest.pth``, with jax, cv2, PIL
  and yaml unimportable.
"""
import contextlib
import copy
import logging
import os
import os.path as osp
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_common as common
from c2matching_tpu.data import create_dataloader as jax_dataloader
from c2matching_tpu.data.contras_dataset import (ContrasDataset as JaxDataset,
                                                 ContrasValDataset as JaxVal)
from c2matching_tpu.data.loader import default_collate
from c2matching_tpu.models import contras_losses as jax_losses
from c2matching_tpu.models import create_model as jax_create_model
from c2matching_tpu.models.archs import vgg_arch as jax_vgg
from c2matching_tpu.parallel.mesh import get_mesh
from c2matching_tpu.utils import dict_to_nonedict
from c2matching_tpu_torch.data import DataLoader, ContrasValDataset
from c2matching_tpu_torch.models import (MODELS,
                                         StudentContrasDistillationModel,
                                         TeacherContrasModel)
from c2matching_tpu_torch.scripts import make_synth_dataset as synth
from c2matching_tpu_torch.utils import check_resume, options, weights

REPO = common.REPO
GT, BATCH = 96, 2
LOSS_REL = 1e-5
LOSS_REL64, GRAD_REL64 = 1e-12, 1e-12
# port attribute -> JAX variables attribute of each net
_NETS = {1: {'net_g': 'vars_g'},
         2: {'net_student': 'vars_student', 'net_teacher': 'vars_teacher'}}
STAGE_CFG = {s: osp.join(REPO, 'options', 'train', f'debug_stage{s}_synth.yml')
             for s in (1, 2)}


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope='module')
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('contras_train') / 'synth')
    synth.write_dataset(root, n=4, size=(GT,))
    return root


def _opt(stage, root, out):
    """debug_stage{1,2}_synth.yml's train block on the synth set, batch 2
    at gt 96, no pretrain paths."""
    model = {1: 'TeacherContrasModel', 2: 'StudentContrasDistillationModel'}
    nets = ({'network_g': {'type': 'ContrasExtractorSep'}} if stage == 1 else
            {'network_student': {'type': 'ContrasExtractorSep'},
             'network_teacher': {'type': 'ContrasExtractorSep'}})
    return dict_to_nonedict({
        'name': f'parity_s{stage}', 'is_train': True,
        'model_type': model[stage], 'scale': 4, 'manual_seed': 0,
        'datasets': {'train': {
            'name': 'synth', 'phase': 'train', 'scale': 4,
            'type': 'ContrasDataset', 'gt_size': GT, 'use_flip': True,
            'use_rot': True, 'dataroot_in': f'{root}/input',
            'dataroot_ref': f'{root}/ref', 'io_backend': {'type': 'disk'},
            'ann_file': f'{root}/pairs.txt', 'batch_size': BATCH}},
        **nets,
        'path': {'models': f'{out}/models',
                 'training_state': f'{out}/training_state',
                 'strict_load': True},
        'train': dict(options.load(STAGE_CFG[stage])['train']),
    })


def _batch(opt, seed):
    np.random.seed(seed)
    import random
    random.seed(seed)
    ds = JaxDataset(copy.deepcopy(opt['datasets']['train']))
    return default_collate([ds[i] for i in range(BATCH)])


def _bridge(port, jmodel, stage):
    for net, var in _NETS[stage].items():
        getattr(port, net).load_state_dict(weights.contras_extractor_state_dict(
            jax.device_get(getattr(jmodel, var))))


@contextlib.contextmanager
def _jax_float64():
    """The JAX package in float64: x64 on; ``contras_losses``' float32
    constants (the dots' ``preferred_element_type``, the masks, the grid)
    taken as float64; the extractor's ImageNet mean and std as the float32
    values that the float32 models of both sides use (the port keeps them
    in float32 buffers, which its float64 copies carry over), so that both
    float64 steps normalise the image alike."""

    class Jnp64:
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    saved = (jax_losses.jnp, jax_vgg.IMAGENET_MEAN, jax_vgg.IMAGENET_STD)
    jax_losses.jnp = Jnp64()
    jax_vgg.IMAGENET_MEAN, jax_vgg.IMAGENET_STD = (
        tuple(float(np.float32(v)) for v in c) for c in saved[1:])
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jax_losses.jnp, jax_vgg.IMAGENET_MEAN, jax_vgg.IMAGENET_STD = saved


@pytest.fixture(scope='module', params=[1, 2])
def stage_models(request, synth_root, tmp_path_factory):
    """The JAX model with its optimizer recording gradients, the same
    model computing in float64, and the JAX model's initial variables.
    Both JAX models run on a one-device mesh: a batch of 2 does not divide
    the tests' 8 virtual devices and would be computed on each."""
    stage = request.param
    opt = _opt(stage, synth_root, str(tmp_path_factory.mktemp('jax')))
    jmodel = jax_create_model(copy.deepcopy(opt))
    jmodel.tx = common.recorder(jmodel.tx)
    jmodel.mesh = get_mesh(jax.devices()[:1])
    opt64 = copy.deepcopy(opt)
    for net in _NETS[stage]:
        opt64[f'network_{net[4:]}']['dtype'] = 'float64'
    with _jax_float64():
        jmodel64 = jax_create_model(opt64)
        jmodel64.tx = common.recorder(jmodel64.tx)
    jmodel64.mesh = jmodel.mesh
    init = {var: jax.device_get(getattr(jmodel, var))
            for var in _NETS[stage].values()}
    return stage, opt, jmodel, jmodel64, init


def _start(jmodel, init, trained_var, dtype=None):
    """Set the JAX model's variables to ``init`` (cast to ``dtype``) and
    its optimizer afresh."""
    for var, tree in init.items():
        if dtype is not None:
            tree = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
        setattr(jmodel, var, tree)
    jmodel.opt_state = jmodel.tx.init(getattr(jmodel, trained_var)['params'])


def _grad(leaf):
    return leaf.grad if isinstance(leaf, torch.nn.Parameter) else leaf


@pytest.mark.parametrize('seed', range(6))
def test_one_step_matches_jax(stage_models, seed, request):
    stage, opt, jmodel, jmodel64, init = stage_models
    port = MODELS[opt['model_type']](opt, 'cpu')
    trained_var = _NETS[stage][port.net_label]
    _start(jmodel, init, trained_var)
    _bridge(port, jmodel, stage)
    batch = _batch(opt, seed)
    trained = port.trained
    before = common.torch_state(trained)
    teacher_before = (common.torch_state(port.net_teacher) if stage == 2
                      else None)

    # float64: the port's gradients against the JAX model's own jitted step
    logs64, grads64 = port.float64_grads(batch)
    with _jax_float64():
        _start(jmodel64, init, trained_var, jnp.float64)
        jmodel64.feed_data({k: np.asarray(v, np.float64)
                            if k.startswith('img') else v
                            for k, v in batch.items()})
        jmodel64.optimize_parameters(1)
        want64 = weights.contras_extractor_state_dict(
            jax.tree.map(lambda a: np.asarray(a, np.float64),
                         jax.device_get(jmodel64.opt_state[1])))
        want_logs64 = {k: float(v) for k, v in jmodel64.log_dict.items()}
    assert logs64['n_valid'] == want_logs64['n_valid'] == BATCH
    for k, v in want_logs64.items():
        assert abs(logs64[k] - v) <= LOSS_REL64 * abs(v), (k, logs64[k], v)
    named = dict(trained.named_parameters())
    assert set(grads64) == set(named) <= set(want64)
    top = max(float(want64[k].abs().max()) for k in named)
    assert top > 0
    for name, g in grads64.items():
        err = float((g - want64[name]).abs().max())
        assert err <= GRAD_REL64 * top, (
            f'float64 grad {name}: {err:.3g} from JAX\'s (largest {top:.3g})')

    # float32: the logs and the update against the JAX model's float32 step
    jmodel.feed_data(batch)
    jmodel.optimize_parameters(1)
    port.feed_data(batch)
    port.optimize_parameters(1)
    want = {k: float(v) for k, v in jmodel.log_dict.items()}
    assert set(port.log_dict) == set(want)
    assert float(port.log_dict['n_valid']) == want['n_valid'] == BATCH
    for k, v in want.items():
        got = float(port.log_dict[k])
        assert abs(got - v) <= LOSS_REL * abs(v), (k, got, v)
    grads = weights.contras_extractor_state_dict(jmodel.opt_state[1])
    # recorded, not gated (see the module's docstring): how far apart the
    # float32 gradients lie, and each side's from the float64 step
    for key, (a, b) in {'grad32_port_vs_jax': (named, grads),
                        'grad32_port_vs_float64': (named, want64),
                        'grad32_jax_vs_float64': (grads, want64)}.items():
        request.node.user_properties.append((key, max(
            float((_grad(a[n]).double() - _grad(b[n]).double()).abs().max())
            for n in named) / top))
    after = weights.contras_extractor_state_dict(
        jax.device_get(getattr(jmodel, trained_var)))
    lr = opt['train']['lr_g']
    common.close_deltas(trained, before, after, grads, lambda name: lr,
                        f'stage {stage} seed {seed}')
    if stage == 2:
        for k, v in port.net_teacher.state_dict().items():
            assert torch.equal(v, teacher_before[k]), k
        assert all(p.grad is None for p in port.net_teacher.parameters())
        assert not any(p.requires_grad
                       for p in port.net_teacher.parameters())
        assert {id(p) for g in port.optimizer_g.param_groups
                for p in g['params']} == {id(p) for p in trained.parameters()}


def test_validation_means_match_jax(stage_models, synth_root, caplog):
    stage, opt, jmodel, _, _ = stage_models
    port = MODELS[opt['model_type']](opt, 'cpu')
    _bridge(port, jmodel, stage)
    val_opt = {'name': 'val_synth', 'phase': 'val', 'scale': 4,
               'type': 'ContrasValDataset',
               'dataroot_in': f'{synth_root}/input',
               'dataroot_ref': f'{synth_root}/ref',
               'io_backend': {'type': 'disk'},
               'ann_file': f'{synth_root}/pairs.txt'}
    # the 'base' logger stops propagating to caplog's handler once a
    # runner in the same process has set it up
    logger = logging.getLogger('base')
    propagate, logger.propagate = logger.propagate, True
    try:
        with caplog.at_level('INFO', logger='base'):
            got = port.validation(
                DataLoader(ContrasValDataset(dict(val_opt))), 0, None)
    finally:
        logger.propagate = propagate
    line = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith('# Validation val_synth')]
    assert len(line) == 1 and 'positive_distance' in line[0]
    assert ('distill_loss' in line[0]) == (stage == 2)

    totals = {k: 0. for k in got}
    loader = jax_dataloader(JaxVal(dict(val_opt)), val_opt)
    for val_data in loader:
        jmodel.feed_data(val_data)
        jmodel.test()
        for k in totals:
            totals[k] += float(jmodel._last_eval[k])
    assert len(loader) == 4
    for k, total in totals.items():
        want = total / len(loader)
        assert abs(got[k] - want) <= LOSS_REL * abs(want), (k, got[k], want)
    assert got['loss'] > 0


def test_save_resume_reproduces_next_step(synth_root, tmp_path):
    for stage in (1, 2):
        out = str(tmp_path / f's{stage}')
        opt = _opt(stage, synth_root, out)
        batch = _batch(opt, seed=10 + stage)
        first = MODELS[opt['model_type']](opt, 'cpu')
        first.feed_data(batch)
        for step in (1, 2):
            first.optimize_parameters(step)
        first.save(0, 2)
        first.optimize_parameters(3)

        resumed = _opt(stage, synth_root, out)
        state = osp.join(out, 'training_state', '2.state')
        resumed['path']['resume_state'] = state
        check_resume(resumed, '2')
        label = first.net_label
        assert resumed['path'][f'pretrain_model_{label[4:]}'].endswith(
            f'{label}_2.pth')
        second = MODELS[opt['model_type']](resumed, 'cpu')
        assert second.resume_training(state) == (0, 2)
        second.feed_data(batch)
        second.optimize_parameters(3)
        a, b = first.trained.state_dict(), second.trained.state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), (stage, k)
        assert first.schedules.counts == second.schedules.counts == {'g': 3}
        for k, v in first.log_dict.items():
            assert float(v) == float(second.log_dict[k]), (stage, k)


def test_teacher_path_must_be_pth(synth_root, tmp_path):
    opt = _opt(2, synth_root, str(tmp_path))
    opt['path']['pretrain_model_teacher'] = str(tmp_path / 'net_g.ckpt')
    with pytest.raises(ValueError, match='.pth'):
        StudentContrasDistillationModel(opt, 'cpu')


_GUARD = '''
import importlib.abc, runpy, sys
BLOCKED = ('jax', 'c2matching_tpu', 'cv2', 'PIL', 'yaml')

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(name + ' is blocked for this run')
        return None

sys.meta_path.insert(0, Block())
sys.argv = ['c2matching_tpu_torch.train'] + sys.argv[1:]
runpy.run_module('c2matching_tpu_torch.train', run_name='__main__')
'''


def _cli(stage, root, out, teacher=None):
    with open(STAGE_CFG[stage]) as f:
        text = f.read().replace('./datasets/synth', root)
    if teacher:
        old = './experiments/debug_stage1_synth/models/net_g_latest.ckpt'
        assert old in text
        text = text.replace(old, teacher)
    path = osp.join(out, f'stage{stage}.yml')
    with open(path, 'w') as f:
        f.write(text)
    env = dict(os.environ, C2MATCHING_ROOT=out, PYTHONPATH=REPO,
               OMP_NUM_THREADS='2')
    proc = subprocess.run([sys.executable, '-c', _GUARD, '-opt', path,
                           '--device', 'cpu'], cwd=out, env=env,
                          capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    return log


def test_cli_stage1_then_stage2(tmp_path):
    root = str(tmp_path / 'synth')
    synth.write_dataset(root, n=3, size=(160,))
    out = str(tmp_path)
    exp = osp.join(out, 'experiments')
    for stage, label, keys in (
            (1, 'net_g', ('loss', 'pos_dist', 'neg_dist', 'n_valid')),
            (2, 'net_student', ('loss', 'pos_dist', 'neg_dist',
                                'distill_loss', 'n_valid'))):
        teacher = (osp.join(exp, 'debug_stage1_synth', 'models',
                            'net_g_latest.pth') if stage == 2 else None)
        log = _cli(stage, root, out, teacher)
        iters = [int(v) for v in re.findall(r'iter:\s+(\d+),', log)]
        assert iters == list(range(1, 9))
        for line in log.splitlines():
            if re.search(r'iter:\s+\d+,', line):
                vals = dict(re.findall(r'(\w+): (\S+) ', line + ' '))
                assert all(np.isfinite(float(vals[k])) for k in keys), line
                assert float(vals['n_valid']) == 2, line
        if stage == 2:
            assert f'Loading ContrasExtractorSep model from {teacher}' in log
        models = osp.join(exp, f'debug_stage{stage}_synth', 'models')
        assert sorted(os.listdir(models)) == [f'{label}_8.pth',
                                              f'{label}_latest.pth']
        state = torch.load(osp.join(exp, f'debug_stage{stage}_synth',
                                    'training_state', '8.state'),
                           weights_only=True)
        assert (state['epoch'], state['iter']) == (0, 8)
        assert state['counts'] == {'g': 8}
