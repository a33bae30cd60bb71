"""The port's test runner against the pinned end-to-end golden metrics.

``tests/test_e2e_golden.py`` pins PSNR, PSNR_Y and SSIM_Y of the JAX
package's full test pipeline on ``test_synth_smoke.yml`` over the synth
set (``scripts/make_synth_dataset.py --n 3 --size 160``) with its seeded
init. Here the JAX RefRestorationModel built from that options file gives
its seeded variables; ``utils/weights.py`` writes them as the reference's
``.pth`` files, which the options' ``path.pretrain_model_*`` keys name;
and the port's runner (options, dataset, loader, model, validation) must
land on the same three numbers at the same rel 1e-4, on the CPU. Any
drift in decode, the bicubic chain, matching, DCN or the metrics moves
them. GOLDEN is imported, so a deliberate re-pin moves both tests.

The runner also runs as ``python -m c2matching_tpu_torch.test`` with
jax, c2matching_tpu, cv2, PIL and yaml made unimportable.
"""
import os
import os.path as osp
import re
import subprocess
import sys

import jax
import pytest
import torch

from c2matching_tpu.models import create_model as jax_create_model
from c2matching_tpu.utils import dict_to_nonedict
from c2matching_tpu.utils.options import parse as jax_parse
from c2matching_tpu_torch.test import run
from c2matching_tpu_torch.utils import png, weights
from test_e2e_golden import GOLDEN

REPO = osp.abspath(osp.join(osp.dirname(__file__), osp.pardir))
SMOKE = osp.join(REPO, 'options', 'test', 'test_synth_smoke.yml')
BLOCKED = ('jax', 'c2matching_tpu', 'cv2', 'PIL', 'yaml')
# runs the CLI in a fresh interpreter where importing any of BLOCKED fails
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
sys.argv = ['c2matching_tpu_torch.test'] + sys.argv[1:]
runpy.run_module('c2matching_tpu_torch.test', run_name='__main__')
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
    root = tmp_path_factory.mktemp('synth_golden')
    subprocess.run(
        [sys.executable, osp.join(REPO, 'scripts', 'make_synth_dataset.py'),
         str(root), '--n', '3', '--size', '160'], check=True)
    return str(root)


@pytest.fixture(scope='module')
def options_file(synth_root, tmp_path_factory):
    """test_synth_smoke.yml with the synth set's paths and the JAX model's
    seeded weights as .pth files under path.pretrain_model_*."""
    out = tmp_path_factory.mktemp('golden_weights')
    opt = jax_parse(SMOKE, is_train=False)
    # compile time only: the residual trunks' unroll leaves the params as
    # they are (same layout, same init draws)
    opt['network_g']['trunk_unroll'] = 1
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
    for key, state in files.items():
        torch.save(state, str(out / f'{key}.pth'))
    del model
    jax.clear_caches()

    with open(SMOKE) as f:
        text = f.read().replace('./datasets/synth', synth_root)
    for key in files:
        path = str(out / f'{key}.pth')
        if f'  {key}: ~' in text:
            text = text.replace(f'  {key}: ~', f'  {key}: {path}')
        else:
            text = text.replace('  strict_load: true',
                                f'  {key}: {path}\n  strict_load: true')
    path = out / 'test_synth_smoke_golden.yml'
    path.write_text(text)
    return str(path)


def _check_golden(avgs):
    for k, want in GOLDEN.items():
        got = float(avgs[k])
        assert got == pytest.approx(want, rel=1e-4), (
            f'{k}: port got {got!r}, pinned {want!r}')


def test_port_validation_reproduces_golden(options_file, tmp_path,
                                           monkeypatch):
    """The port's runner, in process, on the CPU: the pinned metrics, and
    the restored images saved where the options file says."""
    monkeypatch.setenv('C2MATCHING_ROOT', str(tmp_path))
    results = run(options_file, device='cpu')
    assert list(results) == ['synth']
    _check_golden(results['synth'])
    vis = tmp_path / 'results' / 'synth_smoke' / 'visualization' / 'synth'
    for i in range(3):
        with open(vis / f'00{i}_1_synth_smoke.png', 'rb') as f:
            assert png.decode(f.read()).shape == (160, 160, 3)


def test_cli_runs_without_jax_cv2_pil_yaml(options_file, tmp_path):
    """``python -m c2matching_tpu_torch.test -opt ... --device cpu`` with
    jax, c2matching_tpu, cv2, PIL and yaml unimportable: exit 0, and the
    three metrics it logs are the pinned ones."""
    # two threads, as the in-process tests: the suite shares the host
    env = dict(os.environ, C2MATCHING_ROOT=str(tmp_path), PYTHONPATH=REPO,
               OMP_NUM_THREADS='2')
    proc = subprocess.run(
        [sys.executable, '-c', _GUARD.format(blocked=BLOCKED), '-opt',
         options_file, '--device', 'cpu'],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    m = re.search(r'# Validation synth # PSNR: (\S+) # PSNR_Y: (\S+) '
                  r'# SSIM_Y: (\S+)\.', log)
    assert m, log[-4000:]
    got = dict(zip(('psnr', 'psnr_y', 'ssim_y'), map(float, m.groups())))
    # the log prints 5 significant digits
    for k, want in GOLDEN.items():
        assert got[k] == pytest.approx(want, rel=1e-4), (k, got[k], want)


def test_cli_refuses_cuda_without_a_card(options_file, tmp_path,
                                         monkeypatch):
    """The default device is the card; without one the runner raises, it
    does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    monkeypatch.setenv('C2MATCHING_ROOT', str(tmp_path))
    with pytest.raises(RuntimeError, match='no CUDA card'):
        run(options_file)


def _tiny_opt(path=None, seed=0):
    return {
        'manual_seed': seed, 'path': path or {},
        'network_g': {'type': 'RestorationNet', 'ngf': 16, 'n_blocks': 1,
                      'groups': 8},
        'network_map': {'type': 'CorrespondenceGenerationArch',
                        'vgg_layer_list': ['relu1_1', 'relu2_1', 'relu3_1'],
                        'vgg_type': 'vgg19'},
        'network_extractor': {'type': 'ContrasExtractorSep'},
    }


def test_pretrain_paths_load_reference_pth_files(tmp_path):
    """A 'state_dict' wrapper and 'module.' prefixes are stripped, the
    torchvision VGG keys land in net_map, and under strict_load a file
    that lacks a weight raises; without it the model keeps its init."""
    from c2matching_tpu_torch.models import RefRestorationModel
    src = RefRestorationModel(_tiny_opt(seed=1), 'cpu')
    g = {'state_dict': {f'module.{k}': v
                        for k, v in src.net_g.state_dict().items()}}
    names = list(src.net_map.vgg.vgg_net)
    vgg = {}
    for key, value in src.net_map.state_dict().items():
        if key.startswith('vgg.vgg_net.'):
            name, leaf = key[len('vgg.vgg_net.'):].split('.')
            vgg[f'features.{weights.NAMES["vgg19"].index(name)}.{leaf}'] = \
                value
    paths = {'pretrain_model_g': str(tmp_path / 'g.pth'),
             'pretrain_model_feature_extractor': str(tmp_path / 'e.pth'),
             'pretrain_model_vgg': str(tmp_path / 'vgg.pth')}
    torch.save(g, paths['pretrain_model_g'])
    torch.save(src.net_extractor.state_dict(),
               paths['pretrain_model_feature_extractor'])
    torch.save(vgg, paths['pretrain_model_vgg'])
    dst = RefRestorationModel(_tiny_opt(dict(paths, strict_load=True)),
                              'cpu')
    for a, b in ((src.net_g, dst.net_g), (src.net_map, dst.net_map),
                 (src.net_extractor, dst.net_extractor)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                      b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb), ka

    first = names[0]
    vgg.pop(f'features.{weights.NAMES["vgg19"].index(first)}.weight')
    torch.save(vgg, paths['pretrain_model_vgg'])
    with pytest.raises(KeyError, match=first):
        RefRestorationModel(_tiny_opt(dict(paths, strict_load=True)), 'cpu')
    lax = RefRestorationModel(_tiny_opt(dict(paths, strict_load=False)),
                              'cpu')
    assert not torch.equal(lax.net_map.vgg.vgg_net[first].weight,
                           src.net_map.vgg.vgg_net[first].weight)
    with pytest.raises(ValueError, match='.pth'):
        RefRestorationModel(_tiny_opt({'pretrain_model_g': 'net_g.ckpt'}),
                            'cpu')
