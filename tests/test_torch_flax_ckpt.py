"""The port reads the JAX package's flax ``.ckpt`` files
(``c2matching_tpu_torch/utils/flax_msgpack.py`` and
``models/base_model.py::load_state_dict_file``), and the shipped debug
configs chain stage 1 to stage 2 through the ``.pth`` the port writes
beside the ``.ckpt`` they name.

- The reader against ``flax.serialization.msgpack_restore`` on the JAX
  model's own ``save_network`` files for G, D and the extractor (and its
  VGG19 tree), and on a G file written with flax's chunk size lowered so
  that its arrays are ``__msgpack_chunked_array__`` maps; scalars, complex
  numbers and the msgpack integer and string widths.
- ``load_network`` on each ``.ckpt`` gives the state dict of the ``.pth``
  route (``utils/weights.py`` then ``torch.save``), in a process where
  jax, flax and msgpack cannot be imported.
- A ``.ckpt`` that does not exist loads the ``.pth`` of its stem, with a
  warning; neither raises. ``path.checkpoint_backend: orbax`` warns.
- ``python -m c2matching_tpu_torch.train --device cpu`` on
  ``debug_stage1_synth.yml`` then ``debug_stage2_synth.yml``, both as
  shipped, from a directory holding ``datasets/synth``: stage 2's teacher
  is stage 1's ``net_g_latest.pth``.
"""
import contextlib
import logging
import os
import os.path as osp
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import torch_train_common as common
from c2matching_tpu.models import create_model as jax_create_model
from c2matching_tpu_torch.models import RefRestorationModel
from c2matching_tpu_torch.models.base_model import load_state_dict_file
from c2matching_tpu_torch.scripts import make_synth_dataset as synth
from c2matching_tpu_torch.utils import flax_msgpack, weights

REPO = common.REPO
BLOCKED = ('jax', 'flax', 'msgpack', 'c2matching_tpu', 'cv2', 'PIL', 'yaml')
_GUARD = '''
import importlib.abc, sys
BLOCKED = {blocked!r}
for name in list(sys.modules):
    if name.split('.')[0] in BLOCKED:
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(name + ' is blocked for this run')
        return None

sys.meta_path.insert(0, Block())
import os.path as osp
import torch
from c2matching_tpu_torch.models.base_model import load_state_dict_file
# net_<kind>_1.ckpt
torch.save({{f: load_state_dict_file(f, osp.basename(f)[4:-7])
            for f in sys.argv[1:-1]}}, sys.argv[-1])
'''


@pytest.fixture(scope='module')
def saved(tmp_path_factory):
    """The JAX model's ``.ckpt`` files: {kind: path}, and its variables."""
    tmp = tmp_path_factory.mktemp('flax_ckpt')
    opt = common.small_opt(str(tmp), str(tmp / 'jax'), with_d=True)
    jmodel = jax_create_model(opt)
    trees = {'g': jmodel.vars_g, 'd': jmodel.vars_d,
             'extractor': jmodel.vars_extractor, 'vgg19': jmodel.vars_map}
    paths = {}
    for kind, tree in trees.items():
        jmodel.save_network(tree, f'net_{kind}', 1)
        paths[kind] = osp.join(opt['path']['models'], f'net_{kind}_1.ckpt')
    real = serialization.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = 2 ** 10
    try:
        jmodel.save_network(jmodel.vars_g, 'net_chunked', 1)
    finally:
        serialization.MAX_CHUNK_SIZE = real
    paths['chunked'] = osp.join(opt['path']['models'], 'net_chunked_1.ckpt')
    return paths, {k: jax.device_get(v) for k, v in trees.items()}, tmp


def _same_tree(a, b, path=''):
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray)), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same_tree(a[k], b[k], f'{path}/{k}')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize('kind', ('g', 'd', 'extractor', 'vgg19',
                                  'chunked'))
def test_reader_equals_flax(saved, kind):
    paths, _, _ = saved
    with open(paths[kind], 'rb') as f:
        data = f.read()
    if kind == 'chunked':
        assert b'__msgpack_chunked_array__' in data
    _same_tree(flax_msgpack.restore(data), serialization.msgpack_restore(data))


def test_reader_scalars_and_widths():
    tree = {'f32': np.float32(1.5), 'i64': np.int64(-3), 'c': 2 - 1j,
            'big': 2 ** 40, 'neg': -2 ** 33, 'small': -5, 'u16': 60000,
            'f': 0.25, 'none': None, 'flag': True, 's' * 40: 'x' * 300,
            'list': [1, 2.5, 'a'], 'empty': np.zeros((0, 3), np.float64),
            'i8': np.arange(-4, 4, dtype=np.int8).reshape(2, 4)}
    data = serialization.msgpack_serialize(tree)
    got = flax_msgpack.restore(data)
    want = serialization.msgpack_restore(data)
    assert got.pop('list') == want.pop('list') == [1, 2.5, 'a']
    _same_tree(got, want)
    assert isinstance(got['f32'], np.float32) and got['c'] == 2 - 1j
    with pytest.raises(ValueError, match='ends inside'):
        flax_msgpack.restore(data[:-3])


def test_bfloat16_leaves_widen_exactly():
    import jax.numpy as jnp
    values = np.array([1.0, -2.5, 3.140625, 1e-3], np.float32)
    data = serialization.msgpack_serialize(
        {'w': np.asarray(jnp.asarray(values, jnp.bfloat16))})
    got = flax_msgpack.restore(data)['w']
    want = np.asarray(serialization.msgpack_restore(data)['w'], np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@contextlib.contextmanager
def _base_warnings(caplog):
    """caplog's handler on the port's 'base' logger, which does not
    propagate once the runners have set it up."""
    logger = logging.getLogger('base')
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger='base'):
            yield
    finally:
        logger.removeHandler(caplog.handler)


BRIDGE = {'g': weights.restoration_net_state_dict,
          'd': weights.discriminator_state_dict,
          'extractor': weights.contras_extractor_state_dict,
          'vgg19': weights.torchvision_vgg_state_dict}


def test_ckpt_loads_like_its_pth_without_jax(saved, tmp_path):
    paths, trees, _ = saved
    out = str(tmp_path / 'loaded.pt')
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='2')
    files = [paths[k] for k in BRIDGE]
    proc = subprocess.run(
        [sys.executable, '-c', _GUARD.format(blocked=BLOCKED), *files, out],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    loaded = torch.load(out, weights_only=True)
    for kind, bridge in BRIDGE.items():
        want = bridge(trees[kind])
        pth = str(tmp_path / f'{kind}.pth')
        torch.save(want, pth)
        for got in (loaded[paths[kind]], load_state_dict_file(paths[kind],
                                                              kind)):
            assert list(got) == list(load_state_dict_file(pth))
            for k, v in want.items():
                assert torch.equal(got[k], v), (kind, k)


def test_model_loads_ckpt_paths(saved):
    """pretrain_model_g, _feature_extractor, _vgg and _d as flax files
    give the nets the JAX variables bridged."""
    paths, trees, tmp = saved
    opt = common.small_opt(str(tmp), str(tmp / 'port'), with_d=True)
    opt['path'].update(pretrain_model_g=paths['g'],
                       pretrain_model_feature_extractor=paths['extractor'],
                       pretrain_model_vgg=paths['vgg19'],
                       pretrain_model_d=paths['d'], strict_load=True)
    model = RefRestorationModel(opt, 'cpu')
    for net, kind in ((model.net_g, 'g'), (model.net_extractor, 'extractor'),
                      (model.net_d, 'd')):
        for k, v in BRIDGE[kind](trees[kind]).items():
            if k.endswith('num_batches_tracked'):
                continue
            assert torch.equal(net.state_dict()[k], v), (kind, k)
    want = weights.corres_generation_state_dict(trees['vgg19'])
    for k, v in model.net_map.state_dict().items():
        if k.startswith('vgg.vgg_net.'):
            assert torch.equal(v, want[k]), k


def test_missing_ckpt_takes_the_pth_beside_it(tmp_path, caplog):
    state = {'w': torch.arange(3.)}
    torch.save(state, tmp_path / 'net_g_latest.pth')
    with _base_warnings(caplog):
        got = load_state_dict_file(str(tmp_path / 'net_g_latest.ckpt'), 'g')
    assert torch.equal(got['w'], state['w'])
    assert any('net_g_latest.pth' in r.getMessage()
               and r.levelno == logging.WARNING for r in caplog.records)
    with pytest.raises(ValueError, match=r'\.pth'):
        load_state_dict_file(str(tmp_path / 'net_d_latest.ckpt'), 'd')
    with pytest.raises(ValueError, match='orbax'):
        load_state_dict_file(str(tmp_path / 'net_g.orbax'))


def test_orbax_backend_warns(caplog, tmp_path):
    opt = {'manual_seed': 0, 'path': {'checkpoint_backend': 'orbax'},
           'network_g': {'type': 'RestorationNet', 'ngf': 16, 'n_blocks': 1,
                         'groups': 8},
           'network_map': {'type': 'CorrespondenceGenerationArch',
                           'vgg_layer_list': ['relu1_1', 'relu2_1',
                                              'relu3_1'],
                           'vgg_type': 'vgg19'},
           'network_extractor': {'type': 'ContrasExtractorSep'}}
    with _base_warnings(caplog):
        RefRestorationModel(opt, 'cpu')
    assert any('orbax' in r.getMessage() and '.pth' in r.getMessage()
               for r in caplog.records)


def test_shipped_debug_configs_chain_stage1_to_stage2(tmp_path):
    synth.write_dataset(str(tmp_path / 'datasets' / 'synth'), n=3,
                        size=(160,))
    env = dict(os.environ, C2MATCHING_ROOT=str(tmp_path), PYTHONPATH=REPO,
               OMP_NUM_THREADS='2')
    logs = []
    for stage in (1, 2):
        cfg = osp.join(REPO, 'options', 'train',
                       f'debug_stage{stage}_synth.yml')
        proc = subprocess.run(
            [sys.executable, '-m', 'c2matching_tpu_torch.train', '-opt', cfg,
             '--device', 'cpu'], cwd=str(tmp_path), env=env,
            capture_output=True, text=True, timeout=300)
        logs.append(proc.stdout + proc.stderr)
        assert proc.returncode == 0, logs[-1][-4000:]
    teacher = './experiments/debug_stage1_synth/models/net_g_latest'
    assert f'{teacher}.ckpt does not exist; loading {teacher}.pth' in logs[1]
    assert sorted(os.listdir(tmp_path / 'experiments' / 'debug_stage2_synth'
                             / 'models')) == ['net_student_8.pth',
                                              'net_student_latest.pth']
