"""The port's eval data pipeline against the JAX package's, bit for bit.

RefCUFEDDataset (decode, mod-crop, pad to a common size, the PIL-bicubic
chain) must give every array and field of c2matching_tpu.data's on the
synth set and on a CUFED5-shaped pair whose reference is larger (the
padding branch); the loader batches them as the JAX one does; and the
port's synth generator writes the JAX script's pixels.
"""
import os
import os.path as osp
import subprocess
import sys

import cv2
import numpy as np
import pytest

from c2matching_tpu.data import RefCUFEDDataset as JaxDataset
from c2matching_tpu.data.loader import default_collate as jax_collate
from c2matching_tpu_torch.data import (RefCUFEDDataset, create_dataloader,
                                       create_dataset)
from c2matching_tpu_torch.data.file_client import FileClient
from c2matching_tpu_torch.scripts import make_synth_dataset as synth
from c2matching_tpu_torch.utils.util import imwrite

REPO = osp.abspath(osp.join(osp.dirname(__file__), osp.pardir))
SCRIPT = osp.join(REPO, 'scripts', 'make_synth_dataset.py')


def _opt(root, ann=True, **extra):
    opt = dict(name='synth', type='RefCUFEDDataset', phase='test', scale=4,
               dataroot_in=osp.join(root, 'input'),
               dataroot_ref=osp.join(root, 'ref'), io_backend={'type': 'disk'},
               ann_file=osp.join(root, 'pairs.txt') if ann else None)
    opt.update(extra)
    return opt


@pytest.fixture(scope='module')
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('synth'))
    subprocess.run([sys.executable, SCRIPT, root, '--n', '3', '--size',
                    '160'], check=True)
    return root


@pytest.fixture(scope='module')
def cufed_root(tmp_path_factory):
    """One CUFED5-shaped pair: input 332x500, reference 340x512, written
    with the port's PNG writer; folder layout (no annotation file)."""
    root = str(tmp_path_factory.mktemp('cufed'))
    rng = np.random.RandomState(1)
    imwrite(synth.to_bgr_u8(synth.synth_image(rng, 332, 500)),
            osp.join(root, 'input', '000_0.png'))
    imwrite(synth.to_bgr_u8(synth.synth_image(rng, 340, 512)),
            osp.join(root, 'ref', '000_0.png'))
    return root


def _assert_items_equal(got, want):
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert type(g) is type(w) and g == w, (key, g, w)


@pytest.mark.parametrize('case', ['synth', 'cufed_padded'])
def test_dataset_equals_jax(case, synth_root, cufed_root):
    opt = (_opt(synth_root) if case == 'synth'
           else _opt(cufed_root, ann=False))
    port, ref = RefCUFEDDataset(dict(opt)), JaxDataset(dict(opt))
    assert len(port) == len(ref) == (3 if case == 'synth' else 1)
    for i in range(len(ref)):
        item = port[i]
        _assert_items_equal(item, ref[i])
    if case == 'cufed_padded':
        assert item['padding'] is True
        assert item['original_size'] == (332, 500)
        assert item['img_in'].shape == (332, 500, 3)
        assert item['img_ref'].shape == (340, 512, 3)
        assert item['img_in_lq'].shape == (85, 128, 3)


def test_loader_batches_as_jax(synth_root):
    opt = _opt(synth_root)
    dataset = create_dataset(opt)
    loader = create_dataloader(dataset, opt)
    batches = list(loader)
    assert len(loader) == len(batches) == 3
    for i, batch in enumerate(batches):
        _assert_items_equal(batch, jax_collate([JaxDataset(opt)[i]]))
        assert batch['img_in_lq'].shape == (1, 40, 40, 3)


def test_refusals(synth_root):
    # lmdb takes two *.lmdb databases, as the JAX package's does
    with pytest.raises(ValueError, match='should both in lmdb formats'):
        RefCUFEDDataset(_opt(synth_root, io_backend={'type': 'lmdb'}))
    with pytest.raises(ImportError, match='memcached'):
        FileClient('memcached', server_list_cfg=None, client_cfg=None)
    with pytest.raises(ValueError, match='not supported'):
        FileClient('s3')
    with pytest.raises(ValueError, match='not ported'):
        create_dataset(_opt(synth_root, type='UnknownDataset'))
    with pytest.raises(ValueError, match='phase'):
        create_dataloader(None, {'phase': 'bogus'})


@pytest.mark.parametrize('layout,size', [('cufed', ['160']),
                                         ('wrsr', ['48', '64'])])
def test_synth_generator_equals_jax_script(layout, size, tmp_path):
    jax_root, port_root = str(tmp_path / 'jax'), str(tmp_path / 'port')
    args = ['--n', '2', '--size', *size, '--layout', layout]
    subprocess.run([sys.executable, SCRIPT, jax_root, *args], check=True)
    synth.main([port_root, *args])
    with open(osp.join(jax_root, 'pairs.txt')) as f:
        pairs = f.read()
    with open(osp.join(port_root, 'pairs.txt')) as f:
        assert f.read() == pairs
    for sub in ('input', 'ref'):
        names = sorted(os.listdir(osp.join(jax_root, sub)))
        assert names == sorted(os.listdir(osp.join(port_root, sub)))
        for name in names:
            np.testing.assert_array_equal(
                cv2.imread(osp.join(port_root, sub, name)),
                cv2.imread(osp.join(jax_root, sub, name)))
    # --ref-size resizes the reference (held against the JAX script in
    # tests/test_torch_contras_data.py)
    synth.main([str(tmp_path / 'x'), '--n', '1', '--size', '32',
                '--ref-size', '40'])
    assert cv2.imread(str(tmp_path / 'x' / 'input' / '000_0.png')).shape \
        == (32, 32, 3)
    assert cv2.imread(str(tmp_path / 'x' / 'ref' / '000_1.png')).shape \
        == (40, 40, 3)
