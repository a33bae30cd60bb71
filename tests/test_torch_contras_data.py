"""The port's contrastive data against cv2 and the JAX package, on the
CPU.

- ``data/warp.py``: ``get_perspective_transform`` and ``warp_perspective``
  bit for bit against cv2 on homographies drawn as
  ``image_pair_generation`` draws them, at the dataset's shapes and at
  widths whose last columns take OpenCV's one-by-one loop;
  ``resize_cubic`` bit for bit against cv2 on float64 images and at equal
  sizes. On float32 images cv2 5 resizes through Intel IPP, whose weights
  differ from OpenCV's own in the last bits: there the test bounds the
  difference at what was measured (max |d| 1.75e-05 at 332x500 -> 160,
  9.0e-06 at 160 -> 96, 3e-07 when enlarging).
- ``ContrasDataset`` / ``ContrasValDataset`` items bit for bit against the
  JAX package's under the same ``random`` and ``np.random`` seeds on a
  synth set at 160 (``gt_size`` 160: the resize is a copy). At 200 the
  train items take the float32 resize: the images there are bounded as
  above, and the uint8 values the degradation chain reads are held to the
  measured flip share (1 of 921600 bytes; the up-sampled images come out
  equal).
- The synth generator's ``--ref-size`` against the JAX script's (a
  float32 resize too: 2e-05 to 4e-05 of the reference bytes differ, by 1).
- The port's contrastive data and models import without jax, cv2, PIL or
  yaml.
"""
import copy
import os.path as osp
import random
import subprocess
import sys

import cv2
import numpy as np
import pytest

from c2matching_tpu.data.contras_dataset import (ContrasDataset as JaxDataset,
                                                 ContrasValDataset as JaxVal)
from c2matching_tpu_torch.data import (ContrasDataset, ContrasValDataset,
                                       DATASETS, warp)
from c2matching_tpu_torch.data.contras_dataset import image_pair_generation
from c2matching_tpu_torch.scripts import make_synth_dataset as synth

REPO = osp.abspath(osp.join(osp.dirname(__file__), osp.pardir))
KEYS = ('img_in', 'img_in_up', 'img_ref', 'img_ref_up',
        'transformed_coordinate')
# measured float32 differences against cv2's IPP resize (see the docstring)
RESIZE_F32_MAX = {(332, 500, 160, 160): 1.8e-05, (160, 160, 96, 96): 1e-05,
                  (120, 90, 160, 160): 3e-07, (200, 200, 160, 160): 3e-07}
ITEM_F32_MAX = 3e-07   # img_in / img_ref of the 200 -> 160 train items
ITEM_FLIPS = 2e-06     # their uint8 bytes that differ (measured 1.1e-06)
SYNTH_REF_FLIPS = 1e-4  # share of reference bytes off by one (measured 4e-5)


def draw(rng, h, w):
    """(rect1, rect2, H, H^-1) as image_pair_generation draws them."""
    crop_s, lo, hi = 160, 0, 10
    x_tl = rng.randint(hi, max(w, w - crop_s - hi))
    y_tl = rng.randint(hi, max(h, h - crop_s - hi))
    rect1 = np.array([(x_tl, y_tl), (x_tl + crop_s, y_tl),
                      (x_tl + crop_s, y_tl + crop_s), (x_tl, y_tl + crop_s)],
                     dtype=np.float32)
    rect2 = np.array([(x + rng.randint(lo, hi) * rng.choice([-1.0, 1.0]),
                       y + rng.randint(lo, hi) * rng.choice([-1.0, 1.0]))
                      for x, y in rect1], dtype=np.float32)
    homography = cv2.getPerspectiveTransform(src=rect1, dst=rect2)
    return rect1, rect2, homography, np.linalg.inv(homography)


def test_perspective_transform_bit_exact():
    rng = np.random.RandomState(0)
    for _ in range(200):
        h, w = rng.randint(160, 600, 2)
        rect1, rect2, want, _ = draw(rng, h, w)
        got = warp.get_perspective_transform(rect1, rect2)
        np.testing.assert_array_equal(got, want)
    # an arbitrary quadrilateral, off the generator's integer corners
    src = rng.uniform(0, 300, (4, 2)).astype(np.float32)
    dst = src + rng.uniform(-20, 20, (4, 2)).astype(np.float32)
    want = cv2.getPerspectiveTransform(src, dst)
    got = warp.get_perspective_transform(src, dst)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize('h,w', [(160, 160), (332, 500), (96, 97), (64, 48),
                                 (17, 40), (5, 3), (33, 72)])
def test_warp_bit_exact(h, w):
    rng = np.random.RandomState(h * 1000 + w)
    for trial in range(4):
        _, _, _, h_inv = draw(rng, 160, 160) if trial % 2 else \
            draw(rng, max(h, 11), max(w, 11))
        img = rng.rand(h, w, 3).astype(np.float32)
        np.testing.assert_array_equal(
            warp.warp_perspective(img, h_inv, (w, h)),
            cv2.warpPerspective(src=img, M=h_inv, dsize=(w, h)))
    # an output size other than the input's
    np.testing.assert_array_equal(
        warp.warp_perspective(img, h_inv, (w + 3, h + 1)),
        cv2.warpPerspective(img, h_inv, (w + 3, h + 1)))


def test_warp_borders():
    """A shift by a fraction of a pixel reads the 0 border on one side; a
    shift past the image gives zeros."""
    img = np.random.RandomState(1).rand(40, 50, 3).astype(np.float32)
    for tx, ty in ((0.3, -0.7), (-12.25, 3.5), (60.0, 0.0), (1e-3, 1e-3)):
        m = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float64)
        np.testing.assert_array_equal(
            warp.warp_perspective(img, m, (50, 40)),
            cv2.warpPerspective(img, m, (50, 40)))


@pytest.mark.parametrize('h,w,ho,wo', [(120, 90, 160, 160),
                                       (200, 200, 160, 160),
                                       (160, 160, 96, 96),
                                       (332, 500, 160, 160),
                                       (37, 53, 71, 29)])
def test_resize_cubic(h, w, ho, wo):
    rng = np.random.RandomState(h + w)
    img = rng.rand(h, w, 3)
    np.testing.assert_array_equal(
        warp.resize_cubic(img, (wo, ho)),
        cv2.resize(img, (wo, ho), interpolation=cv2.INTER_CUBIC))
    img32 = img.astype(np.float32)
    got = warp.resize_cubic(img32, (wo, ho))
    want = cv2.resize(img32, (wo, ho), interpolation=cv2.INTER_CUBIC)
    assert got.dtype == np.float32
    err = np.abs(got - want).max()
    assert err <= RESIZE_F32_MAX.get((h, w, ho, wo), 2.2e-06), err


def test_resize_same_size_is_a_copy():
    img = np.random.RandomState(2).rand(160, 160, 3).astype(np.float32)
    got = warp.resize_cubic(img, (160, 160))
    np.testing.assert_array_equal(
        got, cv2.resize(img, (160, 160), interpolation=cv2.INTER_CUBIC))
    assert got is not img


@pytest.fixture(scope='module')
def synth_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp('contras_data')
    sets = {}
    for size in (160, 200):
        sets[size] = str(root / f'synth{size}')
        synth.write_dataset(sets[size], n=3, size=(size,))
    return sets


def _opt(root, phase='train'):
    return {'name': 'synth', 'phase': phase, 'scale': 4,
            'dataroot_in': f'{root}/input', 'dataroot_ref': f'{root}/ref',
            'io_backend': {'type': 'disk'}, 'ann_file': f'{root}/pairs.txt',
            'gt_size': 160, 'use_flip': True, 'use_rot': True}


def _items(cls, opt, seed, n=3):
    random.seed(seed)
    np.random.seed(seed)
    ds = cls(copy.deepcopy(opt))
    return [ds[i] for i in range(n)]


def test_registered():
    assert DATASETS['ContrasDataset'] is ContrasDataset
    assert DATASETS['ContrasValDataset'] is ContrasValDataset


@pytest.mark.parametrize('seed', [0, 3])
def test_train_items_equal_jax_at_160(synth_sets, seed):
    opt = _opt(synth_sets[160])
    for got, want in zip(_items(ContrasDataset, opt, seed),
                         _items(JaxDataset, opt, seed)):
        assert set(got) == set(want)
        for k in KEYS:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_items_at_200_take_the_resize(synth_sets):
    """200 -> 160: the float32 resize. The coordinate grids are equal; the
    images within the measured bound, and the uint8 bytes the PIL chain
    reads flip at most at the measured share."""
    opt = _opt(synth_sets[200])
    flips, total = 0, 0
    for seed in (1, 2):
        for got, want in zip(_items(ContrasDataset, opt, seed),
                             _items(JaxDataset, opt, seed)):
            np.testing.assert_array_equal(got['transformed_coordinate'],
                                          want['transformed_coordinate'])
            for k in ('img_in', 'img_ref'):
                assert np.abs(got[k] - want[k]).max() <= ITEM_F32_MAX, k
                a = (got[k] * 255).astype(np.uint8)
                b = (want[k] * 255).astype(np.uint8)
                flips += int((a != b).sum())
                total += a.size
            for k in ('img_in_up', 'img_ref_up'):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert flips <= ITEM_FLIPS * total, f'{flips} of {total} bytes flipped'


@pytest.mark.parametrize('size', [160, 200])
def test_val_items_equal_jax(synth_sets, size):
    opt = _opt(synth_sets[size], phase='val')
    got = ContrasValDataset(copy.deepcopy(opt))
    want = JaxVal(copy.deepcopy(opt))
    for a, b in zip(got.transform_matrices, want.transform_matrices):
        np.testing.assert_array_equal(a, b)
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert g['name'] == w['name']
        for k in KEYS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_pair_generation_equals_jax():
    from c2matching_tpu.data.contras_dataset import \
        image_pair_generation as jax_generation
    img = np.random.RandomState(4).rand(180, 170, 3).astype(np.float32)
    outs = []
    for fn in (image_pair_generation, jax_generation):
        np.random.seed(9)
        outs.append(fn(img, (0, 10), 160) + (fn(None, (0, 32), 160),))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_synth_ref_size_equals_jax_script(tmp_path):
    """--ref-size through resize_cubic against the JAX script's cv2 resize
    (float32: a few bytes differ by one, as measured)."""
    ours, theirs = str(tmp_path / 'port'), str(tmp_path / 'jax')
    synth.main([ours, '--n', '3', '--size', '120', '90', '--ref-size', '160',
                '200'])
    subprocess.run([sys.executable, osp.join(REPO, 'scripts',
                                             'make_synth_dataset.py'),
                    theirs, '--n', '3', '--size', '120', '90', '--ref-size',
                    '160', '200'], check=True, capture_output=True)
    with open(f'{ours}/pairs.txt') as f, open(f'{theirs}/pairs.txt') as g:
        assert f.read() == g.read()
    for i in range(3):
        a = cv2.imread(f'{ours}/input/{i:03d}_0.png')
        b = cv2.imread(f'{theirs}/input/{i:03d}_0.png')
        np.testing.assert_array_equal(a, b)
        a = cv2.imread(f'{ours}/ref/{i:03d}_1.png')
        b = cv2.imread(f'{theirs}/ref/{i:03d}_1.png')
        assert a.shape == b.shape == (160, 200, 3)
        d = np.abs(a.astype(int) - b)
        assert d.max() <= 1 and (d > 0).mean() <= SYNTH_REF_FLIPS


_GUARD = '''
import importlib.abc, sys
BLOCKED = ('jax', 'c2matching_tpu', 'cv2', 'PIL', 'yaml')

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(name + ' is blocked for this run')
        return None

sys.meta_path.insert(0, Block())
from c2matching_tpu_torch.data import ContrasValDataset
from c2matching_tpu_torch.models import (StudentContrasDistillationModel,
                                         TeacherContrasModel)
root = sys.argv[1]
ds = ContrasValDataset({'name': 'v', 'phase': 'val', 'scale': 4,
                        'dataroot_in': root + '/input',
                        'dataroot_ref': root + '/ref',
                        'io_backend': {'type': 'disk'},
                        'ann_file': root + '/pairs.txt'})
print(sorted(ds[0]))
'''


def test_port_needs_no_jax_cv2_pil_yaml(synth_sets):
    proc = subprocess.run([sys.executable, '-c', _GUARD, synth_sets[160]],
                          env={'PYTHONPATH': REPO, 'PATH': '/usr/bin:/bin'},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'transformed_coordinate' in proc.stdout
