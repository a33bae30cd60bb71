"""The port's JPEG decoder (``utils/jpeg.py``) against ``cv2.imdecode``, bit
for bit, and the paths that read JPEG.

- cv2-written files: quality 50, 75 and 95; 4:4:4, 4:2:2, 4:2:0, 4:4:0
  and 4:1:1 sampling and gray; odd sizes down to 1x1 (a chroma plane of
  1-2 samples takes plain replication); a restart interval; optimized
  Huffman tables; a CUFED5-sized image. Tolerance 0.
- The EXIF orientation tag (1-8, out-of-range values, both byte orders)
  turns the image as cv2 turns it.
- What the decoder does not take raises naming the mode: progressive,
  arithmetic-coded (a frame marker rewritten), 12-bit; a truncated file
  raises.
- ``imfrombytes`` tells PNG from JPEG by the magic bytes.
- ``create_cufed_lmdb`` on JPEG sources against the JAX packer:
  ``meta_info.txt`` byte for byte, every value decoding to the same
  pixels.
- ``augment(flow_list=...)`` and ``paired_random_crop`` against the JAX
  package's under one ``random.seed``.
"""
import os
import os.path as osp
import random
import struct
import subprocess
import sys

import cv2
import numpy as np
import pytest

from c2matching_tpu.data import transforms as jtransforms
from c2matching_tpu_torch.data import transforms as ttransforms
from c2matching_tpu_torch.scripts import create_cufed_lmdb
from c2matching_tpu_torch.utils import jpeg, png
from c2matching_tpu_torch.utils.util import imfrombytes

REPO = osp.abspath(osp.join(osp.dirname(__file__), osp.pardir))
SAMPLING = {
    '444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    '411': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
}


def _image(seed, h, w, c=3):
    """Smooth colour waves with noise: every frequency band non-zero."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 5.0 - k)
                     for k in range(c)], -1)
    img = np.clip(base + 20 * rng.randn(h, w, c), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _encode(img, *params):
    ok, buf = cv2.imencode('.jpg', img, list(params))
    assert ok
    return buf.tobytes()


def _same_as_cv2(data):
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    got = jpeg.decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('quality', [50, 75, 95])
@pytest.mark.parametrize('sampling', sorted(SAMPLING))
def test_decoder_equals_cv2(quality, sampling):
    img = _image(quality, 37, 53)
    _same_as_cv2(_encode(img, cv2.IMWRITE_JPEG_QUALITY, quality,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                         SAMPLING[sampling]))


@pytest.mark.parametrize('h,w', [(1, 1), (3, 2), (2, 9), (5, 9), (17, 33),
                                 (64, 48)])
@pytest.mark.parametrize('sampling', ['420', '422'])
def test_decoder_odd_sizes(h, w, sampling):
    _same_as_cv2(_encode(_image(h * w, h, w), cv2.IMWRITE_JPEG_QUALITY, 85,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                         SAMPLING[sampling]))


@pytest.mark.parametrize('params', [
    (cv2.IMWRITE_JPEG_RST_INTERVAL, 3),
    (cv2.IMWRITE_JPEG_RST_INTERVAL, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
    (cv2.IMWRITE_JPEG_OPTIMIZE, 1),
    (cv2.IMWRITE_JPEG_QUALITY, 100)])
def test_decoder_restarts_and_tables(params):
    data = _encode(_image(5, 45, 70), *params)
    if params[0] == cv2.IMWRITE_JPEG_RST_INTERVAL:
        assert b'\xff\xdd' in data and b'\xff\xd0' in data
    _same_as_cv2(data)


@pytest.mark.parametrize('h,w', [(33, 17), (8, 8), (1, 5)])
def test_decoder_gray(h, w):
    _same_as_cv2(_encode(_image(6, h, w, c=1), cv2.IMWRITE_JPEG_QUALITY, 80))


def test_decoder_cufed_size():
    _same_as_cv2(_encode(_image(7, 332, 500), cv2.IMWRITE_JPEG_QUALITY, 90))


@pytest.mark.parametrize('order', ['II', 'MM'])
@pytest.mark.parametrize('orientation', range(10))
def test_decoder_exif_orientation(order, orientation):
    """An APP1 Exif segment (an ASCII tag, then the orientation SHORT)
    inserted after SOI."""
    e = '<' if order == 'II' else '>'
    tiff = (order.encode() + struct.pack(e + 'HI', 42, 8)
            + struct.pack(e + 'H', 2)
            + struct.pack(e + 'HHI', 0x010F, 2, 4) + b'abc\0'
            + struct.pack(e + 'HHIHH', 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + 'I', 0))
    app1 = b'Exif\0\0' + tiff
    base = _encode(_image(11, 13, 21))
    data = (base[:2] + b'\xff\xe1' + struct.pack('>H', len(app1) + 2)
            + app1 + base[2:])
    _same_as_cv2(data)


def _sof_offset(data):
    return data.index(b'\xff\xc0')


def test_decoder_refusals():
    img = _image(8, 16, 16)
    with pytest.raises(ValueError, match='JPEG: progressive'):
        jpeg.decode(_encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    data = bytearray(_encode(img))
    sof = _sof_offset(bytes(data))
    arith = bytearray(data)
    arith[sof + 1] = 0xC9
    with pytest.raises(ValueError, match='JPEG: arithmetic-coded'):
        jpeg.decode(bytes(arith))
    deep = bytearray(data)
    deep[sof + 1] = 0xC1
    deep[sof + 4] = 12
    with pytest.raises(ValueError, match='JPEG: 12-bit'):
        jpeg.decode(bytes(deep))
    lossless = bytearray(data)
    lossless[sof + 1] = 0xC3
    with pytest.raises(ValueError, match='JPEG: lossless'):
        jpeg.decode(bytes(lossless))
    with pytest.raises(ValueError, match='JPEG'):
        jpeg.decode(bytes(data[:sof + 6]))


def test_imfrombytes_dispatch():
    img = _image(9, 12, 10)
    data = _encode(img)
    np.testing.assert_array_equal(imfrombytes(data), jpeg.decode(data))
    np.testing.assert_array_equal(imfrombytes(png.encode(img)), img)


def test_packer_on_jpeg_sources(tmp_path):
    src = tmp_path / 'src'
    for name in ('input', 'ref'):
        (src / name).mkdir(parents=True)
        for i, (h, w) in enumerate(((64, 64), (50, 70))):
            ext = '.jpg' if i == 0 else '.jpeg'
            (src / name / f'{i:03d}{ext}').write_bytes(_encode(
                _image(10 * i + len(name), h, w), cv2.IMWRITE_JPEG_QUALITY,
                80))
    jax_out, port_out = str(tmp_path / 'jax'), str(tmp_path / 'port')
    subprocess.run(
        [sys.executable, osp.join(REPO, 'scripts', 'create_cufed_lmdb.py'),
         '--in_dir', str(src / 'input'), '--ref_dir', str(src / 'ref'),
         '--out_root', jax_out, '--gt_size', '48'],
        check=True, capture_output=True)
    create_cufed_lmdb.main(['--in_dir', str(src / 'input'), '--ref_dir',
                            str(src / 'ref'), '--out_root', port_out,
                            '--gt_size', '48'])
    from c2matching_tpu_torch.utils import lmdb_shim
    for db in sorted(os.listdir(jax_out)):
        with open(osp.join(jax_out, db, 'meta_info.txt'), 'rb') as f:
            want_meta = f.read()
        with open(osp.join(port_out, db, 'meta_info.txt'), 'rb') as f:
            assert f.read() == want_meta, db
        jenv = lmdb_shim.open(osp.join(jax_out, db), readonly=True)
        penv = lmdb_shim.open(osp.join(port_out, db), readonly=True)
        with jenv.begin() as jtxn, penv.begin() as ptxn:
            for key in (b'000', b'001'):
                want = cv2.imdecode(np.frombuffer(jtxn.get(key), np.uint8),
                                    cv2.IMREAD_COLOR)
                np.testing.assert_array_equal(png.decode(ptxn.get(key)),
                                              want)
        jenv.close()
        penv.close()


@pytest.mark.parametrize('seed', range(6))
def test_augment_flows(seed):
    rng = np.random.RandomState(seed)
    imgs = [rng.rand(6, 9, 3).astype(np.float32) for _ in range(2)]
    flows = [rng.randn(6, 9, 2).astype(np.float32) for _ in range(2)]
    for n_flows in (1, 2):
        random.seed(seed)
        want_imgs, want_flows = jtransforms.augment(
            [i.copy() for i in imgs], True, True,
            [f.copy() for f in flows[:n_flows]])
        random.seed(seed)
        got_imgs, got_flows = ttransforms.augment(
            [i.copy() for i in imgs], True, True,
            [f.copy() for f in flows[:n_flows]])
        for got, want in ((got_imgs, want_imgs), (got_flows, want_flows)):
            got = got if isinstance(got, list) else [got]
            want = want if isinstance(want, list) else [want]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    random.seed(seed)
    want = jtransforms.paired_random_crop(imgs[0], imgs[1][::3, ::3], 6, 3)
    random.seed(seed)
    got = ttransforms.paired_random_crop(imgs[0], imgs[1][::3, ::3], 6, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
