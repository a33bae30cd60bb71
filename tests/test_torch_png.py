"""The port's PNG codec against cv2.

Decode must give cv2.imdecode(IMREAD_COLOR)'s pixels exactly on files
written by cv2 (libpng's adaptive row filters) and by PIL in every colour
type (gray at 1, 2 and 8 bits, RGB, RGBA, gray + alpha, palettes of 8
and 2 bits); the writer's files must read back through cv2.imread as
written. Interlaced and 16-bit files are refused.
"""
import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from c2matching_tpu_torch.utils import png
from c2matching_tpu_torch.utils.util import imfrombytes, imwrite


def _image(h=67, w=93, seed=0):
    """Gradients plus noise, so libpng picks a mix of row filters."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 2.3) % 256, (yy * 3.1) % 256,
                    ((xx + yy) * 1.7) % 256], -1) + rng.randn(h, w, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_decode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


@pytest.mark.parametrize('level', [0, 3, 9])
def test_decode_matches_cv2_on_cv2_files(level):
    img = _image(seed=level)
    ok, buf = cv2.imencode('.png', img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    assert ok
    np.testing.assert_array_equal(png.decode(buf.tobytes()),
                                  _cv2_decode(buf.tobytes()))


def _pil(mode):
    rgb = Image.fromarray(np.ascontiguousarray(_image()[..., ::-1]))
    if mode == 'P':
        return rgb.quantize(256), {}
    if mode == 'P2':
        return rgb.quantize(4), {}
    if mode == 'L2':
        return rgb.convert('L'), {'bits': 2}
    if mode == 'RGBA':
        im = rgb.convert('RGBA')
        im.putalpha(Image.fromarray(_image()[..., 0]))
        return im, {}
    return rgb.convert(mode), {}


@pytest.mark.parametrize('mode', ['L', 'L2', '1', 'RGB', 'RGBA', 'LA', 'P',
                                  'P2'])
@pytest.mark.parametrize('optimize', [False, True])
def test_decode_matches_cv2_on_pil_files(mode, optimize):
    im, opts = _pil(mode)
    buf = io.BytesIO()
    im.save(buf, 'PNG', optimize=optimize, **opts)
    data = buf.getvalue()
    got = png.decode(data)
    assert got.shape == (67, 93, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _cv2_decode(data))


def test_writer_round_trips_through_cv2(tmp_path):
    img = _image(seed=3)
    path = str(tmp_path / 'sub' / 'x.png')
    assert imwrite(img, path)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR), img)
    with open(path, 'rb') as f:
        np.testing.assert_array_equal(imfrombytes(f.read()), img)
    with pytest.raises(ValueError):
        imwrite(img, str(tmp_path / 'x.jpg'))
    with pytest.raises(ValueError):
        png.encode(img[..., 1])


def _with_header(data, **fields):
    """``data`` (a PNG) with IHDR fields replaced and its CRC redone."""
    names = ('width', 'height', 'depth', 'color', 'comp', 'filt',
             'interlace')
    values = dict(zip(names, struct.unpack('>IIBBBBB', data[16:29])))
    values.update(fields)
    ihdr = b'IHDR' + struct.pack('>IIBBBBB', *(values[n] for n in names))
    return data[:12] + ihdr + struct.pack('>I', zlib.crc32(ihdr)) + data[33:]


def test_refuses_interlaced_16_bit_and_corrupt():
    data = png.encode(_image())
    with pytest.raises(ValueError, match='interlaced'):
        png.decode(_with_header(data, interlace=1))
    ok, buf = cv2.imencode('.png', _image().astype(np.uint16) * 257)
    assert ok
    with pytest.raises(ValueError, match='16-bit'):
        png.decode(buf.tobytes())
    with pytest.raises(ValueError, match='CRC'):
        png.decode(data[:40] + bytes([data[40] ^ 1]) + data[41:])
    with pytest.raises(ValueError, match='signature'):
        png.decode(b'GIF89a' + data[6:])
