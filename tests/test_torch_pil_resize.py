"""The port's PIL bicubic resize, bit for bit against Pillow.

``data/pil_resize.py`` must equal ``Image.resize(size, Image.BICUBIC)`` on
uint8 RGB at the eval chain's sizes (the synth set's 160 -> 40 -> 160,
CUFED5's 500x332 -> 125x83 -> 500x332 and its padded 512x340) and on odd
sizes, up and down, one axis at a time.
"""
import numpy as np
import pytest
from PIL import Image

from c2matching_tpu_torch.data.pil_resize import resize_bicubic
from c2matching_tpu_torch.data.util import pil_chain_lq_up

from c2matching_tpu.data.util import pil_chain_lq_up as jax_chain


def _rgb(h, w, seed):
    rng = np.random.RandomState(seed)
    # gradients and edges, not only noise, so rounding near .5 occurs
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 // max(w - 1, 1)), (yy * 7) % 256,
                    ((xx // 5 + yy // 3) % 2) * 255], -1)
    img = np.where(rng.rand(h, w, 1) < 0.3, rng.randint(0, 256, (h, w, 3)),
                   img)
    return img.astype(np.uint8)


def _pil(img, size_wh):
    return np.asarray(Image.fromarray(img).resize(size_wh, Image.BICUBIC))


@pytest.mark.parametrize('hw,out_wh', [
    ((160, 160), (40, 40)), ((40, 40), (160, 160)),
    ((332, 500), (125, 83)), ((83, 125), (500, 332)),
    ((340, 512), (128, 85)), ((85, 128), (512, 340)),
    ((7, 9), (5, 31)), ((1, 5), (2, 3)), ((13, 17), (4, 13)),
    ((300, 200), (201, 299)), ((5, 5), (1, 1)), ((17, 3), (3, 50)),
])
def test_resize_bit_for_bit(hw, out_wh):
    img = _rgb(*hw, seed=hw[0] * 7 + hw[1])
    got = resize_bicubic(img, out_wh)
    want = _pil(img, out_wh)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('hw', [(160, 160), (332, 500), (340, 512)])
def test_chain_lq_up_equals_jax(hw):
    img = _rgb(*hw, seed=1).astype(np.float32)[..., ::-1] / 255.
    for got, want in zip(pil_chain_lq_up(img, 4), jax_chain(img, 4)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_refusals():
    img = _rgb(31, 23, 4)
    for bad in (img.astype(np.float32), img[..., 0]):
        with pytest.raises(ValueError):
            resize_bicubic(bad, (9, 9))
    with pytest.raises(ValueError):
        resize_bicubic(img, (0, 9))
