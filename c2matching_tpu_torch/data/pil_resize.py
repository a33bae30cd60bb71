"""PIL's bicubic resize of uint8 images, bit for bit, in numpy.

Counterpart of ``Image.resize(size, Image.BICUBIC)`` on an RGB image (no
box, no ``reducing_gap``), which the eval data chain
(``c2matching_tpu/data/util.py:120-135``) calls. The arithmetic is
Pillow's ``libImaging/Resample.c``:

- the cubic filter with a = -0.5 and support 2, widened by
  max(1, in/out) when shrinking;
- per output pixel, the taps from round(center - support) to
  round(center + support) clipped to the image, each weight
  filter((x - center + 0.5) / filterscale), normalised by their sum in
  double;
- the weights rounded to int32 fixed point with 22 fractional bits, half
  away from zero;
- per pass, the sum starts at 1 << 21, then shifts right by 22 and clips
  to [0, 255];
- the horizontal pass first, into a uint8 image, then the vertical pass;
  a pass whose size does not change is skipped.

The metrics read uint8 images, so a single LSB off would move PSNR.
"""
import numpy as np

_PRECISION_BITS = 32 - 8 - 2
_SUPPORT = 2.0


def _bicubic(x):
    """Pillow's bicubic_filter (a = -0.5), elementwise on float64."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size, out_size):
    """(first tap (out,), int weights (out, ksize)) for one axis, as
    precompute_coeffs + normalize_coeffs_8bpc compute them."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; below 0 both clip to 0 anyway
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    ss = 1.0 / filterscale
    w = _bicubic(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
                 * ss)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    # the sum in tap order, as the C loop adds
    ww = np.zeros(out_size)
    for t in range(ksize):
        ww = ww + w[:, t]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    scaled = w * (1 << _PRECISION_BITS)
    fixed = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5))
    return xmin, fixed.astype(np.int64)


def _pass(img, axis, out_size):
    """One resampling pass of an (H, W, C) uint8 image along ``axis``."""
    xmin, k = _coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    last = src.shape[0] - 1
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for t in range(k.shape[1]):
        # taps past xmax carry weight 0; clip their index into the image
        idx = np.minimum(xmin + t, last)
        acc += src[idx] * k[:, t, None, None]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img, size_wh):
    """PIL ``Image.resize(size_wh, Image.BICUBIC)`` of a uint8 (H, W, C)
    array, channels resampled alike. Returns uint8 (h, w, C) for size_wh =
    (w, h)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f'resize_bicubic takes uint8 (H, W, C), got '
                         f'{img.dtype} {img.shape}')
    out_w, out_h = (int(v) for v in size_wh)
    if out_w < 1 or out_h < 1:
        raise ValueError(f'resize_bicubic: size {size_wh} must be positive')
    if out_w != img.shape[1]:
        img = _pass(img, 1, out_w)
    if out_h != img.shape[0]:
        img = _pass(img, 0, out_h)
    return img
