"""Host-side image transforms (numpy, HWC).

Counterpart of ``c2matching_tpu/data/transforms.py`` (``mod_crop``,
``to_rgb_hwc``); the train-time crops and flips wait for the training
slice.
"""
import numpy as np


def mod_crop(img, scale):
    """Crop an image so its spatial dims are multiples of scale."""
    img = np.copy(img)
    if img.ndim in (2, 3):
        h, w = img.shape[0], img.shape[1]
        h_remainder, w_remainder = h % scale, w % scale
        img = img[:h - h_remainder or None, :w - w_remainder or None, ...]
    else:
        raise ValueError(f'Wrong img ndim: {img.ndim}.')
    return img


def to_rgb_hwc(imgs, bgr2rgb=True):
    """BGR HWC float -> RGB HWC float32 numpy (NHWC framework layout)."""

    def _convert(img):
        if img.ndim == 3 and img.shape[2] == 3 and bgr2rgb:
            img = img[..., ::-1]
        return np.ascontiguousarray(img, dtype=np.float32)

    if isinstance(imgs, list):
        return [_convert(img) for img in imgs]
    return _convert(imgs)
