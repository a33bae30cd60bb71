"""Host-side image transforms (numpy, HWC).

Counterpart of ``c2matching_tpu/data/transforms.py`` (``mod_crop``,
``augment``, ``to_rgb_hwc``). ``augment`` draws its flips and rotation
with the same three ``random.random()`` calls, in the same order, as the
JAX package. ``paired_random_crop`` (no stage-3 dataset crops) is not
ported.
"""
import random

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


def augment(img_list, hflip=True, rotation=True):
    """Random horizontal / vertical flip and 90-degree rotation (a
    transpose), the same draw for every entry of ``img_list``. The JAX
    package's ``flow_list`` (flows that turn with the image) serves no
    stage-3 dataset and is not ported."""
    hflip = hflip and random.random() < 0.5
    vflip = rotation and random.random() < 0.5
    rot90 = rotation and random.random() < 0.5

    def _augment(img):
        if hflip:
            img = img[:, ::-1, ...].copy()
        if vflip:
            img = img[::-1, :, ...].copy()
        if rot90:
            img = img.transpose(1, 0, 2)
        return img

    if not isinstance(img_list, list):
        return _augment(img_list)
    img_list = [_augment(img) for img in img_list]
    return img_list[0] if len(img_list) == 1 else img_list


def to_rgb_hwc(imgs, bgr2rgb=True):
    """BGR HWC float -> RGB HWC float32 numpy (NHWC framework layout)."""

    def _convert(img):
        if img.ndim == 3 and img.shape[2] == 3 and bgr2rgb:
            img = img[..., ::-1]
        return np.ascontiguousarray(img, dtype=np.float32)

    if isinstance(imgs, list):
        return [_convert(img) for img in imgs]
    return _convert(imgs)
