"""Host-side image transforms (numpy, HWC).

Counterpart of ``c2matching_tpu/data/transforms.py`` (``mod_crop``,
``paired_random_crop``, ``augment``, ``to_rgb_hwc``). ``augment`` draws
its flips and rotation with the same three ``random.random()`` calls, in
the same order, as the JAX package, and turns flows with the images.
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


def paired_random_crop(img_gts, img_lqs, gt_patch_size, scale):
    """Crop a ``gt_patch_size`` patch of each ground truth and the matching
    ``gt_patch_size // scale`` patch of each LQ image, at one position
    drawn by ``random.randint`` (top, then left, in LQ pixels). Lists in,
    lists out; a single array in, a single array out."""
    single_gt = not isinstance(img_gts, list)
    single_lq = not isinstance(img_lqs, list)
    if single_gt:
        img_gts = [img_gts]
    if single_lq:
        img_lqs = [img_lqs]
    h_lq, w_lq = img_lqs[0].shape[:2]
    lq_patch_size = gt_patch_size // scale
    top = random.randint(0, h_lq - lq_patch_size)
    left = random.randint(0, w_lq - lq_patch_size)
    img_lqs = [v[top:top + lq_patch_size, left:left + lq_patch_size, ...]
               for v in img_lqs]
    top_gt, left_gt = int(top * scale), int(left * scale)
    img_gts = [v[top_gt:top_gt + gt_patch_size,
                 left_gt:left_gt + gt_patch_size, ...] for v in img_gts]
    return (img_gts[0] if single_gt else img_gts,
            img_lqs[0] if single_lq else img_lqs)


def augment(img_list, hflip=True, rotation=True, flow_list=None):
    """Random horizontal / vertical flip and 90-degree rotation (a
    transpose), the same draw for every entry of ``img_list`` and of
    ``flow_list``. A flow (H, W, 2), last dim (x, y), turns with the image:
    a horizontal flip negates x, a vertical one y, and the transpose swaps
    x and y. With ``flow_list`` returns (images, flows), a one-entry list
    given as its entry."""
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

    def _augment_flow(flow):
        if hflip:
            flow = flow[:, ::-1, :].copy()
            flow[:, :, 0] *= -1
        if vflip:
            flow = flow[::-1, :, :].copy()
            flow[:, :, 1] *= -1
        if rot90:
            flow = flow.transpose(1, 0, 2)[:, :, [1, 0]]
        return flow

    if not isinstance(img_list, list):
        img_list = _augment(img_list)
    else:
        img_list = [_augment(img) for img in img_list]
        if len(img_list) == 1:
            img_list = img_list[0]
    if flow_list is None:
        return img_list
    flow_list = [_augment_flow(flow) for flow in flow_list]
    return img_list, flow_list[0] if len(flow_list) == 1 else flow_list


def to_rgb_hwc(imgs, bgr2rgb=True):
    """BGR HWC float -> RGB HWC float32 numpy (NHWC framework layout)."""

    def _convert(img):
        if img.ndim == 3 and img.shape[2] == 3 and bgr2rgb:
            img = img[..., ::-1]
        return np.ascontiguousarray(img, dtype=np.float32)

    if isinstance(imgs, list):
        return [_convert(img) for img in imgs]
    return _convert(imgs)
