"""Data-path utilities: paired path generation and PIL-bicubic resizing.

Counterpart of ``c2matching_tpu/data/util.py`` (``scandir``,
``paired_paths_from_ann_file``, ``paired_paths_from_folder``,
``pil_bicubic_resize``, ``pil_chain_lq_up``). The PIL bicubic resampling
is the port's own bit-exact copy (``data/pil_resize.py``); the uint8
round trips around it are the JAX package's, so every array is the same
bit for bit.
"""
import os
import os.path as osp

import numpy as np

from .pil_resize import resize_bicubic


def scandir(dir_path, suffix=None, recursive=False):
    """Relative file paths under ``dir_path``, sorted for determinism."""
    results = []
    for root, _dirs, files in os.walk(dir_path):
        for fname in files:
            rel = osp.relpath(osp.join(root, fname), dir_path)
            if suffix is None or rel.endswith(suffix):
                results.append(rel)
        if not recursive:
            break
    return sorted(results)


def paired_paths_from_ann_file(folders, keys, ann_file):
    """Paths from a whitespace-separated two-column annotation file."""
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError('paired paths take two folders and two keys')
    input_folder, ref_folder = folders
    input_key, ref_key = keys

    paths = []
    with open(ann_file, 'r') as fin:
        for line in fin:
            line = line.strip()
            if not line:
                continue
            input_name, ref_name = line.split()
            paths.append({
                f'{input_key}_path': osp.join(input_folder, input_name),
                f'{ref_key}_path': osp.join(ref_folder, ref_name),
            })
    return paths


def paired_paths_from_folder(folders, keys, filename_tmpl='{}'):
    """Paths from folder scans, matched by templated basename."""
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError('paired paths take two folders and two keys')
    input_folder, ref_folder = folders
    input_key, ref_key = keys

    input_paths = scandir(input_folder)
    ref_paths = scandir(ref_folder)
    if len(input_paths) != len(ref_paths):
        raise ValueError(
            f'{input_key} and {ref_key} datasets have different number of '
            f'images: {len(input_paths)}, {len(ref_paths)}.')
    input_path_set = set(input_paths)
    paths = []
    for ref_path in ref_paths:
        basename, ext = osp.splitext(osp.basename(ref_path))
        input_name = f'{filename_tmpl.format(basename)}{ext}'
        if input_name not in input_path_set:
            raise ValueError(f'{input_name} is not in {input_key}_paths.')
        paths.append({
            f'{input_key}_path': osp.join(input_folder, input_name),
            f'{ref_key}_path': osp.join(ref_folder, ref_path),
        })
    return paths


def pil_bicubic_resize(img_bgr, size_wh):
    """PIL-bicubic resize of a BGR float [0,1] HWC image through uint8, as
    the reference does. Returns BGR float32 [0, 1]."""
    arr = (img_bgr * 255).astype(np.uint8)
    out = resize_bicubic(arr, size_wh)
    return out.astype(np.float32) / 255.


def pil_chain_lq_up(img_bgr, scale):
    """The reference degradation chain: PIL-bicubic down x1/scale then
    back up. Returns (lq, up) BGR floats.

    A single uint8 round trip per image: the up-resize starts from the
    uint8 lq image, not from its float re-encode. PIL resamples each
    channel alike, so the BGR<->RGB swaps around it change no value."""
    h, w = img_bgr.shape[:2]
    lq_w, lq_h = w // scale, h // scale
    arr = (img_bgr * 255).astype(np.uint8)
    lq = resize_bicubic(arr, (lq_w, lq_h))
    up = resize_bicubic(lq, (w, h))
    return lq.astype(np.float32) / 255., up.astype(np.float32) / 255.
