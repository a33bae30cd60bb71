"""Data-path utilities: paired path generation and PIL-bicubic resizing.

Counterpart of ``c2matching_tpu/data/util.py`` (``scandir``,
``paired_paths_from_ann_file``, ``paired_paths_from_folder``,
``paired_paths_from_lmdb``, ``pil_bicubic_resize``, ``pil_chain_lq_up``,
the MATLAB bicubic ``imresize_np`` of the back-projection tool, and the
BT.601 ``rgb2ycbcr`` / ``ycbcr2rgb`` pair). The PIL bicubic resampling
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


def paired_paths_from_lmdb(folders, keys):
    """Keys of two lmdb databases as pairs: each database's keys are the
    first token of each line of its ``meta_info.txt`` with the extension
    stripped; both folders must end in ``.lmdb`` and hold the same keys.
    Returns the pairs in sorted key order."""
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError('paired paths take two folders and two keys')
    input_folder, ref_folder = folders
    input_key, ref_key = keys
    if not (input_folder.endswith('.lmdb') and ref_folder.endswith('.lmdb')):
        raise ValueError(
            f'{input_key} folder and {ref_key} folder should both in lmdb '
            f'formats. But received {input_key}: {input_folder}; '
            f'{ref_key}: {ref_folder}')

    def meta_keys(folder):
        with open(osp.join(folder, 'meta_info.txt')) as fin:
            return [line.split()[0].split('.')[0] for line in fin
                    if line.strip()]

    input_keys = meta_keys(input_folder)
    if set(input_keys) != set(meta_keys(ref_folder)):
        raise ValueError('Keys in input_folder and ref_folder are different.')
    return [{f'{input_key}_path': k, f'{ref_key}_path': k}
            for k in sorted(input_keys)]


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


# ---------------------------------------------------------------------------
# MATLAB-compatible bicubic imresize, in float64 numpy: the JAX package's
# ``c2matching_tpu/data/util.py`` (``_cubic_kernel``,
# ``_matlab_weights_indices``, ``_sym_pad``, ``imresize_np``), used by
# ``scripts/back_projection.py``.
# ---------------------------------------------------------------------------
def _cubic_kernel(x):
    absx = np.abs(x)
    absx2 = absx ** 2
    absx3 = absx ** 3
    return ((1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1)
            + (-0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2)
            * ((absx > 1) & (absx <= 2)))


def _matlab_weights_indices(in_length, out_length, scale, kernel_width,
                            antialiasing):
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale
    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :]
    distance = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * _cubic_kernel(distance * scale)
    else:
        weights = _cubic_kernel(distance)
    weights = weights / weights.sum(axis=1, keepdims=True)
    # drop all-zero boundary columns
    zero_cols = (weights == 0).sum(axis=0)
    if zero_cols[0] > out_length - 1e-6:
        indices = indices[:, 1:]
        weights = weights[:, 1:]
    if zero_cols[-1] > out_length - 1e-6:
        indices = indices[:, :-1]
        weights = weights[:, :-1]
    # symmetric-padding bookkeeping
    sym_len_s = int(-indices.min() + 1)
    sym_len_e = int(indices.max() - in_length)
    indices = (indices + sym_len_s - 1).astype(np.int64)
    return weights, indices, sym_len_s, sym_len_e


def _sym_pad(arr, axis, before, after):
    """MATLAB-style symmetric padding along one axis."""
    idx_before = np.arange(before - 1, -1, -1) if before > 0 else []
    idx_after = (np.arange(arr.shape[axis] - 1,
                           arr.shape[axis] - 1 - after, -1)
                 if after > 0 else [])
    parts = []
    if before > 0:
        parts.append(np.take(arr, idx_before, axis=axis))
    parts.append(arr)
    if after > 0:
        parts.append(np.take(arr, idx_after, axis=axis))
    return np.concatenate(parts, axis=axis)


def imresize_np(img, scale, antialiasing=True):
    """MATLAB-compatible bicubic imresize (HWC float [0,1] numpy input,
    same scale for H and W)."""
    img = np.asarray(img, dtype=np.float64)
    squeeze = False
    if img.ndim == 2:
        img = img[:, :, None]
        squeeze = True
    in_h, in_w, c = img.shape
    out_h = int(np.ceil(in_h * scale))
    out_w = int(np.ceil(in_w * scale))
    kernel_width = 4

    w_h, i_h, s_hs, s_he = _matlab_weights_indices(in_h, out_h, scale,
                                                   kernel_width,
                                                   antialiasing)
    w_w, i_w, s_ws, s_we = _matlab_weights_indices(in_w, out_w, scale,
                                                   kernel_width,
                                                   antialiasing)

    padded = _sym_pad(img, 0, s_hs, s_he)
    # H pass: out1[o, :, :] = sum_p padded[i_h[o, p]] * w_h[o, p]
    out1 = np.einsum('opwc,op->owc', padded[i_h], w_h)
    padded2 = _sym_pad(out1, 1, s_ws, s_we)
    out2 = np.einsum('hopc,op->hoc', padded2[:, i_w], w_w)
    if squeeze:
        out2 = out2[:, :, 0]
    return out2.astype(np.float32)


def rgb2ycbcr(img, only_y=True):
    """BT.601 RGB -> YCbCr (MATLAB's rgb2ycbcr) of an HWC image: uint8 in
    [0, 255] or float in [0, 1] in, the same type out (uint8 rounded).
    ``only_y``: the Y channel alone."""
    in_img_type = img.dtype
    img = img.astype(np.float64)
    if in_img_type != np.uint8:
        img = img * 255.
    if only_y:
        rlt = np.dot(img, [65.481, 128.553, 24.966]) / 255.0 + 16.0
    else:
        rlt = np.matmul(
            img, [[65.481, -37.797, 112.0], [128.553, -74.203, -93.786],
                  [24.966, 112.0, -18.214]]) / 255.0 + [16, 128, 128]
    if in_img_type == np.uint8:
        rlt = rlt.round()
    else:
        rlt = rlt / 255.
    return rlt.astype(in_img_type)


def ycbcr2rgb(img):
    """YCbCr -> RGB of an HWC image, the inverse of ``rgb2ycbcr``: uint8 in
    [0, 255] or float in [0, 1] in, the same type out (uint8 rounded)."""
    in_img_type = img.dtype
    img = img.astype(np.float64)
    if in_img_type != np.uint8:
        img = img * 255.
    rlt = np.matmul(
        img, [[0.00456621, 0.00456621, 0.00456621],
              [0, -0.00153632, 0.00791071],
              [0.00625893, -0.00318811, 0]]) * 255.0 \
        + [-222.921, 135.576, -276.836]
    if in_img_type == np.uint8:
        rlt = rlt.round()
    else:
        rlt = rlt / 255.
    return rlt.astype(in_img_type)
