"""Iterative back-projection post-processing.

Counterpart of ``scripts/back_projection.py`` of the JAX package (the
reference's MATLAB ``main_bp.m``, ``backprojection.m`` and
``main_reverse_filter.m``): refines SR results against the LR inputs with
MATLAB-kernel bicubic back-projection (``data/util.py::imresize_np``,
float64 numpy), or the reverse-filter variant against downsampled ground
truth. Images are read and written as PNG through the port's codec
(``utils/png.py``), BGR as cv2 gives them:

    python -m c2matching_tpu_torch.scripts.back_projection bp \
        --sr <sr_dir> --lr <lr_dir> --out <out_dir> [--iters 20] [--scale 4]
    python -m c2matching_tpu_torch.scripts.back_projection reverse \
        --sr <sr_dir> --gt <gt_dir> --out <out_dir> [--iters 20] [--scale 4]
"""
import argparse
import os
import os.path as osp

import numpy as np

from ..data.util import imresize_np
from ..utils import imfrombytes, imwrite


def backprojection(sr, lr, iters, scale):
    """sr_{t+1} = sr_t + up(lr - down(sr_t)) with MATLAB bicubic
    (backprojection.m)."""
    for _ in range(iters):
        down = imresize_np(sr, 1.0 / scale)
        err = lr - down
        sr = sr + imresize_np(err, scale)
    return sr


def reverse_filter(sr, gt_down, iters, scale):
    """Reverse filtering: x_{t+1} = x_t + (gt_down - down(x_t)) upsampled
    (main_reverse_filter.m pattern)."""
    return backprojection(sr, gt_down, iters, scale)


def _load(path):
    with open(path, 'rb') as f:
        return imfrombytes(f.read()).astype(np.float32) / 255.


def _save(path, img):
    imwrite(np.clip(img * 255.0, 0, 255).round().astype(np.uint8), path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('mode', choices=['bp', 'reverse'])
    ap.add_argument('--sr', required=True, help='SR results folder')
    ap.add_argument('--lr', help='LR inputs folder (bp mode)')
    ap.add_argument('--gt', help='GT folder (reverse mode; downsampled '
                                 'internally)')
    ap.add_argument('--out', required=True)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--scale', type=int, default=4)
    args = ap.parse_args(argv)

    for name in sorted(os.listdir(args.sr)):
        sr = _load(osp.join(args.sr, name))
        if args.mode == 'bp':
            lr = _load(osp.join(args.lr, name))
            out = backprojection(sr, lr, args.iters, args.scale)
        else:
            gt = _load(osp.join(args.gt, name))
            gt_down = imresize_np(gt, 1.0 / args.scale)
            out = reverse_filter(sr, gt_down, args.iters, args.scale)
        _save(osp.join(args.out, name), out)
        print(f'{name} done', flush=True)


if __name__ == '__main__':
    main()
