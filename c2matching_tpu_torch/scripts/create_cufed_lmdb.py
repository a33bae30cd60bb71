"""Pack the CUFED training set into lmdb databases, without cv2 or PIL.

Counterpart of ``scripts/create_cufed_lmdb.py``: for each of the input and
the ref folders, three databases under ``out_root`` (``<name>.lmdb``,
``<name>_lq.lmdb``, ``<name>_up.lmdb``) holding each image resized to
``gt_size`` square by PIL's bicubic (``data/pil_resize.py``), that image
down by ``scale`` and that one back up, each as a PNG under its file's
stem, with a ``meta_info.txt`` line ``'{key}.png ({h},{w},3) 1'`` a key.
The ``lmdb`` package packs when it is installed; otherwise the port's
store of the same API and format (``utils/lmdb_shim.py``), which both
packages' ``LmdbBackend`` read. The PNG bytes differ from cv2's (another
compressor); the decoded pixels and ``meta_info.txt`` do not. Sources
are PNG or baseline JPEG (``.jpg`` / ``.jpeg``, decoded by the port's
``utils/jpeg.py`` as cv2 decodes them) and are stored as PNG, as the JAX
packer stores them.

    python -m c2matching_tpu_torch.scripts.create_cufed_lmdb \
        --in_dir datasets/CUFED/input --ref_dir datasets/CUFED/ref \
        --out_root datasets/CUFED_lmdb [--gt_size 160] [--scale 4]
"""
import argparse
import contextlib
import os
import os.path as osp

from ..data.pil_resize import resize_bicubic
from ..utils import png
from ..utils.util import imfrombytes

SUFFIXES = ('', '_lq', '_up')


def make_variants(img, gt_size=160, scale=4):
    """(full, lq, up) uint8 images of a uint8 (H, W, 3) image: PIL's
    bicubic to gt_size square, down by ``scale``, back up. The channels
    resample alike, so BGR stays BGR."""
    full = resize_bicubic(img, (gt_size, gt_size))
    lq = resize_bicubic(full, (gt_size // scale, gt_size // scale))
    up = resize_bicubic(lq, (gt_size, gt_size))
    return full, lq, up


def pack(folder, out_root, name, gt_size=160, scale=4):
    """The three databases of ``folder``'s images as ``<name>*.lmdb``
    under ``out_root``."""
    try:
        import lmdb
    except ImportError:
        from ..utils import lmdb_shim as lmdb
        print('lmdb package not available; packing into the port\'s store '
              'of the same format (c2matching_tpu_torch/utils/'
              'lmdb_shim.py), which LmdbBackend reads')
    files = sorted(f for f in os.listdir(folder)
                   if f.lower().endswith(('.png', '.jpg', '.jpeg')))
    paths = {suffix: osp.join(out_root, f'{name}{suffix}.lmdb')
             for suffix in SUFFIXES}
    meta = {suffix: [] for suffix in SUFFIXES}
    with contextlib.ExitStack() as stack:
        txns = {}
        for suffix, path in paths.items():
            os.makedirs(path, exist_ok=True)
            env = lmdb.open(path, map_size=1099511627776)
            stack.callback(env.close)
            txns[suffix] = stack.enter_context(env.begin(write=True))
        for fname in files:
            with open(osp.join(folder, fname), 'rb') as f:
                img = imfrombytes(f.read())
            key = osp.splitext(fname)[0]
            for suffix, sel in zip(SUFFIXES,
                                   make_variants(img, gt_size, scale)):
                txns[suffix].put(key.encode('ascii'), png.encode(sel))
                h, w = sel.shape[:2]
                meta[suffix].append(f'{key}.png ({h},{w},3) 1')
    for suffix, path in paths.items():
        with open(osp.join(path, 'meta_info.txt'), 'w') as f:
            f.write('\n'.join(meta[suffix]) + '\n')
        print(f'packed {len(files)} images -> {path}')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--in_dir', required=True)
    ap.add_argument('--ref_dir', required=True)
    ap.add_argument('--out_root', required=True)
    ap.add_argument('--gt_size', type=int, default=160)
    ap.add_argument('--scale', type=int, default=4)
    args = ap.parse_args(argv)
    pack(args.in_dir, args.out_root, 'input', args.gt_size, args.scale)
    pack(args.ref_dir, args.out_root, 'ref', args.gt_size, args.scale)


if __name__ == '__main__':
    main()
