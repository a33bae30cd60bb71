"""Generate the tiny synthetic CUFED-like dataset, without cv2.

Counterpart of ``scripts/make_synth_dataset.py``: the same images from
the same ``RandomState(0)`` sequence, written with the port's PNG writer,
so the decoded pixels equal the JAX script's; a reference size other
than the input's (``--ref-size``) resizes the reference with the port's
cv2-free ``INTER_CUBIC`` (``data/warp.py::resize_cubic``). Layouts:

    --layout cufed (default): <root>/input/NNN_0.png, <root>/ref/NNN_1.png
    --layout wrsr: <root>/input/NNN.png, <root>/ref/NNN_ref.png
    <root>/pairs.txt: annotation file (input ref per line)

Usage: python -m c2matching_tpu_torch.scripts.make_synth_dataset <root>
       [--n 8] [--size H [W]] [--ref-size H [W]] [--layout cufed|wrsr]
"""
import argparse
import os

import numpy as np

from ..data.warp import resize_cubic
from ..utils.util import imwrite


def synth_image(rng, h, w):
    """Structured random image: smooth gradients + rectangles + texture, so
    patch matching has real correspondences to find."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * (xx / w * rng.uniform(1, 3))),
        0.5 + 0.5 * np.sin(2 * np.pi * (yy / h * rng.uniform(1, 3))),
        0.5 + 0.5 * np.sin(2 * np.pi * ((xx + yy) / (h + w)
                                        * rng.uniform(1, 4))),
    ], axis=-1)
    for _ in range(6):
        x0, y0 = rng.randint(0, w - 8), rng.randint(0, h - 8)
        dw, dh = rng.randint(4, max(5, w // 3)), rng.randint(4, max(5, h // 3))
        color = rng.rand(3)
        img[y0:y0 + dh, x0:x0 + dw] = 0.6 * img[y0:y0 + dh, x0:x0 + dw] \
            + 0.4 * color
    img += rng.randn(h, w, 3) * 0.02
    return np.clip(img, 0, 1)


def to_bgr_u8(img):
    """RGB float [0, 1] -> BGR uint8, rounded, as the JAX script writes."""
    return (img[..., ::-1] * 255).round().astype(np.uint8)


def write_dataset(root, n=8, size=(160,), layout='cufed', ref_size=None):
    """Write ``n`` pairs under ``root``; returns the pairs.txt lines."""
    in_h, in_w = size[0], size[1] if len(size) > 1 else size[0]
    ref_h, ref_w = in_h, in_w
    if ref_size is not None:
        ref_h, ref_w = ref_size[0], ref_size[-1]

    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(root, 'input'), exist_ok=True)
    os.makedirs(os.path.join(root, 'ref'), exist_ok=True)

    lines = []
    for i in range(n):
        img = synth_image(rng, in_h, in_w)
        # ref: same content, small shift + brightness change, resized
        shift = rng.randint(2, 12)
        ref = np.roll(img, shift, axis=(0, 1)) * rng.uniform(0.9, 1.1)
        ref = np.clip(ref, 0, 1)
        if (ref_h, ref_w) != (in_h, in_w):
            ref = resize_cubic(ref, (ref_w, ref_h))
        if layout == 'wrsr':
            in_name, ref_name = f'{i + 1:03d}.png', f'{i + 1:03d}_ref.png'
        else:
            in_name, ref_name = f'{i:03d}_0.png', f'{i:03d}_1.png'
        imwrite(to_bgr_u8(img), os.path.join(root, 'input', in_name))
        imwrite(to_bgr_u8(ref), os.path.join(root, 'ref', ref_name))
        lines.append(f'{in_name} {ref_name}')

    with open(os.path.join(root, 'pairs.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('root')
    ap.add_argument('--n', type=int, default=8)
    ap.add_argument('--size', type=int, nargs='+', default=[160],
                    help='input size: H (square) or H W')
    ap.add_argument('--ref-size', type=int, nargs='+', default=None,
                    help='reference image size (default: same as --size)')
    ap.add_argument('--layout', choices=('cufed', 'wrsr'), default='cufed',
                    help='file naming: CUFED5 (NNN_0/NNN_1) or WR-SR '
                         '(NNN/NNN_ref)')
    args = ap.parse_args(argv)
    write_dataset(args.root, args.n, args.size, args.layout, args.ref_size)
    print(f'wrote {args.n} pairs under {args.root}')


if __name__ == '__main__':
    main()
