"""Export the serving forward as a ``torch.export`` artifact (``.pt2``).

Counterpart of ``scripts/export_serving.py`` of the JAX package:
``torch.export`` traces the whole serving pipeline (contrastive
extraction -> patch matching -> VGG ref features -> restoration) for one
static serving bucket, and ``torch.export.save`` writes it with the
weights inside:

    python -m c2matching_tpu_torch.scripts.export_serving \
        -opt options/test/<cfg>.yml --batch 8 --hr 512 336 \
        --out exports/c2matching_512x336_b8.pt2 [--device cpu]

The artifact serves exactly one (batch, HR height, HR width) bucket.
Inputs of the exported program, all float32 NHWC in [0, 1]:

    img_in_up (B, H, W, 3)      bicubic-upsampled input
    img_ref   (B, H, W, 3)      reference image
    img_in_lq (B, H/4, W/4, 3)  low-res input

Output: (B, H, W, 3), the x4 restoration. The two kernels of the path
are the registered operators ``c2matching::match_argmax`` (B1) and
``c2matching::deform_conv_fused`` (the DynAggs' fused forward), so loading
needs the package's ops module and no model code:

    import torch, c2matching_tpu_torch.ops   # registers the operators
    program = torch.export.load(path)
    out = program.module()(img_in_up, img_ref, img_in_lq)

The artifact is exported for the device the model runs on (the CUDA card
unless ``--device`` names another) and runs there; the JAX package's
``--platforms`` (several XLA lowerings in one artifact) has no
counterpart.
"""
import argparse
import os
import os.path as osp

import torch
from torch import nn

from ..models import create_model
from ..utils import dict_to_nonedict
from ..utils.options import parse


class ServingForward(nn.Module):
    """(img_in_up, img_ref, img_in_lq) -> the SR output, over the model's
    three nets: extractor -> ``net_map`` -> ``net_g``, with no valid
    shape (the inputs are one bucket's, unpadded)."""

    def __init__(self, model):
        super().__init__()
        self.net_extractor = model.net_extractor
        self.net_map = model.net_map
        self.net_g = model.net_g

    def forward(self, img_in_up, img_ref, img_in_lq):
        feats = self.net_extractor(img_in_up, img_ref)
        pre_offset, ref_feat = self.net_map(feats, img_ref)
        return self.net_g(img_in_lq, pre_offset, ref_feat)


def build_serving_fn(model):
    """The serving forward of ``model`` as a module in eval mode."""
    return ServingForward(model).eval()


def export_serving(model, batch, hr_h, hr_w):
    """``torch.export`` the serving forward at one static bucket, on the
    model's device, under ``no_grad``. Returns the ExportedProgram."""
    if hr_h % 4 or hr_w % 4:
        raise ValueError('HR shape must be divisible by the x4 scale')
    dev = model.device
    args = (torch.zeros((batch, hr_h, hr_w, 3), device=dev),
            torch.zeros((batch, hr_h, hr_w, 3), device=dev),
            torch.zeros((batch, hr_h // 4, hr_w // 4, 3), device=dev))
    with torch.no_grad():
        return torch.export.export(build_serving_fn(model), args)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-opt', type=str, required=True,
                        help='test/serving option YAML (weights via its '
                             'path: keys; random seeded init without)')
    parser.add_argument('--batch', type=int, default=8)
    parser.add_argument('--hr', type=int, nargs=2, default=(512, 336),
                        metavar=('H', 'W'),
                        help='HR bucket shape (multiples of 4)')
    parser.add_argument('--out', type=str, required=True)
    parser.add_argument('--device', default='cuda',
                        help="torch device of the model and the artifact "
                             "(default: the CUDA card; 'cpu' runs on the "
                             "CPU)")
    args = parser.parse_args(argv)

    opt = dict_to_nonedict(parse(args.opt, is_train=False))
    model = create_model(opt, args.device)
    program = export_serving(model, args.batch, args.hr[0], args.hr[1])
    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    torch.export.save(program, args.out)
    print(f'exported {args.out}: {osp.getsize(args.out) / 1e6:.1f} MB, '
          f'device={args.device}, batch={args.batch}, '
          f'hr={args.hr[0]}x{args.hr[1]}')


if __name__ == '__main__':
    main()
