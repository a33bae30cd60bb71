"""One-command CUFED5 quality-parity harness.

Counterpart of ``scripts/parity_cufed5.py`` of the JAX package: drop in
the reference's released weights and data, run one command, read the
PSNR delta against the paper's numbers (BASELINE.md):

    python -m c2matching_tpu_torch.scripts.parity_cufed5 \
        --data ./datasets/CUFED5 \
        --weights-g c2_matching_restoration_mse.pth \
        --weights-extractor feature_extraction.pth [--device cpu]

The protocol is the model's own (``_validation_images``,
``_compute_val_metrics``: PSNR / PSNR_Y / SSIM_Y on BGR uint8 with crop
border = scale, BT.601 Y) over ``datasets/CUFED5_pairs.txt``. Weights are
the reference's ``.pth`` files; a flax ``.ckpt`` of the JAX package
raises and names the ``.pth`` route. Prints each image's metrics, then a
JSON line, also written to ``<out>/parity.json``; with a baseline, the
verdict is ``PARITY`` when |delta PSNR| <= 0.05 dB.

Baselines (paper Table 1, BASELINE.md): MSE model 28.24 dB / 0.841, GAN
model 27.16 dB / 0.805 (``--model gan``). Any other dataset laid out as
``<in> <ref>`` pairs works through ``--pairs`` / ``--data-ref``.
``--synthetic`` runs the harness end to end on a seeded synthetic set in
CUFED5 layout (input ``--synthetic-size``, reference 24 px larger, so the
dataset's padding branch runs) with random-init weights: meaningless
metrics, working plumbing. The model runs on the CUDA card unless
``--device`` names another.
"""
import argparse
import json
import os
import os.path as osp

import numpy as np

from ..data import create_dataloader, create_dataset
from ..models import create_model
from ..utils import dict_to_nonedict, get_root_logger
from .make_synth_dataset import write_dataset

BASELINES = {  # (PSNR dB, SSIM): paper Table 1 via BASELINE.md
    'mse': (28.24, 0.841),
    'gan': (27.16, 0.805),
    'none': (None, None),
}


def build_opt(args):
    """The options dict of the harness's run."""
    opt = {
        'name': f'parity_{args.model}', 'suffix': None, 'scale': 4,
        'model_type': 'RefRestorationModel', 'crop_border': args.scale,
        'is_train': False, 'dist': False, 'rank': 0, 'world_size': 1,
        'datasets': {'test_1': {
            'name': args.name, 'phase': 'test', 'scale': 4,
            'type': 'RefCUFEDDataset',
            'dataroot_in': args.data,
            'dataroot_ref': args.data_ref or args.data,
            'io_backend': {'type': 'disk'},
            'bicubic_model': 'PIL',
            'ann_file': args.pairs,
            'data_type': 'disk',
        }},
        'network_g': {'type': 'RestorationNet', 'ngf': 64,
                      'n_blocks': 16, 'groups': 8},
        'network_map': {'type': 'CorrespondenceGenerationArch',
                        'patch_size': 3, 'stride': 1,
                        'vgg_layer_list': ['relu1_1', 'relu2_1',
                                           'relu3_1'],
                        'vgg_type': 'vgg19'},
        'network_extractor': {'type': 'ContrasExtractorSep'},
        'path': {
            'pretrain_model_g': args.weights_g,
            'pretrain_model_feature_extractor': args.weights_extractor,
            'pretrain_model_vgg': args.weights_vgg,
            'strict_load': True,
            'root': '.', 'results_root': args.out,
            'log': args.out, 'visualization': osp.join(args.out, 'vis'),
        },
        'val_func': 'BasicSRValidation', 'save_img': args.save_img,
    }
    return dict_to_nonedict(opt)


def _make_synthetic(args):
    """--synthetic: a seeded synthetic set in CUFED5 layout under
    ``<out>/synth_data``, and random-init weights."""
    root = osp.join(args.out, 'synth_data')
    write_dataset(root, n=args.synthetic_n, size=(args.synthetic_size,),
                  ref_size=(args.synthetic_size + 24,))
    args.data = osp.join(root, 'input')
    args.data_ref = osp.join(root, 'ref')
    args.pairs = osp.join(root, 'pairs.txt')
    args.model = 'none'
    args.weights_g = args.weights_extractor = args.weights_vgg = None
    return args


def run(args):
    """Score the model of ``build_opt(args)`` on the harness's set; returns
    the result dict it prints and writes."""
    os.makedirs(args.out, exist_ok=True)
    get_root_logger()
    opt = build_opt(args)
    dataset_opt = opt['datasets']['test_1']
    loader = create_dataloader(create_dataset(dataset_opt), dataset_opt)
    model = create_model(opt, args.device)

    psnrs, psnrs_y, ssims_y = [], [], []
    for val_data in loader:
        img_name = osp.splitext(osp.basename(val_data['lq_path'][0]))[0]
        sr_img, gt_img = model._validation_images(val_data)
        if args.save_img:
            model._save_val_image(sr_img, img_name, args.name, 'parity')
        vals = model._compute_val_metrics(sr_img, gt_img)
        psnrs.append(vals['psnr'])
        psnrs_y.append(vals['psnr_y'])
        ssims_y.append(vals['ssim_y'])
        print(f'{img_name}: PSNR {psnrs[-1]:.4f}  '
              f'PSNR_Y {psnrs_y[-1]:.4f}  SSIM_Y {ssims_y[-1]:.4f}',
              flush=True)

    result = {
        'n_images': len(psnrs),
        'psnr': float(np.mean(psnrs)),
        'psnr_y': float(np.mean(psnrs_y)),
        'ssim_y': float(np.mean(ssims_y)),
    }
    base_psnr, base_ssim = BASELINES[args.model]
    if base_psnr is not None:
        result['baseline_psnr'] = base_psnr
        result['baseline_ssim'] = base_ssim
        result['delta_psnr'] = result['psnr'] - base_psnr
        result['delta_ssim'] = result['ssim_y'] - base_ssim
        result['verdict'] = ('PARITY' if abs(result['delta_psnr']) <= 0.05
                             else 'DELTA EXCEEDS 0.05 dB')
    print(json.dumps(result))
    with open(osp.join(args.out, 'parity.json'), 'w') as f:
        json.dump(result, f, indent=2)
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--data', default=None,
                   help='input image dir (CUFED5 layout)')
    p.add_argument('--data-ref', default=None,
                   help='reference image dir (default: --data)')
    p.add_argument('--pairs', default='./datasets/CUFED5_pairs.txt')
    p.add_argument('--weights-g', default=None,
                   help='net_g weights (the reference .pth format)')
    p.add_argument('--weights-extractor', default=None,
                   help='feature extractor weights (.pth)')
    p.add_argument('--weights-vgg', default=None,
                   help='optional torchvision vgg19 .pth for net_map')
    p.add_argument('--model', choices=('mse', 'gan', 'none'),
                   default='mse', help='which baseline to compare against')
    p.add_argument('--name', default='CUFED5')
    p.add_argument('--scale', type=int, default=4)
    p.add_argument('--out', default='./results/parity')
    p.add_argument('--save-img', action='store_true')
    p.add_argument('--synthetic', action='store_true',
                   help='dry-run on generated synthetic data with '
                        'random-init weights (no --data needed)')
    p.add_argument('--synthetic-n', type=int, default=2)
    p.add_argument('--synthetic-size', type=int, default=72)
    p.add_argument('--device', default='cuda',
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        'on the CPU)')
    args = p.parse_args(argv)
    if args.synthetic:
        os.makedirs(args.out, exist_ok=True)
        args = _make_synthetic(args)
    elif not args.data:
        p.error('--data is required (or pass --synthetic)')
    return args


def main(argv=None):
    return run(parse_args(argv))


if __name__ == '__main__':
    main()
