"""Per-stage serving profile: extractor / matcher / generator.

Counterpart of ``scripts/profile_serving.py`` of the JAX package. Times
each stage of the serving forward as its own call at the serving
configuration (``match_dtype`` and ``gather_dtype`` bfloat16, full width:
ContrasExtractorSep, ngf 64, 16 blocks, 8 groups), seeded random weights,
distinct random inputs per iteration at HR 512x336 (each request at its
own shape), and prints one JSON line:

    python -m c2matching_tpu_torch.scripts.profile_serving \
        [--batch 16] [--iters 4] [--cost] [--device cpu]

Timing (``utils/prof.py``): on the card, CUDA events around each call;
``fetch_overhead_ms`` is the same protocol's time for a one-element op,
and ``*_ms_net`` subtracts it. ``--cost`` counts each stage's FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` (B1 as 2 B Nq Nr D; the
fused deformable conv as 2 B Ho Wo K C Co, its contraction; B3's im2col as
0, its contraction being the ``torch.matmul`` that follows) and
adds ``<stage>_gflops`` and ``<stage>_tflops_per_s``, and counts each
stage's bytes with ``utils/prof.py::ByteCounter`` for ``<stage>_hbm_gb``
and ``<stage>_hbm_gb_per_s`` (the JAX version's names). The count is the
unfused traffic each operator names (its operands and results once a
call); the JAX version's is XLA's estimate over the fused program, and
the two are not compared.
"""
import argparse
import json

import torch

from ..models import RefRestorationModel
from ..utils.prof import calibrate_fetch, count_gb, timed

HR = (512, 336)
SERVING_BLOCKS = {
    'network_g': {'type': 'RestorationNet', 'ngf': 64, 'n_blocks': 16,
                  'groups': 8, 'gather_dtype': 'bfloat16'},
    'network_map': {'type': 'CorrespondenceGenerationArch', 'patch_size': 3,
                    'stride': 1,
                    'vgg_layer_list': ['relu1_1', 'relu2_1', 'relu3_1'],
                    'vgg_type': 'vgg19', 'match_dtype': 'bfloat16'},
    'network_extractor': {'type': 'ContrasExtractorSep'},
}


def _b1_flops(q, r, ref_bias, out_shape=None):
    b, nq, d = q
    return 2 * b * nq * r[1] * d


def _b3_flops(*args, out_shape=None, **kwargs):
    return 0


def _b3f_flops(x, offset, mask, w_kc, *args, out_shape=None, **kwargs):
    b, ho, wo = offset[:3]
    return 2 * b * ho * wo * w_kc[0] * w_kc[1]


class _TotalOnly:
    """FlopCounterMode's module tracker reduced to the total: the tracker's
    hooks on module inputs break ``torch.autograd.grad`` through a module
    (the gradient penalty of ``profile_train.py``)."""
    parents = ('Global',)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def count_gflops(fn, *args):
    """GFLOPs of ``fn(*args)`` by ``FlopCounterMode``, with the two
    operators' formulas: B1 2 B Nq Nr D, the fused deformable conv
    2 B Ho Wo K C Co, B3's im2col 0 (its contraction is the
    ``torch.matmul`` that follows)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.c2matching.match_argmax: _b1_flops,
        torch.ops.c2matching.deform_im2col: _b3_flops,
        torch.ops.c2matching.deform_conv_fused: _b3f_flops})
    counter.mod_tracker = _TotalOnly()
    with counter:
        fn(*args)
    return counter.get_total_flops() / 1e9


def profile(blocks=SERVING_BLOCKS, batch=16, iters=4, cost=False,
            device='cuda', hr=HR):
    """The JSON dict of the serving profile of the nets ``blocks`` (an
    options dict's ``network_g`` / ``network_map`` / ``network_extractor``)
    at ``batch`` requests of HR ``hr`` on ``device``."""
    model = RefRestorationModel(blocks, device,
                                torch.Generator().manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(1)
    gt_h, gt_w = hr
    n = iters

    def mk(shape):
        return torch.rand(shape, generator=gen, device=device)

    batches = []
    for _ in range(n + 1):
        model.feed_data({'img_in_up': mk((batch, gt_h, gt_w, 3)),
                         'img_ref': mk((batch, gt_h, gt_w, 3)),
                         'img_in_lq': mk((batch, gt_h // 4, gt_w // 4, 3))})
        batches.append(model.batch)
    ext, cg, g = model.net_extractor, model.net_map, model.net_g

    out = {'batch': batch}
    with torch.inference_mode():
        t_ext = timed(ext, [(bt['img_in_up'], bt['img_ref'])
                            for bt in batches], n)
        feats = ext(batches[0]['img_in_up'], batches[0]['img_ref'])
        t_cg = timed(cg, [(feats, bt['img_ref']) for bt in batches], n)
        po, rf = cg(feats, batches[0]['img_ref'])
        t_g = timed(g, [(bt['img_in_lq'], po, rf) for bt in batches], n)
        t_fetch = calibrate_fetch(n, device)

        rows = [('extractor', t_ext), ('matcher', t_cg), ('generator', t_g)]
        out['fetch_overhead_ms'] = round(t_fetch * 1e3, 4)
        for name, t in rows:
            out[f'{name}_ms'] = round(t * 1e3, 3)
            out[f'{name}_ms_net'] = round((t - t_fetch) * 1e3, 3)
        total_net = sum(t - t_fetch for _, t in rows)
        out['total_net_ms'] = round(total_net * 1e3, 3)
        out['net_img_per_s'] = round(batch / total_net, 3)

        if cost:
            calls = {'extractor': (ext, batches[0]['img_in_up'],
                                   batches[0]['img_ref']),
                     'matcher': (cg, feats, batches[0]['img_ref']),
                     'generator': (g, batches[0]['img_in_lq'], po, rf)}
            for name, t in rows:
                gf = count_gflops(*calls[name])
                gb = count_gb(*calls[name])
                net = max(t - t_fetch, 1e-9)
                out[f'{name}_gflops'] = round(gf, 3)
                out[f'{name}_hbm_gb'] = round(gb, 6)
                out[f'{name}_tflops_per_s'] = round(gf / net / 1e3, 3)
                out[f'{name}_hbm_gb_per_s'] = round(gb / net, 3)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=16)
    ap.add_argument('--iters', type=int, default=4)
    ap.add_argument('--cost', action='store_true',
                    help='add FLOPs (FlopCounterMode) and bytes '
                         '(ByteCounter) per stage and the achieved TFLOP/s '
                         'and GB/s (net of the protocol)')
    ap.add_argument('--device', default='cuda',
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         'on the CPU)')
    args = ap.parse_args(argv)
    print(json.dumps(profile(batch=args.batch, iters=args.iters,
                             cost=args.cost, device=args.device)))


if __name__ == '__main__':
    main()
