"""Peak device memory of batch-1 evaluation, and the module that sets it.

Runs the eval model's ``feed_data`` / ``test`` at full width (the f32 test
options' networks: ContrasExtractorSep, VGG19 to relu3_1, ngf 64, 16
blocks, 8 groups; seeded random weights) on a random request of each HR
size given, TF32 off as in the parity runs (``--tf32``: cuDNN's TF32 on,
torch's default), and prints one JSON line a size:

    python -m c2matching_tpu_torch.scripts.profile_memory \\
        [--hr 256x384 512x384] [--cudnn default|deterministic|benchmark] \\
        [--tf32] [--device cpu]

``peak_gib``: the allocator's peak over ``test()`` (the second call on
the size, the first having built cuDNN's plans), from a reset; ``ms``:
that call's host time, synchronised (the hooks' reads included);
``modules``: the three leaf modules (``utils/prof.py::ModulePeaks``) whose
forward rose highest above what was allocated when it began, as
[name, input shape, GiB above, GiB of output]. ``--cudnn`` sets
``torch.backends.cudnn.deterministic`` or ``.benchmark``; the JSON also
echoes ``CUDNN_CONV_WSCAP_DBG`` (cuDNN's cap on a convolution's
workspace, in MiB) and ``TORCH_CUDNN_V8_API_DISABLED`` from the
environment, which select cuDNN's plans too. On the CPU the allocator
keeps no counters: the peaks are null.
"""
import argparse
import json
import os
import time

import torch

from ..models import RefRestorationModel
from ..utils.prof import ModulePeaks

F32_BLOCKS = {
    'network_g': {'type': 'RestorationNet', 'ngf': 64, 'n_blocks': 16,
                  'groups': 8},
    'network_map': {'type': 'CorrespondenceGenerationArch', 'patch_size': 3,
                    'stride': 1,
                    'vgg_layer_list': ['relu1_1', 'relu2_1', 'relu3_1'],
                    'vgg_type': 'vgg19'},
    'network_extractor': {'type': 'ContrasExtractorSep'},
}
ENV = ('CUDNN_CONV_WSCAP_DBG', 'TORCH_CUDNN_V8_API_DISABLED')


def _hw(text):
    h, w = text.split('x')
    return int(h), int(w)


def profile(sizes, cudnn='default', device='cuda', blocks=F32_BLOCKS,
            tf32=False):
    """[{'hr', 'peak_gib', 'modules', ...}] of ``test()`` at each HR size
    of ``sizes`` on ``device``."""
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = [(f, k, getattr(f, k)) for f, k in (
        (flags[0], 'allow_tf32'), (flags[1], 'allow_tf32'),
        (flags[0], 'deterministic'), (flags[0], 'benchmark'))]
    try:
        flags[0].allow_tf32, flags[1].allow_tf32 = tf32, False
        flags[0].deterministic = cudnn == 'deterministic'
        flags[0].benchmark = cudnn == 'benchmark'
        return _profile(sizes, cudnn, device, blocks, tf32)
    finally:
        for f, k, v in saved:
            setattr(f, k, v)


def _profile(sizes, cudnn, device, blocks, tf32):
    model = RefRestorationModel(blocks, device,
                                torch.Generator().manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(1)
    out = []
    for hr_h, hr_w in sizes:
        model.feed_data({
            'img_in_lq': torch.rand((1, hr_h // 4, hr_w // 4, 3),
                                    generator=gen, device=device),
            'img_in_up': torch.rand((1, hr_h, hr_w, 3), generator=gen,
                                    device=device),
            'img_ref': torch.rand((1, hr_h, hr_w, 3), generator=gen,
                                  device=device)})
        model.test()
        if device != 'cpu':
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        peaks = ModulePeaks(model.net_extractor, model.net_map, model.net_g)
        t0 = time.perf_counter()
        try:
            model.test()
            if device != 'cpu':
                torch.cuda.synchronize()
        finally:
            peaks.close()
        ms = 1e3 * (time.perf_counter() - t0)
        out.append({'hr': f'{hr_h}x{hr_w}', 'cudnn': cudnn, 'tf32': tf32,
                    'env': {k: os.environ.get(k) for k in ENV},
                    'peak_gib': peaks.total(), 'ms': ms,
                    'modules': [list(r) for r in peaks.top(3)]})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--hr', nargs='+', type=_hw,
                    default=[(256, 384), (512, 384)],
                    help='HR sizes HxW (multiples of 4)')
    ap.add_argument('--cudnn', default='default',
                    choices=('default', 'deterministic', 'benchmark'))
    ap.add_argument('--tf32', action='store_true',
                    help="cuDNN's TF32 on (torch's default; off otherwise)")
    ap.add_argument('--device', default='cuda',
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         'on the CPU)')
    args = ap.parse_args(argv)
    for rec in profile(args.hr, args.cudnn, args.device, tf32=args.tf32):
        print(json.dumps(rec), flush=True)


if __name__ == '__main__':
    main()
