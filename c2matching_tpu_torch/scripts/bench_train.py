"""Training-throughput benchmark: ms per iteration of one training stage.

Counterpart of ``scripts/bench_train.py`` of the JAX package. Builds the
stage's model from ``options/train/debug_stage<N>_synth.yml`` (full width;
stage 2's teacher from a seeded init instead of a stage-1 checkpoint) and
times its real step, ``feed_data`` -> ``optimize_parameters``, on
distinct random batches (stages 1-2: near-identity homography grids, so
every sample passes the 128-correspondence gate). Prints ONE JSON line,
``{"metric", "value", "unit", "samples_per_sec"}``:

    python -m c2matching_tpu_torch.scripts.bench_train \
        [--stage 1|2|3] [--pretrain] [--batch B] [--gt-size 160] \
        [--iters 10] [--f32] [--per-iter-fetch] [--decompose] \
        [--device cpu]

Stage 3 times the GAN iteration (``--pretrain``: the G-pretrain step) with
bf16 DCN gathers unless ``--f32``. The default protocol dispatches the
iterations back to back and synchronises once after the last, as a
training loop that reads its logs only at ``print_freq`` does;
``--per-iter-fetch`` synchronises each iteration on its loss.
``--decompose`` also reports, on stderr, the step with the batch already
on the device and the host-to-device copy of the batch, each on its own
(host clock around work that ends in a synchronise), and, for the pinned
configuration (stage-3 GAN, bf16 gathers, batch 9 at gt 160), a
``decompose gate:`` line of that step against
``utils/bench_gate.py::PINNED_GAN_STEP_MS`` (10% tolerance), with the
card's name beside the pin's; only on a CUDA device, since the pin is a
card's.
The model runs on the CUDA card unless ``--device`` names another.
"""
import argparse
import json
import os.path as osp
import statistics
import sys
import time

import numpy as np
import torch

from ..data.contras_dataset import transformed_coordinate_grid
from ..models import create_model
from ..utils.bench_gate import PINNED_CARD, PINNED_GAN_STEP_MS, gate
from ..utils.options import _repo_root, parse


def build_opt(stage, pretrain=False, f32=False):
    """The options of ``debug_stage<stage>_synth.yml`` as the benchmark
    runs them."""
    opt = parse(osp.join(_repo_root(), 'options', 'train',
                         f'debug_stage{stage}_synth.yml'), is_train=True)
    if stage == 2:
        # throughput only: a seeded teacher instead of a stage-1 checkpoint
        opt['path']['pretrain_model_teacher'] = None
    if stage == 3:
        opt['train']['net_g_pretrain_steps'] = 10 ** 9 if pretrain else 0
        if not f32:
            opt['network_g']['gather_dtype'] = 'bfloat16'
    return opt


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def make_batch(seed, stage, b, gt):
    """Random NHWC float32 inputs of one step (numpy, as a loader gives)."""
    r = np.random.RandomState(seed)
    batch = {
        'img_in_up': r.rand(b, gt, gt, 3).astype(np.float32),
        'img_in': r.rand(b, gt, gt, 3).astype(np.float32),
        'img_ref': r.rand(b, gt, gt, 3).astype(np.float32),
    }
    if stage == 3:
        batch['img_in_lq'] = r.rand(b, gt // 4, gt // 4,
                                    3).astype(np.float32)
    else:
        grids = []
        for _ in range(b):
            jitter = np.eye(3) + r.uniform(-1e-3, 1e-3, (3, 3))
            jitter[:2, 2] += r.uniform(-4, 4, 2)
            grids.append(transformed_coordinate_grid(jitter, gt, gt))
        batch['transformed_coordinate'] = np.stack(grids)
    return batch


def bench(opt, args):
    """The JSON dict of the benchmark of ``opt`` under the parsed CLI
    ``args``."""
    model = create_model(opt, args.device)
    device = model.device
    b = args.batch or (9 if args.stage == 3 else 8)
    gt = args.gt_size
    n = args.iters
    batches = [make_batch(100 + i, args.stage, b, gt) for i in range(n + 2)]
    if args.stage == 3:
        loss_key = 'l_pix' if args.pretrain else 'l_g_pix'
    else:
        loss_key = 'loss'
    for i in range(2):                       # warm-up: cuDNN plans, caches
        model.feed_data(batches[n + i])
        model.optimize_parameters(i + 1)
        float(model.log_dict[loss_key])

    if args.per_iter_fetch:
        ts = []
        for i in range(n):
            model.feed_data(batches[i])
            t0 = time.perf_counter()
            model.optimize_parameters(i + 3)
            float(model.log_dict[loss_key])
            ts.append(time.perf_counter() - t0)
        dt = statistics.median(ts)
    else:
        losses = []
        t0 = time.perf_counter()
        for i in range(n):
            model.feed_data(batches[i])
            model.optimize_parameters(i + 3)
            losses.append(model.log_dict[loss_key])
        total = float(torch.stack(losses).sum())
        dt = (time.perf_counter() - t0) / n
        if not np.isfinite(total):
            raise RuntimeError(f'non-finite {loss_key} in the timed run')

    if args.decompose:
        step_ts, xfer_ts = [], []
        for i in range(n):
            t0 = time.perf_counter()
            model.feed_data(batches[i])
            _sync(device)
            xfer_ts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            model.optimize_parameters(i + 100)
            float(model.log_dict[loss_key])
            step_ts.append(time.perf_counter() - t0)
        mb = sum(v.nbytes for v in batches[0].values()) / 2 ** 20
        step_ms = statistics.median(step_ts) * 1e3
        print(f'decompose: step on the device (+1 loss read) '
              f'{step_ms:.1f} ms; '
              f'batch transfer ({mb:.1f} MB) '
              f'{statistics.median(xfer_ts) * 1e3:.1f} ms', file=sys.stderr)
        # the pin is a card's (utils/bench_gate.py): no gate elsewhere
        if (device.type == 'cuda' and args.stage == 3 and not args.pretrain
                and not args.f32 and b == 9 and gt == 160):
            fields = gate(step_ms, PINNED_GAN_STEP_MS,
                          higher_is_better=False, tolerance=0.10)
            print('decompose gate: ' + json.dumps(
                {'pinned_ms': PINNED_GAN_STEP_MS,
                 'pinned_card': PINNED_CARD,
                 'card': torch.cuda.get_device_name(device), **fields}),
                file=sys.stderr)

    if args.stage == 3:
        kind = 'pretrain' if args.pretrain else 'GAN'
        detail = 'f32' if args.f32 else 'bf16 gathers'
    else:
        kind = 'teacher-contras' if args.stage == 1 else 'student-distill'
        detail = 'f32'
    return {
        'metric': (f'ms/{kind}-iter, stage-{args.stage} batch {b} / {gt}px '
                   f'GT ({detail})'),
        'value': round(dt * 1e3, 3),
        'unit': 'ms',
        'samples_per_sec': round(b / dt, 3),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--f32', action='store_true',
                    help='disable the bf16-gather knob (pure f32 step)')
    ap.add_argument('--pretrain', action='store_true',
                    help='time the MSE pretrain step instead of the GAN '
                         'iteration')
    ap.add_argument('--stage', type=int, default=3, choices=(1, 2, 3),
                    help='1 = teacher contras iter, 2 = student '
                         'distillation iter, 3 = restoration (default)')
    ap.add_argument('--batch', type=int, default=None,
                    help='default: the production batch for the stage '
                         '(8 for stages 1-2, 9 for stage 3)')
    ap.add_argument('--gt-size', type=int, default=160)
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--per-iter-fetch', action='store_true',
                    help='synchronise every iteration on its loss '
                         '(latency protocol) instead of dispatching the '
                         'iterations back to back')
    ap.add_argument('--decompose', action='store_true',
                    help='also report (to stderr) the step with the batch '
                         'already on the device, and the batch\'s '
                         'host-to-device copy')
    ap.add_argument('--unroll', type=int, default=1,
                    help='accepted and ignored: the JAX package\'s '
                         'trunk_unroll tunes XLA compilation only, and the '
                         'port runs its residual trunks eagerly')
    ap.add_argument('--device', default='cuda',
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         'on the CPU)')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    opt = build_opt(args.stage, args.pretrain, args.f32)
    print(json.dumps(bench(opt, args)))


if __name__ == '__main__':
    main()
