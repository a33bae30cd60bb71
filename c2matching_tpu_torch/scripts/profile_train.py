"""Per-phase training profile of the stage-3 GAN iteration.

Counterpart of ``scripts/profile_train.py`` of the JAX package. Times
each phase of the GAN iteration as its own call, built from the port
model's own pieces (``RefRestorationModel`` on
``options/train/debug_stage3_synth.yml``, full width, bf16 DCN gathers,
seeded init), at batch 9 and 160-px GT by default, on distinct random
inputs per iteration, and prints one JSON line:

  match      extractor + correspondence generation, without a graph (the
             input stage of every train step)
  g_forward  the generator's forward only
  g_step     the G phase of the GAN iteration: forward, loss head (pixel +
             perceptual + GAN-G through D in train mode, D frozen),
             backward, Adam
  loss_head  the loss head alone, with its backward w.r.t. the G output
  d_step     the D phase: real/fake forwards, the gradient penalty, Adam
             (``_d_update``)

    python -m c2matching_tpu_torch.scripts.profile_train \
        [--iters 4] [--batch 9] [--gt-size 160] [--total] [--device cpu]

match + g_step + d_step make one iteration (``phase_sum_net_ms``;
g_forward and loss_head are parts of g_step). Timing as in
``utils/prof.py``: CUDA events around each call on the card, ``*_ms_net``
less the protocol's own time. ``<phase>_gflops`` and
``<phase>_tflops_per_s`` count FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` (B1 as 2 B Nq Nr D, B3's
im2col as 0); ``<phase>_hbm_gb`` and ``<phase>_hbm_gb_per_s`` (the JAX
version's names) count bytes with ``utils/prof.py::ByteCounter``: the
unfused traffic each operator names, not XLA's fused estimate, and the
two are not compared.
``--total`` also times the whole ``optimize_parameters`` (synchronised,
median). The model runs on the CUDA card unless ``--device`` names
another.
"""
import argparse
import json
import os.path as osp
import time

import numpy as np
import torch

from ..models import create_model
from ..utils.options import _repo_root, parse
from ..utils.prof import calibrate_fetch, count_gb, timed
from .profile_serving import count_gflops

PHASES = ('match', 'g_forward', 'loss_head', 'g_step', 'd_step')


def build_opt():
    """``debug_stage3_synth.yml`` as the profile runs it: GAN iterations
    from the first step, bf16 DCN gathers."""
    opt = parse(osp.join(_repo_root(), 'options', 'train',
                         'debug_stage3_synth.yml'), is_train=True)
    opt['train']['net_g_pretrain_steps'] = 0
    opt['network_g']['gather_dtype'] = 'bfloat16'
    return opt


def profile(opt, batch=9, gt_size=160, iters=4, total=False,
            device='cuda'):
    """The JSON dict of the per-phase profile of the model of ``opt``."""
    model = create_model(opt, device)
    dev = model.device
    b, gt, n = batch, gt_size, iters
    lq = gt // 4

    def mk(seed, shape):
        return torch.as_tensor(np.random.RandomState(seed).rand(*shape)
                               .astype(np.float32)).to(dev)

    ups = [mk(100 + i, (b, gt, gt, 3)) for i in range(n + 1)]
    refs = [mk(200 + i, (b, gt, gt, 3)) for i in range(n + 1)]
    lqs = [mk(300 + i, (b, lq, lq, 3)) for i in range(n + 1)]
    gts = [mk(400 + i, (b, gt, gt, 3)) for i in range(n + 1)]

    @torch.no_grad()
    def match(up, ref):
        return model.net_map(model.net_extractor(up, ref), ref)

    @torch.no_grad()
    def g_forward(lq_img, po_, rf_):
        return model.net_g(lq_img, po_, rf_)

    def loss_head(out, gt_img):
        out = out.detach().requires_grad_(True)
        loss, _ = model._out_losses(out, gt_img)
        loss.backward()     # D and the perceptual VGG take no gradient
        return loss.detach(), out.grad

    def g_step(lq_img, gt_img, po_, rf_):
        model.optimizer_g.zero_grad(set_to_none=True)
        loss, _ = model._out_losses(model.net_g(lq_img, po_, rf_), gt_img)
        loss.backward()
        model.schedules.step('g')
        return loss.detach()

    def d_step(gt_img, fake_img):
        return model._d_update(gt_img, fake_img)

    po, rf = match(ups[0], refs[0])
    output = g_forward(lqs[0], po, rf)
    calls = {
        'match': (match, [(ups[i], refs[i]) for i in range(n + 1)]),
        'g_forward': (g_forward, [(lqs[i], po, rf) for i in range(n + 1)]),
        'loss_head': (loss_head, [(output, gts[i]) for i in range(n + 1)]),
        'g_step': (g_step, [(lqs[i], gts[i], po, rf) for i in range(n + 1)]),
        'd_step': (d_step, [(gts[i], output) for i in range(n + 1)]),
    }
    times = {name: timed(fn, inputs, n) for name, (fn, inputs) in
             calls.items()}
    t_fetch = calibrate_fetch(n, dev)

    out = {'batch': b, 'gt_size': gt,
           'fetch_overhead_ms': round(t_fetch * 1e3, 4)}
    for name in PHASES:
        out[f'{name}_ms'] = round(times[name] * 1e3, 3)
        out[f'{name}_ms_net'] = round((times[name] - t_fetch) * 1e3, 3)
    total_net = sum(times[name] - t_fetch
                    for name in ('match', 'g_step', 'd_step'))
    out['phase_sum_net_ms'] = round(total_net * 1e3, 3)
    out['phase_sum_samples_per_s'] = round(b / total_net, 3)

    for name in PHASES:
        fn, inputs = calls[name]
        gf = count_gflops(fn, *inputs[0])
        gb = count_gb(fn, *inputs[0])
        net = max(times[name] - t_fetch, 1e-9)
        out[f'{name}_gflops'] = round(gf, 3)
        out[f'{name}_hbm_gb'] = round(gb, 3)
        out[f'{name}_tflops_per_s'] = round(gf / net / 1e3, 3)
        out[f'{name}_hbm_gb_per_s'] = round(gb / net, 3)

    if total:
        batches = [{'img_in_up': ups[i], 'img_in': gts[i],
                    'img_ref': refs[i], 'img_in_lq': lqs[i]}
                   for i in range(n + 1)]
        model.feed_data(batches[-1])
        model.optimize_parameters(1)
        float(model.log_dict['l_g_pix'])
        ts = []
        for i in range(n):
            model.feed_data(batches[i])
            t0 = time.perf_counter()
            model.optimize_parameters(i + 2)
            float(model.log_dict['l_g_pix'])
            ts.append(time.perf_counter() - t0)
        out['fused_step_ms'] = round(sorted(ts)[len(ts) // 2] * 1e3, 3)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--iters', type=int, default=4)
    ap.add_argument('--batch', type=int, default=9)
    ap.add_argument('--gt-size', type=int, default=160)
    ap.add_argument('--total', action='store_true',
                    help='also time the whole GAN iteration '
                         '(optimize_parameters, synchronised; the number '
                         'bench_train.py --per-iter-fetch gives)')
    ap.add_argument('--device', default='cuda',
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         'on the CPU)')
    args = ap.parse_args(argv)
    print(json.dumps(profile(build_opt(), args.batch, args.gt_size,
                             args.iters, args.total, args.device)))


if __name__ == '__main__':
    main()
