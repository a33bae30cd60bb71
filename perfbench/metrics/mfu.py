"""The whole forward's (serving cells) or step's (training cells, by
their traffic's driver, whatever the name's variant) share of the chip's
peak: the model's FLOPs over the host time of the run's untraced
stretch (``bench.Run.stretches``; the profiler's host cost would stretch
a traced step), against the peak of the precision each part runs in.

FLOPs are those of the plain reference (``perfbench/reference``),
counted by ``FlopCounterMode`` on 'meta' tensors at the served size and
batch, so how the package computes a layer cannot change the count. The
match's FLOPs (2 x queries x reference patches x 2304, on valid sizes)
are held against the peak of the configuration's match precision
(bfloat16 989 TFLOP/s), every other FLOP against the TF32 peak of 495
TFLOP/s: the convolutions run in TF32 under torch's defaults, and a
float32 matmul is no faster. A share above 100% would mean the count is
too high.
"""
import torch

from perfbench.harness import work
from perfbench.reference import nets
from perfbench.reference.train import TrainReference, training_param_shapes


def _serving_flops(run, hr):
    """(FLOPs of one request at HR ``hr``, of them the match's)."""
    net = run.config['network_g']
    weights = _meta_shapes(nets.serving_param_shapes(net))
    h, w = hr
    lq = torch.empty(1, 3, h // 4, w // 4, device='meta')
    up = torch.empty(1, 3, h, w, device='meta')
    total = work.count_flops(nets.serve_image, lq, up, up, weights, net)
    n = work.match_patches(work.layer_sizes(hr)['relu3_1'])
    return total, 2 * n * n * 9 * work.MATCH_CHANNELS


def _meta_shapes(shapes):
    return {k: torch.empty(v, device='meta') for k, v in shapes.items()}


def _training_flops(run):
    cfg, tr = run.config, run.traffic
    net = cfg['network_g']
    shapes = training_param_shapes(net, cfg['network_d']['ndf'])
    gan = tr['first_step'] > cfg['train']['net_g_pretrain_steps']
    ref = TrainReference(_meta_shapes(shapes), shapes, cfg['train'], net,
                         gan)
    s = tr['gt_size']
    # every operation of the step is per sample, so one sample's count
    # times the batch is the batch's, counted in a fraction of the time
    one = {'lq': torch.empty(1, 3, s // 4, s // 4, device='meta'),
           'up': torch.empty(1, 3, s, s, device='meta'),
           'ref': torch.empty(1, 3, s, s, device='meta'),
           'gt': torch.empty(1, 3, s, s, device='meta')}
    alpha = torch.empty(1, device='meta')
    return tr['batch'] * work.count_flops(ref.step, one, alpha=alpha,
                                          update=False)


def read(run, variant):
    plain = run.plain
    if not (plain and plain['items']):
        return None
    tf32 = work.PEAK_FLOPS['tfloat32']
    if run.traffic['driver'] == 'train':
        ideal = _training_flops(run) / tf32
    else:
        match_dtype = run.config['network_map'].get('match_dtype') \
            or 'float32'
        match_peak = work.PEAK_FLOPS['bfloat16' if match_dtype == 'bfloat16'
                                     else 'tfloat32']
        hr = tuple(run.traffic['sizes'][0])
        total, match = _serving_flops(run, hr)
        ideal = run.traffic['batch'] * ((total - match) / tf32
                                        + match / match_peak)
    return 100.0 * ideal * plain['items'] / plain['seconds']
