"""The general traffic generator: inputs from the seed.

A traffic file (``perfbench/traffic/<name>.json``) is data that this
module reads; nothing in it is code:

- ``driver``: 'serve' or 'train';
- serving: ``batch``, ``sizes`` (HR [height, width] of the requests; each
  request's reference has its size), ``pool`` (distinct batches per size,
  cycled), ``arrivals`` ('closed': the next batch when the last one is on
  the host) and ``sample`` (how many served batches, and images of each,
  the check compares);
- training: ``batch``, ``gt_size``, ``pool`` (distinct batches, cycled),
  ``first_step`` (the iteration number of the first step: above
  ``net_g_pretrain_steps`` a GAN iteration, at or below it a G-pretrain
  step).

Images are smooth random scenes (three octaves of bicubic-upsampled
noise, on the device); a request's reference is another crop of its
scene, shifted by up to a quarter of the frame, so that part of it
matches. The LR input is the HR crop bicubic-downsampled x4 with
antialiasing, and its upsampled copy bicubic x4, as the datasets make
them.
"""
import math

import torch
import torch.nn.functional as F


def _gen(seed, salt, device='cpu'):
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + salt) % (2 ** 63))


def scenes(n, hr, gen, device):
    """``n`` (input HR, reference HR) pairs of size ``hr``, NCHW in [0, 1]."""
    h, w = hr
    hs, ws = h + h // 4, w + w // 4
    img = torch.zeros(n, 3, hs, ws, device=device)
    for cell, amp in ((32, 1.0), (8, 0.5), (2, 0.25)):
        small = torch.rand(n, 3, math.ceil(hs / cell) + 1,
                           math.ceil(ws / cell) + 1, generator=gen,
                           device=device)
        img += amp * F.interpolate(small, size=(hs, ws), mode='bicubic',
                                   align_corners=False)
    lo = img.amin(dim=(1, 2, 3), keepdim=True)
    hi = img.amax(dim=(1, 2, 3), keepdim=True)
    img = (img - lo) / (hi - lo)
    corners = torch.randint(0, 1 << 30, (n, 4), generator=gen,
                            device=device).cpu()
    dy, dx = hs - h + 1, ws - w + 1
    inp = torch.stack([img[i, :, c[0] % dy:c[0] % dy + h,
                           c[1] % dx:c[1] % dx + w]
                       for i, c in enumerate(corners.tolist())])
    ref = torch.stack([img[i, :, c[2] % dy:c[2] % dy + h,
                           c[3] % dx:c[3] % dx + w]
                       for i, c in enumerate(corners.tolist())])
    return inp, ref


def degrade(hr):
    """(LR x4 down, its bicubic x4 up), NCHW, clamped to [0, 1]."""
    h, w = hr.shape[2:]
    lq = F.interpolate(hr, size=(h // 4, w // 4), mode='bicubic',
                       align_corners=False, antialias=True).clamp(0, 1)
    up = F.interpolate(lq, size=(h, w), mode='bicubic',
                       align_corners=False).clamp(0, 1)
    return lq, up


def nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def serving_pool(traffic, seed, device):
    """{size index: [batch dict, ...]} of ``pool`` batches of ``batch``
    requests for each size, as the package takes them (NHWC)."""
    gen = _gen(seed, 1, device)
    out = {}
    b = traffic['batch']
    for s, hr in enumerate(traffic['sizes']):
        inp, ref = scenes(traffic['pool'] * b, tuple(hr), gen, device)
        lq, up = degrade(inp)
        out[s] = [{'img_in_lq': nhwc(lq[i * b:(i + 1) * b]),
                   'img_in_up': nhwc(up[i * b:(i + 1) * b]),
                   'img_ref': nhwc(ref[i * b:(i + 1) * b])}
                  for i in range(traffic['pool'])]
    return out


def training_pool(traffic, seed, device):
    """``pool`` training batches of ``batch`` at ``gt_size``: the ground
    truth 'img_in', its LR 'img_in_lq' and upsampled 'img_in_up', and the
    reference 'img_ref' (NHWC)."""
    gen = _gen(seed, 2, device)
    b, size = traffic['batch'], traffic['gt_size']
    gt, ref = scenes(traffic['pool'] * b, (size, size), gen, device)
    lq, up = degrade(gt)
    return [{'img_in': nhwc(gt[i * b:(i + 1) * b]),
             'img_in_lq': nhwc(lq[i * b:(i + 1) * b]),
             'img_in_up': nhwc(up[i * b:(i + 1) * b]),
             'img_ref': nhwc(ref[i * b:(i + 1) * b])}
            for i in range(traffic['pool'])]


def gp_alphas(seed, n, batch):
    """(n, batch, 1, 1, 1) gradient-penalty coefficients, one row a step."""
    return torch.rand((n, batch, 1, 1, 1), generator=_gen(seed, 3))
