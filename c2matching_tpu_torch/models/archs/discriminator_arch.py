"""Image discriminator of the stage-3 GAN.

Counterpart of ``c2matching_tpu/models/archs/discriminator_arch.py``: five
conv-BN-LReLU(0.2) double blocks (the second conv of each with stride 2),
a global mean, then 1x1 convs to a sigmoid score. NHWC in, (B, 1, 1, 1)
out. Parameters carry the reference's torch names (``conv_block{i}.{0,1,
3,4}``, ``out_block.{1,3}``), the ones ``c2matching_tpu/utils/
pth_import.py::import_discriminator`` reads.

Init (srntt): conv weights normal(0, 0.02), zero biases, BN scale
N(1, 0.02) and zero shift, all from an explicit ``torch.Generator``.

``dtype`` (None is float32) is the compute dtype, as the JAX package's
``dtype`` field: the parameters and the BatchNorm's running statistics
stay float32; each conv casts its input, weight and bias to ``dtype``;
BatchNorm reduces its statistics from the input taken to float32,
normalizes, scales and shifts in float32 and casts the result to
``dtype``, as flax's ``nn.BatchNorm`` does with a ``dtype``; the global
mean, the activations and the score stay in ``dtype``.

BatchNorm is the JAX package's (flax ``nn.BatchNorm``, momentum 0.9,
epsilon 1e-5), not torch's: in train mode it normalizes by the batch's
mean and biased variance, var = max(0, E[x^2] - E[x]^2), and moves the
running statistics by 0.1 toward the batch's mean and that same biased
variance (torch would store the unbiased one). ``forward(x,
update_stats=False)`` leaves the running statistics as they are, as the
JAX package does for the gradient-penalty pass. In eval mode the running
statistics normalize.

At world size > 1 (``parallel/``) the train-mode statistics are the
global batch's, as flax's BN computes them under a sharded ``jit``: each
rank's per-channel sums of x and x^2 and its count go through one
differentiable all-reduce (``parallel.all_reduce_sum``; the gradient
penalty differentiates through it twice), so every rank normalizes with,
and moves its running statistics toward, the same moments.
``torch.nn.SyncBatchNorm`` is not used: it refuses CPU tensors.
"""
import torch
from torch import nn

from ...ops.patch_match import as_dtype
from .arch_util import FlaxBatchNorm2d, lrelu


class _Conv(nn.Conv2d):
    """NCHW convolution computed in ``compute_dtype`` from float32
    parameters."""

    def __init__(self, cin, cout, ksize, stride, compute_dtype):
        super().__init__(cin, cout, ksize, stride=stride,
                         padding=ksize // 2)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt))


def _conv(cin, cout, ksize, stride, generator, dtype):
    layer = _Conv(cin, cout, ksize, stride, dtype)
    with torch.no_grad():
        layer.weight.normal_(0.0, 0.02, generator=generator)
        layer.bias.zero_()
    return layer


def _bn(channels, generator):
    layer = FlaxBatchNorm2d(channels)
    with torch.no_grad():
        layer.weight.normal_(1.0, 0.02, generator=generator)
        layer.bias.zero_()
    return layer


class ImageDiscriminator(nn.Module):
    """Stage-3 discriminator (see module docstring)."""

    def __init__(self, in_nc=3, ndf=32, generator=None, dtype=None):
        super().__init__()
        dt = as_dtype(dtype) or torch.float32
        channels, cin = ndf, in_nc
        for i in range(1, 6):
            setattr(self, f'conv_block{i}', nn.Sequential(
                _conv(cin, channels, 3, 1, generator, dt),
                _bn(channels, generator), nn.LeakyReLU(0.2),
                _conv(channels, channels, 3, 2, generator, dt),
                _bn(channels, generator), nn.LeakyReLU(0.2)))
            cin = channels
            if i < 5:
                channels *= 2
        self.out_block = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            _conv(channels, 1024, 1, 1, generator, dt), nn.LeakyReLU(0.2),
            _conv(1024, 1, 1, 1, generator, dt), nn.Sigmoid())

    def forward(self, x, update_stats=True):
        """x: (B, H, W, in_nc). Returns the (B, 1, 1, 1) score."""
        feat = x.permute(0, 3, 1, 2)
        for i in range(1, 6):
            conv1, bn1, _, conv2, bn2, _ = getattr(self, f'conv_block{i}')
            feat = lrelu(bn1(conv1(feat), update_stats), 0.2)
            feat = lrelu(bn2(conv2(feat), update_stats), 0.2)
        _, conv3, _, conv4, sigmoid = self.out_block
        feat = lrelu(conv3(feat.mean(dim=(2, 3), keepdim=True)), 0.2)
        return sigmoid(conv4(feat)).permute(0, 2, 3, 1)
