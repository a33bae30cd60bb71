"""Architecture building blocks (NHWC in and out).

Counterpart of ``c2matching_tpu/models/archs/arch_util.py``. Modules take
and return NHWC tensors; their convolutions run in cuDNN on the
``permute(0, 3, 1, 2)`` view, which is free and already in channels_last
memory order. Parameters carry the reference's torch state-dict names.

``dtype`` is the compute dtype of the convolutions, as the JAX package's
``dtype`` field on every network block: parameters stay float32, and each
conv casts its input, weight and bias to it (None is float32).

``band`` (a ``parallel.Band``, None for the whole image): the input holds
one rank's horizontal band of the image (``val_spatial_shard``); each
conv takes one row from each neighbouring band first, and the valid
masks are in the image's rows.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ...ops.patch_match import as_dtype
from ...parallel.spatial import exchange_halo


class Conv2d(nn.Conv2d):
    """3x3, stride-1, same-padded convolution on NHWC tensors, computed in
    ``compute_dtype`` (float32 unless given) from float32 parameters."""

    def __init__(self, in_channels, out_channels, device=None,
                 compute_dtype=None):
        super().__init__(in_channels, out_channels, 3, padding=1,
                         device=device)
        self.compute_dtype = as_dtype(compute_dtype) or torch.float32

    def forward(self, x, band=None):
        dt = self.compute_dtype
        if band is None:
            return self._conv_forward(x.permute(0, 3, 1, 2).to(dt),
                                      self.weight.to(dt),
                                      self.bias.to(dt)).permute(0, 2, 3, 1)
        # a band: the neighbours' rows (zeros past the image) take the
        # place of the vertical zero padding
        x = exchange_halo(x.to(dt), band, 1, 1)
        return F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(dt),
                        self.bias.to(dt), padding=(0, 1)).permute(0, 2, 3, 1)


def conv(in_channels, out_channels, generator=None, std=0.02, dtype=None):
    """A 3x3 ``Conv2d`` computing in ``dtype``, with weights drawn from
    normal(0, std) by ``generator`` (std 0 gives zeros) and a zero bias.
    ``std=None`` draws He-normal weights, normal(0, sqrt(2 / fan_in))."""
    layer = skip_init(Conv2d, in_channels, out_channels, compute_dtype=dtype)
    if std is None:
        std = math.sqrt(2.0 / (in_channels * 9))
    with torch.no_grad():
        if std:
            layer.weight.normal_(0.0, std, generator=generator)
        else:
            layer.weight.zero_()
        layer.bias.zero_()
    return layer


def valid_mask(x, valid_shape, row0=0):
    """(1, H, W, 1) {0, 1} mask in x.dtype of the valid (unpadded) region of
    a bucket-padded NHWC tensor: 1 where row < vh and col < vw. ``row0``:
    the image row of x's first row (a band's).

    Multiplying each conv output by it makes the padded computation give
    the exact-shape values on the valid crop: the zero bands then act like
    the implicit same-padding zeros of the exact-shape run at every layer.
    """
    vh, vw = valid_shape
    h, w = x.shape[1], x.shape[2]
    row = torch.arange(row0, row0 + h, device=x.device)[None, :, None, None]
    col = torch.arange(w, device=x.device)[None, None, :, None]
    return ((row < int(vh)) & (col < int(vw))).to(x.dtype)


def halve_valid(valid_shape):
    """valid_shape after a stride-2 pooling."""
    if valid_shape is None:
        return None
    vh, vw = valid_shape
    return vh // 2, vw // 2


def scale_valid(valid_shape, factor):
    """valid_shape after an integer x``factor`` upsample."""
    if valid_shape is None:
        return None
    vh, vw = valid_shape
    return vh * factor, vw * factor


def lrelu(x, slope=0.1):
    """Leaky ReLU whose derivative at exactly 0 is 1, as JAX's
    ``where(x >= 0, x, slope * x)`` gives (torch's ``leaky_relu`` gives
    ``slope`` there); the same values either way, so without a gradient
    the single fused op runs."""
    if x.requires_grad:
        return torch.where(x >= 0, x, x * slope)
    return F.leaky_relu(x, negative_slope=slope)


class ResidualBlockNoBN(nn.Module):
    """Conv-ReLU-Conv residual block without BN; each conv output is
    masked to the valid region when a mask is given."""

    def __init__(self, nf=64, generator=None, dtype=None):
        super().__init__()
        self.conv1 = conv(nf, nf, generator, dtype=dtype)
        self.conv2 = conv(nf, nf, generator, dtype=dtype)

    def forward(self, x, mask=None, band=None):
        out = self.conv1(x, band)
        if mask is not None:
            out = out * mask
        out = self.conv2(F.relu(out), band)
        if mask is not None:
            out = out * mask
        return x + out


class ResBlockStack(nn.ModuleList):
    """n sequential ResidualBlockNoBN (the reference's make_layer), with
    parameters named ``{i}.conv{1,2}.*``."""

    def __init__(self, nf=64, n_blocks=16, generator=None, dtype=None):
        super().__init__([ResidualBlockNoBN(nf, generator, dtype)
                          for _ in range(n_blocks)])

    def forward(self, x, mask=None, band=None):
        for block in self:
            x = block(x, mask, band)
        return x
