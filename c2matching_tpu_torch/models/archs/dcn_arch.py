"""Deformable-conv modules.

Counterpart of ``c2matching_tpu/models/archs/dcn_arch.py``: the
reference's torch DCNv2 module wrappers, NHWC, over the port's
``ops.deform_conv.modulated_deform_conv``, so that B3 samples forward and
the B3 backward kernel takes the x, offset and mask gradients under
autograd (at any group width and Co, ``ops.deform_conv.split_backward``):

- ``DCNv2Module``: offset and mask given by the caller;
- ``DCN``: offset and mask predicted from the input by ``conv_offset_mask``;
- ``DCNSep``: predicted from a separate feature (the EDVR alignment
  pattern).

State-dict names are the reference's: ``weight`` (Cout, Cin, 3, 3),
``bias``, ``conv_offset_mask.{weight,bias}``. Init: the weight uniform in
+-1/sqrt(9 Cin), a zero bias, a zero ``conv_offset_mask``. ``dtype`` (None
is float32) is the compute dtype of ``conv_offset_mask``; the offsets and
the mask stay float32, and the output is float32.

``conv_offset_mask`` emits 3 G K channels chunked (o1, o2, mask); o1 ++ o2
read group-major with (dy, dx) interleaved per tap is a reshape to
(..., G, K, 2).
"""
import math

import torch
from torch import nn

from ...ops.deform_conv import modulated_deform_conv
from .arch_util import conv


def split_offset_mask(out, g, k):
    """(B, H, W, 3 G K) ``conv_offset_mask`` output -> offset (B, H, W, G,
    K, 2), last dim (dy, dx), and the sigmoid mask (B, H, W, G, K), both
    float32, with the reference's chunk order."""
    b, h, w, _ = out.shape
    offset = out[..., :2 * g * k].float().reshape(b, h, w, g, k, 2)
    mask = torch.sigmoid(out[..., 2 * g * k:].float()).reshape(b, h, w, g, k)
    return offset, mask


class DCNv2Module(nn.Module):
    """Modulated deformable conv with the caller's offset (B, H, W, G, 9,
    2) and mask (B, H, W, G, 9)."""

    def __init__(self, channels, out_channels=None, deformable_groups=1,
                 generator=None, dtype=None):
        super().__init__()
        cout = out_channels or channels
        self.deformable_groups = deformable_groups
        stdv = 1.0 / math.sqrt(channels * 9)
        self.weight = nn.Parameter(torch.empty(cout, channels, 3, 3).uniform_(
            -stdv, stdv, generator=generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, offset, mask):
        # torch (Co, Ci, kh, kw) -> (K, Ci, Co)
        co, ci = self.weight.shape[:2]
        weight = self.weight.permute(2, 3, 1, 0).reshape(9, ci, co)
        return modulated_deform_conv(x, offset, mask, weight, self.bias)


class DCN(DCNv2Module):
    """Offsets and mask predicted from the input itself."""

    def __init__(self, channels, out_channels=None, deformable_groups=1,
                 generator=None, dtype=None):
        super().__init__(channels, out_channels, deformable_groups,
                         generator)
        self.conv_offset_mask = conv(channels, 3 * deformable_groups * 9,
                                     generator, std=0, dtype=dtype)

    def offset_mask(self, feat):
        """The offset and mask that ``conv_offset_mask`` predicts from
        ``feat``."""
        return split_offset_mask(self.conv_offset_mask(feat),
                                 self.deformable_groups, 9)

    def forward(self, x):
        return super().forward(x, *self.offset_mask(x))


class DCNSep(DCN):
    """Offsets and mask predicted from a separate feature ``extra_feat``
    (of ``channels`` channels too, as in the JAX package)."""

    def forward(self, x, extra_feat):
        return DCNv2Module.forward(self, x, *self.offset_mask(extra_feat))
