"""Restoration network with correspondence-seeded dynamic aggregation.

Counterpart of ``c2matching_tpu/models/archs/ref_restoration_arch.py``,
built on the port's modulated deformable conv (kernel B3). Parameter names
are the reference's torch state-dict keys (``content_extractor.*``,
``dyn_agg_restore.*``), so a reference ``.pth`` loads with strict=True.

Init: normal(0, 0.02) for every conv, zero ``conv_offset_mask``, and the
DCN main weight uniform(-1/sqrt(C*9), 1/sqrt(C*9)) with zero bias, all
drawn from an explicit ``torch.Generator``.

``dtype`` (None is float32) is the compute dtype of every conv, as in the
JAX package; the DCN's offsets and mask stay float32 whatever it is.

``band`` (a ``parallel.Band`` in LR rows, ``val_spatial_shard``): the LR
input, the content features and the pre-offsets are one rank's band of
the image, the reference features are whole, and the output is the
band's HR rows. Each DynAgg samples the whole reference feature for the
band's pixels (its deformable conv at padding ``1 - row0``), and keeps
the sum and count of its |learned offset| over the band's pixels for the
caller to reduce.
"""
import math

import torch
from torch import nn

from ...ops.deform_conv import modulated_deform_conv
from ...ops.patch_match import as_dtype
from ...ops.resize import pixel_shuffle, upscale
from ...parallel.spatial import allreduce_sum
from ...utils import trace
from .arch_util import ResBlockStack, conv, lrelu


class DynAgg(nn.Module):
    """Modulated deformable conv whose offsets are a learned residual (from
    a separate feature) plus the precomputed match offsets (the reference's
    DCN_sep_pre_multi_offset).

    ``gather_dtype``: dtype of the deformable sampling and the weight
    contraction only; sampling coordinates stay f32. None keeps
    ref_feat's dtype. ``dtype``: compute dtype of ``conv_offset_mask``.
    """

    def __init__(self, channels, deformable_groups=8, gather_dtype=None,
                 generator=None, dtype=None):
        super().__init__()
        self.groups = deformable_groups
        self.k = 9
        self.gather_dtype = as_dtype(gather_dtype)
        self.conv_offset_mask = conv(channels, 3 * deformable_groups * 9,
                                     generator, std=0, dtype=dtype)
        stdv = 1.0 / math.sqrt(channels * 9)
        self.weight = nn.Parameter(
            torch.empty(channels, channels, 3, 3).uniform_(
                -stdv, stdv, generator=generator))
        self.bias = nn.Parameter(torch.zeros(channels))
        # the (sum, count) of |learned offset| over the pixels of the last
        # forward (a band's with a band), float64: the reference warns
        # when their mean exceeds 100 (read through offset_stats)
        self.offset_abssum = None

    def forward(self, ref_feat, offset_feat, pre_offset, band=None):
        """
        Args:
            ref_feat:    (B, H, W, C) feature to sample (ref VGG features).
            offset_feat: (B, H, W, C') feature the offsets are predicted from.
            pre_offset:  (B, 9, H, W, 2) match offsets, last dim (x, y).
            band: None, or the ``parallel.Band`` of offset_feat's and
                pre_offset's rows (ref_feat whole).
        Returns:
            (B, H, W, C) aggregated feature in ref_feat's dtype (the band's
            rows with a band).
        """
        g, k = self.groups, self.k
        b, h, w, _ = offset_feat.shape
        out = self.conv_offset_mask(offset_feat, band)
        # o1 ++ o2 read as (G, K, 2): (dy, dx) interleaved per tap
        offset = out[..., :2 * g * k].float().reshape(b, h, w, g, k, 2)
        if not torch.compiler.is_exporting():
            # a module attribute: kept out of an exported graph
            absolute = offset.detach().abs()
            self.offset_abssum = torch.stack([
                absolute.sum(dtype=torch.float64),
                absolute.new_full((), absolute.numel(), dtype=torch.float64)])
        mask = torch.sigmoid(out[..., 2 * g * k:].float()).reshape(
            b, h, w, g, k)
        # (B, 9, H, W, 2[x, y]) -> (B, H, W, 1, 9, 2[y, x]), broadcast over
        # the groups
        pre = pre_offset.permute(0, 2, 3, 1, 4).flip(-1)
        offset = offset + pre[:, :, :, None].float()
        # torch (Co, Ci, kh, kw) -> (K, Ci, Co)
        weight = self.weight.permute(2, 3, 1, 0).reshape(
            k, self.weight.shape[1], self.weight.shape[0])
        ref_in = ref_feat
        if self.gather_dtype is not None:
            ref_in = ref_feat.to(self.gather_dtype)
        # a band's output rows sample the whole feature at the image's rows
        padding = (1, 1) if band is None else (1 - band.row0, 1)
        out = modulated_deform_conv(ref_in, offset, mask, weight, self.bias,
                                    padding=padding)
        return out.to(ref_feat.dtype)


class ContentExtractor(nn.Module):
    """conv + n residual blocks on the LR input."""

    def __init__(self, nf=64, n_blocks=16, generator=None, dtype=None):
        super().__init__()
        self.conv_first = conv(3, nf, generator, dtype=dtype)
        self.body = ResBlockStack(nf, n_blocks, generator, dtype)

    def forward(self, x, band=None):
        return self.body(self.conv_first(x, band, act='lrelu'), band)


_SCALES = (('small', 'relu3_1', 256), ('medium', 'relu2_1', 128),
           ('large', 'relu1_1', 64))
# each scale's DynAgg span, by its reference layer
_DYNAGG_SPANS = {scale: f'c2m.dynagg.{key}' for scale, key, _ in _SCALES}


class DynamicAggregationRestoration(nn.Module):
    """3-scale coarse-to-fine decoder with a DynAgg at each scale."""

    def __init__(self, ngf=64, n_blocks=16, groups=8, gather_dtype=None,
                 generator=None, dtype=None):
        super().__init__()
        gen = generator

        def conv_(cin, cout):
            return conv(cin, cout, gen, dtype=dtype)

        for scale, _, ref_ch in _SCALES:
            setattr(self, f'{scale}_offset_conv1', conv_(ngf + ref_ch, ref_ch))
            setattr(self, f'{scale}_offset_conv2', conv_(ref_ch, ref_ch))
            setattr(self, f'{scale}_dyn_agg',
                    DynAgg(ref_ch, groups, gather_dtype, gen, dtype))
            setattr(self, f'head_{scale}', nn.Sequential(
                conv_(ngf + ref_ch, ngf), nn.LeakyReLU(0.1)))
            setattr(self, f'body_{scale}',
                    ResBlockStack(ngf, n_blocks, gen, dtype))
        self.tail_small = nn.Sequential(conv_(ngf, ngf * 4),
                                        nn.PixelShuffle(2), nn.LeakyReLU(0.1))
        self.tail_medium = nn.Sequential(conv_(ngf, ngf * 4),
                                         nn.PixelShuffle(2),
                                         nn.LeakyReLU(0.1))
        self.tail_large = nn.Sequential(conv_(ngf, ngf // 2),
                                        nn.LeakyReLU(0.1),
                                        conv_(ngf // 2, 3))

    def _scale_stage(self, x, scale, ref, pre_offset, band):
        off = torch.cat([x, ref if band is None else band.take(ref)], dim=-1)
        off = getattr(self, f'{scale}_offset_conv1')(off, band, act='lrelu')
        off = getattr(self, f'{scale}_offset_conv2')(off, band, act='lrelu')
        with trace.span(_DYNAGG_SPANS[scale]):
            swapped = getattr(self, f'{scale}_dyn_agg')(ref, off, pre_offset,
                                                        band)
        h = torch.cat([x, lrelu(swapped)], dim=-1)
        h = getattr(self, f'head_{scale}')[0](h, band, act='lrelu')
        h = getattr(self, f'body_{scale}')(h, band) + x
        if scale == 'large':
            h = self.tail_large[0](h, band, act='lrelu')
            return self.tail_large[2](h, band)
        # the leaky ReLU before the shuffle, which commutes with it
        h = getattr(self, f'tail_{scale}')[0](h, band, act='lrelu')
        return pixel_shuffle(h, 2)

    def forward(self, x, pre_offset, img_ref_feat, band=None):
        """``band``: the LR band of x and of the relu3 pre-offsets."""
        for i, (scale, key, _) in enumerate(_SCALES):
            x = self._scale_stage(
                x, scale, img_ref_feat[key], pre_offset[key],
                None if band is None else band.scaled(2 ** i))
        return x

    def offset_stats(self, reduce=False):
        """{'offset_absmean_<scale>': 0-d float32 tensor}, the mean |learned
        offset| of the last forward. ``reduce``: over every rank's sums and
        counts (after a banded forward, the whole image's; a collective,
        every rank calls it)."""
        sums = torch.stack([getattr(self, f'{scale}_dyn_agg').offset_abssum
                            for scale, _, _ in _SCALES])
        if reduce:
            sums = allreduce_sum(sums)
        return {f'offset_absmean_{scale}': (sums[i, 0] / sums[i, 1]).float()
                for i, (scale, _, _) in enumerate(_SCALES)}


class RestorationNet(nn.Module):
    """Generator: content extractor + dynamic aggregation decoder + a
    bilinear x4 base."""

    def __init__(self, ngf=64, n_blocks=16, groups=8, gather_dtype=None,
                 generator=None, dtype=None):
        super().__init__()
        self.content_extractor = ContentExtractor(ngf, n_blocks, generator,
                                                  dtype)
        self.dyn_agg_restore = DynamicAggregationRestoration(
            ngf, n_blocks, groups, gather_dtype, generator, dtype)

    def forward(self, x, pre_offset, img_ref_feat, band=None):
        """
        Args:
            x: (B, h, w, 3) LR input.
            pre_offset: relu{1,2,3}_1 -> (B, 9, H_s, W_s, 2) offsets.
            img_ref_feat: relu{1,2,3}_1 -> (B, H_s, W_s, C_s) VGG features
                of the HR reference.
            band: None, or the ``parallel.Band`` (LR rows) of which x and
                the pre-offsets hold the rows; img_ref_feat stays whole.
        Returns:
            (B, 4h, 4w, 3) restored image, or the band's (B, 4 rows, 4w, 3).
        """
        base = upscale(x, 4, 'bilinear', band=band)
        content = self.content_extractor(x, band)
        return self.dyn_agg_restore(content, pre_offset, img_ref_feat,
                                    band) + base
