"""On-device resize ops for network interiors (NHWC).

Counterpart of ``c2matching_tpu/ops/resize.py``: the bilinear x4 base
path of RestorationNet, the depth-to-space of its tails and its inverse,
a bilinear resample to any size and the nearest-neighbour upsample.
"""
import torch
import torch.nn.functional as F

from ..parallel.spatial import exchange_halo


def _axis_resize(x, axis, out_n, n=None, out=None, src0=0):
    """1-D bilinear resample along ``axis`` with half-pixel centres (torch
    F.interpolate align_corners=False, no antialiasing), as two gathers and
    a lerp.

    A band: ``x`` holds the samples ``src0, src0 + 1, ...`` of an ``n``-
    sample axis, and the result is the outputs ``out`` (a range) of the
    ``out_n`` the whole axis gives; the coordinates are the whole axis's.
    """
    n = x.shape[axis] if n is None else n
    out = range(out_n) if out is None else out
    scale = n / out_n
    coords = ((torch.arange(out.start, out.stop, dtype=torch.float32,
                            device=x.device) + 0.5) * scale - 0.5)
    coords = coords.clamp(0.0, float(n - 1))
    i0f = torch.floor(coords)
    frac = coords - i0f
    i0 = i0f.to(torch.int64)
    i1 = (i0 + 1).clamp(0, n - 1)
    i0, i1 = i0 - src0, i1 - src0
    x0 = x.index_select(axis, i0)
    x1 = x.index_select(axis, i1)
    shape = [1] * x.dim()
    shape[axis] = len(out)
    frac = frac.reshape(shape).to(x.dtype)
    return x0 * (1.0 - frac) + x1 * frac


def upscale(x, factor=4, method='bilinear', band=None):
    """Upsample NHWC by an integer factor, torch F.interpolate(bilinear,
    align_corners=False) semantics, separable along H then W.

    ``band``: x is that band of the image (a ``parallel.Band``), and the
    result is its ``factor`` times taller band; the band's sources reach
    one row into each neighbouring band.
    """
    if method != 'bilinear':
        raise NotImplementedError(method)
    if band is None:
        x = _axis_resize(x, 1, x.shape[1] * factor)
    else:
        x = _axis_resize(exchange_halo(x, band, 1, 1), 1,
                         band.total * factor, n=band.total,
                         out=range(band.row0 * factor, band.stop * factor),
                         src0=band.row0 - 1)
    return _axis_resize(x, 2, x.shape[2] * factor)


def bilinear_resize(x, out_h, out_w):
    """NHWC bilinear resample to (out_h, out_w), torch F.interpolate(
    bilinear, align_corners=False) semantics at any scale, up or down, and
    no antialiasing; separable along H then W."""
    return _axis_resize(_axis_resize(x, 1, out_h), 2, out_w)


def nearest_up(x, factor):
    """Nearest-neighbour integer upsample of NHWC (each pixel repeated
    ``factor`` x ``factor`` times)."""
    return x.repeat_interleave(factor, 1).repeat_interleave(factor, 2)


def pixel_shuffle(x, factor=2):
    """Depth-to-space: (B, H, W, C*r*r) -> (B, H*r, W*r, C), output channel
    c taken from input channel c*r*r + dy*r + dx, which is torch's
    F.pixel_shuffle order."""
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)


def pixel_unshuffle(x, factor=2):
    """Space-to-depth, the inverse of ``pixel_shuffle``: (B, H, W, C) ->
    (B, H/r, W/r, C*r*r)."""
    return F.pixel_unshuffle(x.permute(0, 3, 1, 2),
                             factor).permute(0, 2, 3, 1)
