"""Flow / offset-field utilities for correspondence-seeded aggregation.

Counterpart of ``c2matching_tpu/ops/flow.py``. Each function takes any
number of leading batch axes, so the batched forms are the single-image
forms applied to a (B, ...) tensor.

With a ``band`` (a ``parallel.Band`` at the relu3 scale,
``val_spatial_shard``) the match indices are one rank's query rows and
the results that rank's rows of the image's.
"""
import torch
import torch.nn.functional as F

from ..parallel.spatial import exchange_halo
from .resize import bilinear_resize

# the candidates' shifts reach 2 relu3-scale rows (i * step for i < 3 at
# each scale's step)
SHIFT_REACH = 2


def index_to_flow(max_idx, pad=2, band=None):
    """Flat row-major match indices (..., h, w) -> (..., h+pad, w+pad, 2)
    float32 relative flow, last dim (x, y), zero-padded bottom/right.

    ``band``: the indices are the query rows ``[row0, row0 + h)`` of the
    band; the flow is the band's ``rows``, zero-padded at the image's
    bottom only."""
    h, w = max_idx.shape[-2:]
    row0 = 0 if band is None else band.row0
    bottom = pad if band is None else band.rows - h
    max_idx = max_idx.to(torch.int64)
    flow_w = (max_idx % w).to(torch.float32)
    flow_h = (max_idx // w).to(torch.float32)
    grid_x = torch.arange(w, dtype=torch.float32, device=max_idx.device)
    grid_y = torch.arange(row0, row0 + h, dtype=torch.float32,
                          device=max_idx.device)[:, None]
    flow = torch.stack((flow_w - grid_x, flow_h - grid_y), dim=-1)
    return F.pad(flow, (0, 0, 0, pad, 0, bottom))


def tensor_shift(x, shift, fill_val=0.0):
    """Shift (..., h, w, c) down/right by (shift_h, shift_w), filling."""
    shift_h, shift_w = shift
    h, w = x.shape[-3:-1]
    padded = F.pad(x, (0, 0, shift_w, 0, shift_h, 0), value=fill_val)
    return padded[..., :h, :w, :]


def shifted_offsets(flow, step):
    """(..., h, w, 2) -> (..., 9, h, w, 2): the (i*step, j*step) shifted
    copies, candidates in (i, j) row-major order."""
    return torch.stack([tensor_shift(flow, (i * step, j * step))
                        for i in range(3) for j in range(3)], dim=-4)


def upsample_flow(flow, factor):
    """Nearest-upsample (..., h, w, c) by ``factor`` and scale the values
    by it."""
    up = flow.repeat_interleave(factor, dim=-3).repeat_interleave(factor,
                                                                  dim=-2)
    return up * float(factor)


def match_to_pre_offsets(max_idx, patch_size=3, band=None):
    """Match indices (..., h-2, w-2) at relu3_1 scale -> the three-scale
    9-candidate pre-offset stacks of the restoration net.

    ``band``: the relu3-scale band of the indices' query rows; each result
    is that band's rows at its scale. The shifted copies reach
    ``SHIFT_REACH`` relu3 rows above the band, taken from the rank above
    before the upsampling.

    Returns:
        {'relu3_1': (..., 9, h, w, 2), 'relu2_1': (..., 9, 2h, 2w, 2),
         'relu1_1': (..., 9, 4h, 4w, 2)}; last dim (x, y).
    """
    flow3 = index_to_flow(max_idx, pad=patch_size - 1, band=band)
    if band is None:
        return {'relu3_1': shifted_offsets(flow3, step=1),
                'relu2_1': shifted_offsets(upsample_flow(flow3, 2), step=2),
                'relu1_1': shifted_offsets(upsample_flow(flow3, 4), step=4)}
    ext = exchange_halo(flow3, band, SHIFT_REACH, 0)
    out = {}
    for key, f in (('relu3_1', 1), ('relu2_1', 2), ('relu1_1', 4)):
        up = ext if f == 1 else upsample_flow(ext, f)
        out[key] = shifted_offsets(up, step=f)[..., SHIFT_REACH * f:, :, :]
    return out


def batched_pre_offsets(max_idx, patch_size=3, band=None):
    """``match_to_pre_offsets`` over a (B, h-2, w-2) batch."""
    return match_to_pre_offsets(max_idx, patch_size, band)


def resize_flow(flow, size_type, sizes, method='bilinear'):
    """Resize a flow field (B, H, W, 2), last dim (x, y), by a ratio
    (``sizes`` = (ratio_h, ratio_w)) or to a shape (``sizes`` = (h, w)),
    its values scaled by the resize ratios; bilinear without
    antialiasing."""
    _, flow_h, flow_w, _ = flow.shape
    if size_type == 'ratio':
        output_h = int(flow_h * sizes[0])
        output_w = int(flow_w * sizes[1])
    elif size_type == 'shape':
        output_h, output_w = sizes
    else:
        raise ValueError(
            f'Size type should be ratio or shape, but got {size_type}.')
    if method != 'bilinear':
        raise NotImplementedError(method)
    scale = torch.tensor([output_w / flow_w, output_h / flow_h],
                         dtype=flow.dtype, device=flow.device)
    return bilinear_resize(flow * scale, output_h, output_w)


def flow_warp(x, flow):
    """Bilinear warp of x (B, H, W, C) by flow (B, H, W, 2), last dim
    (x, y), with zero padding, as the reference's ``flow_warp``: the point
    v = grid + flow is normalised to 2v / max(n - 1, 1) - 1 and sampled by
    ``F.grid_sample(align_corners=False)``, so each axis is read at
    v * n / (n - 1) - 0.5 (a border-growing rescale, not plain grid +
    flow)."""
    _, h, w, _ = x.shape
    grid_y = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    grid_x = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    vx = 2.0 * (grid_x + flow[..., 0]) / max(w - 1, 1) - 1.0
    vy = 2.0 * (grid_y + flow[..., 1]) / max(h - 1, 1) - 1.0
    grid = torch.stack((vx, vy), dim=-1).to(x.dtype)
    out = F.grid_sample(x.permute(0, 3, 1, 2), grid, mode='bilinear',
                        padding_mode='zeros', align_corners=False)
    return out.permute(0, 2, 3, 1)
