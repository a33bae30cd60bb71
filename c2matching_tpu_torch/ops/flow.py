"""Flow / offset-field utilities for correspondence-seeded aggregation.

Counterpart of ``c2matching_tpu/ops/flow.py``. Each function takes any
number of leading batch axes, so the batched forms are the single-image
forms applied to a (B, ...) tensor.
"""
import torch
import torch.nn.functional as F


def index_to_flow(max_idx, pad=2):
    """Flat row-major match indices (..., h, w) -> (..., h+pad, w+pad, 2)
    float32 relative flow, last dim (x, y), zero-padded bottom/right."""
    h, w = max_idx.shape[-2:]
    max_idx = max_idx.to(torch.int64)
    flow_w = (max_idx % w).to(torch.float32)
    flow_h = (max_idx // w).to(torch.float32)
    grid_x = torch.arange(w, dtype=torch.float32, device=max_idx.device)
    grid_y = torch.arange(h, dtype=torch.float32,
                          device=max_idx.device)[:, None]
    flow = torch.stack((flow_w - grid_x, flow_h - grid_y), dim=-1)
    return F.pad(flow, (0, 0, 0, pad, 0, pad))


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


def match_to_pre_offsets(max_idx, patch_size=3, valid_shape=None):
    """Match indices (..., h-2, w-2) at relu3_1 scale -> the three-scale
    9-candidate pre-offset stacks of the restoration net.

    ``valid_shape``: None, or (vh, vw) valid relu3-scale sizes of
    bucket-padded features. The exact-shape run zero-pads the flow's last
    ``pad`` rows/cols at ITS border, which lies inside the padded grid, so
    the flow is re-zeroed at rows >= vh-pad / cols >= vw-pad.

    Returns:
        {'relu3_1': (..., 9, h, w, 2), 'relu2_1': (..., 9, 2h, 2w, 2),
         'relu1_1': (..., 9, 4h, 4w, 2)}; last dim (x, y).
    """
    pad = patch_size - 1
    flow3 = index_to_flow(max_idx, pad=pad)
    if valid_shape is not None:
        h, w = flow3.shape[-3:-1]
        row = torch.arange(h, device=flow3.device)[:, None, None]
        col = torch.arange(w, device=flow3.device)[None, :, None]
        keep = (row < int(valid_shape[0]) - pad) & \
            (col < int(valid_shape[1]) - pad)
        flow3 = flow3 * keep.to(flow3.dtype)
    return {'relu3_1': shifted_offsets(flow3, step=1),
            'relu2_1': shifted_offsets(upsample_flow(flow3, 2), step=2),
            'relu1_1': shifted_offsets(upsample_flow(flow3, 4), step=4)}


def batched_pre_offsets(max_idx, patch_size=3, valid_shape=None):
    """``match_to_pre_offsets`` over a (B, h-2, w-2) batch; ``valid_shape``
    is shared by the batch."""
    return match_to_pre_offsets(max_idx, patch_size, valid_shape)
