"""Dense patch matching between input and reference features.

Counterpart of ``c2matching_tpu/ops/patch_match.py``, with the same
semantics, pinned to the reference's chunked conv2d search:

- features are L2-normalized per spatial position over channels;
- ref patch descriptors are L2-normalized per patch with +1e-5 on the norm;
- correlation = <input 3x3 window, normalized ref patch> at valid
  positions only, so the output is (H-2, W-2) for patch_size 3;
- argmax over ref patches, the first maximum winning;
- the maximum is divided by the input patch norm (+1e-5).

Features are NHWC. The correlation and argmax run in kernel B1
(``patch_match_kernel.match_argmax``) on a CUDA tensor, and in its plain
version on a CPU tensor.

With a ``band`` (``val_spatial_shard``) the input features are one rank's
horizontal band and the reference's are whole: the rank matches the
query rows of its band against every reference patch.
"""
import torch

from ..parallel.spatial import exchange_halo
from .patch_match_kernel import match_argmax


def as_dtype(dtype):
    """A torch dtype from a torch dtype, a name such as 'bfloat16', or None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def normalize_per_pixel(feat, eps=1e-12):
    """L2-normalize each spatial position's channel vector (last axis), with
    torch F.normalize's eps clamp on the norm."""
    norm = torch.sqrt(torch.sum(feat * feat, dim=-1, keepdim=True))
    return feat / torch.clamp(norm, min=eps)


def unfold_descriptors(feat, patch_size=3):
    """Unfold (..., H, W, C) into (..., H-p+1, W-p+1, p*p*C) patch
    descriptors, each flattening feat[i:i+p, j:j+p, :] in row-major
    (ky, kx, c) order."""
    h, w, c = feat.shape[-3:]
    p = patch_size
    rows = [feat[..., ky:h - p + 1 + ky, kx:w - p + 1 + kx, :]
            for ky in range(p) for kx in range(p)]
    stacked = torch.stack(rows, dim=-2)
    return stacked.reshape(*feat.shape[:-3], h - p + 1, w - p + 1, p * p * c)


def batched_patch_match(feat_in, feat_ref, patch_size=3, compute_dtype=None,
                        band=None):
    """Dense patch matching for a batch of image pairs.

    Args:
        feat_in: (B, H, W, C) input features (the upsampled LR branch).
        feat_ref: (B, H, W, C) reference features.
        patch_size: patch side length.
        compute_dtype: None (f32) or e.g. 'bfloat16': the dtype of the
            correlation OPERANDS only. Normalization, accumulation and the
            returned value stay f32.
        band: None, or the ``parallel.Band`` of ``feat_in`` (its rows of
            the image; ``feat_ref`` is whole): the query rows are the
            band's ``[row0, min(row0 + rows, H-p+1))``, whose patches reach
            p-1 rows into the band below, taken from its rank.

    Returns:
        (max_idx int32, max_val float32), both (B, H-p+1, W-p+1), or
        (B, nq, W-p+1) for the band's nq query rows: ``max_idx`` is the
        flat row-major index of the best ref patch.
    """
    if band is not None:
        feat_in = exchange_halo(feat_in, band, 0, patch_size - 1)
    d_in = unfold_descriptors(normalize_per_pixel(feat_in), patch_size)
    if band is not None:
        last = band.total - (patch_size - 1)
        d_in = d_in[:, :max(0, min(band.stop, last) - band.row0)]
    b, hh, ww, dim = d_in.shape
    q = d_in.reshape(b, hh * ww, dim)
    r = unfold_descriptors(normalize_per_pixel(feat_ref), patch_size)
    hr, wr = r.shape[1:3]
    r = r.reshape(b, hr * wr, dim)
    r_norm = torch.sqrt(torch.sum(r * r, dim=-1, keepdim=True)) + 1e-5
    r = r / r_norm

    # q_norm from the full-precision descriptors, before any cast
    q_norm = torch.sqrt(torch.sum(q * q, dim=-1)) + 1e-5
    dtype = as_dtype(compute_dtype)
    if dtype is not None:
        q = q.to(dtype)
        r = r.to(dtype)

    if q.shape[1]:
        max_idx, max_val = match_argmax(q, r)
    else:   # a band below the last query row, or features under p rows
        max_idx = torch.zeros((b, 0), dtype=torch.int32, device=q.device)
        max_val = torch.zeros((b, 0), dtype=torch.float32, device=q.device)
    max_val = max_val / q_norm
    return max_idx.reshape(b, hh, ww), max_val.reshape(b, hh, ww)


def patch_match(feat_in, feat_ref, patch_size=3, compute_dtype=None):
    """``batched_patch_match`` for one (H, W, C) image pair."""
    idx, val = batched_patch_match(feat_in[None], feat_ref[None], patch_size,
                                   compute_dtype)
    return idx[0], val[0]
