"""Candidate-block windowed formulation of the modulated deformable conv,
forward only.

Counterpart of ``c2matching_tpu/ops/dcn_window.py``. As there, it is an
op-level entry point that no model calls: the formulation was measured and
closed as a production candidate on the TPU, and whether it pays on a GPU
is recorded in PERF.md, not assumed.

The formulation rests on one property of DynAgg's offsets (ops/flow.py:
the match flow is constant over aligned blocks of 4 output pixels at
relu1 and 2 at relu2, nearest-upsampled): the pre-offset of tap k at
output pixel p is a block-constant integer flow plus a small learned
residual, so for an aligned ``blk x blk`` output block b and tap k, all
blk^2 pixels x G groups sample inside one small window around a shared
anchor. The bilinear corner weights become tents, tent(d) = max(0,
1 - |d|), contracted over one ``win x win x C`` window per (block, tap)
and then with the conv weight in kernel B2 (``window_conv``,
``csrc/dcn_window.cu``), which reads each window from the image at its
origin: no window buffer is gathered (the JAX package gathers one because
its Pallas kernel cannot). Out-of-image cells read as zeros, which
reproduces the exact op's zero padding.

The formulation is valid only when every in-bounds tap's bilinear support
lies inside its block's window. ``modulated_deform_conv_windowed`` tests
that per image and otherwise takes the exact op (``modulated_deform_conv``,
kernel B3): the same semantics for arbitrary offsets. JAX switches with
``jax.lax.cond`` on the device; here the branch is a Python ``if`` on
``bool(ok)``, which costs one host sync per image. The JAX op's
``group_scan`` only tunes XLA's exact path and ``use_pallas`` picks the
TPU kernel; the port has neither: ``window_conv`` launches its kernel on
a CUDA tensor and takes its plain version (``_window_gather``, then the
dense contraction) on a CPU tensor.

Parity target: the sampling semantics of ops/deform_conv.py.
"""
import torch

from .dcn_window_kernel import (  # noqa: F401 (_window_gather: re-exported)
    MARGIN, _window_gather, window_conv)
from .deform_conv import _base_grid, modulated_deform_conv


def _window_prep(x, offset, mask, blk, win):
    """Shared prep: sample coords, per-(block, tap) window origins,
    in-window relative coords, modulation, coverage predicate.

    Args:
        x: (H, W, C) one image.
        offset: (Ho, Wo, G, K, 2), mask: (Ho, Wo, G, K).
    Returns (origins, ry, rx, mm, ok):
        origins: (NB, K, 2) int32 window origins (y, x), clamped.
        ry, rx: (G, K, P) f32 coords relative to the block's window origin.
        mm: (G, K, P) f32 modulation * validity.
        ok: 0-d bool tensor, every valid tap's bilinear support in-window.
    """
    h, w, _ = x.shape
    ho, wo, g, k, _ = offset.shape
    p = ho * wo
    m = MARGIN

    base_y, base_x, ky, kx = _base_grid(ho, wo, 3, 3, (1, 1), (1, 1),
                                        (1, 1), x.device)
    offt = (offset.float().reshape(p, g * k * 2).T.reshape(g, k, 2, p))
    sy = base_y[None, None, :] + ky[None, :, None] + offt[:, :, 0]
    sx = base_x[None, None, :] + kx[None, :, None] + offt[:, :, 1]
    mt = mask.float().reshape(p, g * k).T.reshape(g, k, p)
    valid = (sy > -1.) & (sy < h) & (sx > -1.) & (sx < w)
    mm = mt * valid.float()

    # window origin per (block, tap) from group 0's top-left pixel; clamped
    # before the int conversion, so huge offsets cannot overflow
    nby, nbx = ho // blk, wo // blk
    s0y = sy[0].reshape(k, ho, wo)[:, ::blk, ::blk]      # (K, NBy, NBx)
    s0x = sx[0].reshape(k, ho, wo)[:, ::blk, ::blk]
    oy = (torch.floor(s0y) - 1).clamp(-m, h + m - win).to(torch.int32)
    ox = (torch.floor(s0x) - 1).clamp(-m, w + m - win).to(torch.int32)

    def rel(s, o):
        # broadcast the origin over the block's pixels
        ob = o[:, :, None, :, None].expand(k, nby, blk, nbx, blk)
        return s - ob.reshape(k, p).float()[None]         # (G, K, P)

    ry = rel(sy, oy)
    rx = rel(sx, ox)

    inw = (ry >= 0.) & (ry < win - 1.) & (rx >= 0.) & (rx < win - 1.)
    ok = torch.all(inw | ~valid)

    origins = torch.stack([oy.reshape(k, -1).T, ox.reshape(k, -1).T],
                          dim=-1)                         # (NB, K, 2)
    return origins, ry, rx, mm, ok


def _mdc_window_single(x, origins, ry, rx, mm, weight, blk, win,
                       out_hw=None):
    h, w, _ = x.shape
    if out_hw is None:
        out_hw = (h, w)
    nby, nbx = out_hw[0] // blk, out_hw[1] // blk
    return window_conv(x, origins, ry, rx, mm, weight, blk, win, nby, nbx)


def window_applicable(x_shape, offset_shape, blk, win, kernel_size=(3, 3),
                      stride=(1, 1), padding=(1, 1), dilation=(1, 1)):
    """Static check: shapes/config admit the windowed formulation."""
    _, h, w, _ = x_shape
    _, ho, wo, _, k, _ = offset_shape
    return ((kernel_size, stride, padding, dilation)
            == ((3, 3), (1, 1), (1, 1), (1, 1))
            and k == 9 and ho == h and wo == w and blk >= 1 and win >= 4
            and h % blk == 0 and w % blk == 0
            and h + 2 * MARGIN >= win and w + 2 * MARGIN >= win)


def modulated_deform_conv_windowed_chunked(x, offset, mask, weight,
                                           bias=None, blk=4, win=8,
                                           row_chunks=8):
    """Windowed path with the output rows taken in ``row_chunks``
    sequential chunks, which bounds the memory of the fields to one
    chunk's. Each chunk's kernel reads the whole image at its windows'
    origins (windows near a chunk boundary reach outside the chunk's
    rows); no window buffer exists.

    Assumes the windowed formulation is valid for the given offsets (the
    DynAgg structure: block-constant integer flow + small residual);
    unlike ``modulated_deform_conv_windowed`` there is no fallback. A
    chunk's output rows become global by adding the chunk's row origin
    to the y-offsets in f32 (the prep's base grid is position-linear).

    Returns (B, H, W, Co) float32.
    """
    b, h, w, _ = x.shape
    if h % row_chunks or (h // row_chunks) % blk:
        raise ValueError(f'{h} rows do not split into {row_chunks} chunks of '
                         f'whole {blk}-row blocks')
    rows_per = h // row_chunks
    outs = []
    for i in range(b):
        chunks = []
        for ci in range(row_chunks):
            r0 = ci * rows_per
            oc = offset[i, r0:r0 + rows_per].float().clone()
            oc[..., 0] += r0
            origins, ry, rx, mm, _ = _window_prep(
                x[i], oc, mask[i, r0:r0 + rows_per], blk, win)
            chunks.append(_mdc_window_single(x[i], origins, ry, rx, mm,
                                             weight, blk, win,
                                             out_hw=(rows_per, w)))
        outs.append(torch.cat(chunks, dim=0))
    out = torch.stack(outs)
    if bias is not None:
        out = out + bias.float()
    return out


def modulated_deform_conv_windowed(x, offset, mask, weight, bias=None,
                                   blk=4, win=8):
    """DCNv2 forward with the candidate-block windowed fast path.

    Same semantics as ``modulated_deform_conv`` for the 3x3 / stride-1 /
    pad-1 / dilation-1 configuration, for arbitrary offsets: per image, the
    coverage predicate picks the windowed kernel when every valid tap's
    bilinear support lies inside its block window, and the exact op
    otherwise. Shapes the formulation does not admit take the exact op
    entirely.

    Args match ``modulated_deform_conv``; ``blk`` is the aligned output
    block (4 at relu1, 2 at relu2), ``win`` the window size in cells
    (blk + 4 covers a residual spread below 1).
    Returns (B, H, W, Co) float32.
    """
    if not window_applicable(x.shape, offset.shape, blk, win):
        return modulated_deform_conv(x, offset, mask, weight, bias)
    outs = []
    for i in range(x.shape[0]):
        origins, ry, rx, mm, ok = _window_prep(x[i], offset[i], mask[i], blk,
                                               win)
        if bool(ok):  # one host sync per image
            outs.append(_mdc_window_single(x[i], origins, ry, rx, mm, weight,
                                           blk, win))
        else:
            outs.append(modulated_deform_conv(
                x[i:i + 1], offset[i:i + 1], mask[i:i + 1], weight)[0])
    out = torch.stack(outs)
    if bias is not None:
        out = out + bias.float()
    return out
