"""Modulated deformable convolution (DCNv2), forward.

Counterpart of ``c2matching_tpu/ops/deform_conv.py``. The bilinear
sampling at the learned offsets, times the modulation mask, runs in kernel
B3 (``csrc/deform_conv.cu``), which writes the columns
``cols[p, k*C + c]`` as upstream's dcn_v2_im2col_cuda.cu does: one thread
(or 2-4 lanes) per (pixel, tap, group) sample, 16-byte vectors over the
group's channels, 32-bit index math where the image's extents allow it and
a 64-bit instantiation otherwise. The
contraction with the weight is one ``torch.matmul``. On a CPU tensor
``deform_im2col`` takes its plain version, the per-tap gather of the JAX
package's ``_mdc_reference_single``; on a CUDA tensor it launches the
kernel or raises.

Layout, as in the JAX package:
    x:      (B, H, W, C)          NHWC, float32 or bfloat16
    offset: (B, Ho, Wo, G, K, 2)  float32, last dim (dy, dx)
    mask:   (B, Ho, Wo, G, K)     float32 modulation (post-sigmoid)
    weight: (K, C, Cout)          taps in row-major (ky, kx) order
    bias:   (Cout,)

Sampling semantics (c2matching_tpu/ops/deform_conv.py:60-67): the sample
point y = ho*stride - pad + ky*dilation + offset_y is interpolated
bilinearly with zero padding; a tap is zero unless -1 < y < H and
-1 < x < W; corners outside the image contribute zero. Coordinates stay
f32 when x is bf16; the columns are stored in x's dtype, and the
contraction takes bf16 columns and weights with f32 accumulation.
"""
import ctypes

import torch

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + [ctypes.c_void_p])
_ENTRY = {torch.float32: 'c2m_mdc_im2col_f32',
          torch.bfloat16: 'c2m_mdc_im2col_bf16'}


def _kernel(dtype):
    fn = getattr(_build.load('deform_conv'), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _bilinear_gather_tap(xf, sy, sx, h, w):
    """Bilinear sample for one kernel tap, zero-padded.

    xf: (H*W, G, Cg) f32; sy, sx: (P, G) f32. Returns (P, G, Cg)."""
    valid = (sy > -1.0) & (sy < h) & (sx > -1.0) & (sx < w)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    fy = sy - y0
    fx = sx - x0
    # clamp before the int conversion: huge offsets must not overflow
    y0i = y0.clamp(-2, h).to(torch.int64)
    x0i = x0.clamp(-2, w).to(torch.int64)
    groups = torch.arange(xf.shape[1], device=xf.device)[None, :]
    out = 0
    for dy in (0, 1):
        for dx in (0, 1):
            yy = y0i + dy
            xx = x0i + dx
            wy = fy if dy else 1.0 - fy
            wx = fx if dx else 1.0 - fx
            inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            weight = wy * wx * inb.to(xf.dtype)
            flat = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
            out = out + xf[flat, groups] * weight[..., None]
    return out * valid[..., None].to(xf.dtype)


def _check(x, offset, mask):
    if x.dim() != 3 or offset.dim() != 5 or mask.dim() != 4:
        raise ValueError('deform_im2col takes one image: x (H, W, C), offset '
                         '(Ho, Wo, G, K, 2), mask (Ho, Wo, G, K)')
    if offset.shape[:4] != mask.shape or offset.shape[-1] != 2:
        raise ValueError(f'offset {tuple(offset.shape)} and mask '
                         f'{tuple(mask.shape)} do not pair')
    if x.shape[-1] % offset.shape[2]:
        raise ValueError('channels must divide into the deformable groups')


def _base_grid(ho, wo, kh, kw, stride, padding, dilation, device):
    """Base sampling coords, f32: (P,) per output pixel (row-major) and
    (K,) per tap (row-major (ky, kx))."""
    oy = torch.arange(ho, device=device, dtype=torch.float32) * stride[0] \
        - padding[0]
    ox = torch.arange(wo, device=device, dtype=torch.float32) * stride[1] \
        - padding[1]
    ky = (torch.arange(kh, device=device, dtype=torch.float32)[:, None]
          * dilation[0]).expand(kh, kw).reshape(-1)
    kx = (torch.arange(kw, device=device, dtype=torch.float32)[None, :]
          * dilation[1]).expand(kh, kw).reshape(-1)
    base_y = oy[:, None].expand(ho, wo).reshape(-1)
    base_x = ox[None, :].expand(ho, wo).reshape(-1)
    return base_y, base_x, ky, kx


def deform_im2col_plain(x, offset, mask, kernel_size=(3, 3), stride=(1, 1),
                        padding=(1, 1), dilation=(1, 1)):
    """Plain version of ``deform_im2col``: a torch gather per tap."""
    _check(x, offset, mask)
    h, w, c = x.shape
    ho, wo, g, k, _ = offset.shape
    p = ho * wo
    base_y, base_x, ky, kx = _base_grid(
        ho, wo, *_pair(kernel_size), _pair(stride), _pair(padding),
        _pair(dilation), x.device)
    base_y = base_y[:, None]
    base_x = base_x[:, None]
    off = offset.float().reshape(p, g, k, 2)
    m = mask.float().reshape(p, g, k)
    xf = x.float().reshape(h * w, g, c // g)
    taps = []
    for t in range(k):
        sy = base_y + ky[t] + off[:, :, t, 0]
        sx = base_x + kx[t] + off[:, :, t, 1]
        vals = _bilinear_gather_tap(xf, sy, sx, h, w)
        taps.append((vals * m[:, :, t, None]).reshape(p, c))
    return torch.stack(taps, dim=1).reshape(p, k * c).to(x.dtype)


def deform_im2col(x, offset, mask, kernel_size=(3, 3), stride=(1, 1),
                  padding=(1, 1), dilation=(1, 1)):
    """Modulated bilinear columns of ONE image.

    Args:
        x: (H, W, C) float32 or bfloat16.
        offset: (Ho, Wo, G, K, 2) float32, last dim (dy, dx).
        mask: (Ho, Wo, G, K) float32.
    Returns:
        (Ho*Wo, K*C) columns in x's dtype, ``cols[p, k*C + c]``.
    """
    if x.device.type == 'cpu':
        return deform_im2col_plain(x, offset, mask, kernel_size, stride,
                                   padding, dilation)
    if x.device.type != 'cuda':
        raise ValueError(f'deform_im2col: unsupported device {x.device}')
    _check(x, offset, mask)
    if x.dtype not in _ENTRY:
        raise TypeError(f'deform_im2col: x must be float32 or bfloat16, got '
                        f'{x.dtype}')
    if offset.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError('deform_im2col: offset and mask must be float32')
    if offset.device != x.device or mask.device != x.device:
        raise ValueError('deform_im2col: tensors lie on different devices')
    h, w, c = x.shape
    ho, wo, g, k, _ = offset.shape
    kh, kw = _pair(kernel_size)
    if kh * kw != k:
        raise ValueError(f'kernel_size {kh}x{kw} does not give {k} taps')
    x = x.contiguous()
    offset = offset.contiguous()
    mask = mask.contiguous()
    cols = torch.empty((ho * wo, k * c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel(x.dtype)(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), cols.data_ptr(),
            h, w, c, ho, wo, g, kh, kw, *_pair(stride), *_pair(padding),
            *_pair(dilation), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'deform_im2col kernel launch failed: CUDA error '
                           f'{err}')
    deform_im2col.launches += 1
    return cols


deform_im2col.launches = 0


def modulated_deform_conv(x, offset, mask, weight, bias=None,
                          kernel_size=(3, 3), stride=(1, 1), padding=(1, 1),
                          dilation=(1, 1)):
    """Batched modulated deformable convolution (DCNv2 forward).

    Args:
        x:      (B, H, W, C) the feature to sample (f32 or bf16).
        offset: (B, Ho, Wo, G, K, 2) sampling offsets, last dim (dy, dx).
        mask:   (B, Ho, Wo, G, K) modulation (already sigmoid-ed).
        weight: (K, C, Cout) taps in row-major (ky, kx) order.
        bias:   (Cout,) or None.

    Returns:
        (B, Ho, Wo, Cout) float32. Images run one at a time, which bounds
        the columns' memory to one image. Forward only: the kernel has no
        backward yet.
    """
    b, _, _, c = x.shape
    _, ho, wo, _, k, _ = offset.shape
    co = weight.shape[-1]
    # bf16 columns meet bf16-rounded weights; products accumulate in f32
    w_kc = weight.reshape(k * c, co).to(x.dtype).float()
    offset = offset.float()
    mask = mask.float()
    out = torch.stack([
        torch.matmul(deform_im2col(x[i], offset[i], mask[i], kernel_size,
                                   stride, padding, dilation).float(), w_kc)
        for i in range(b)]).reshape(b, ho, wo, co)
    if bias is not None:
        out = out + bias.float()
    return out


def deform_conv(x, offset, weight, bias=None, kernel_size=(3, 3),
                stride=(1, 1), padding=(1, 1), dilation=(1, 1)):
    """Unmodulated deformable convolution (DCNv1): DCNv2 with mask 1."""
    mask = torch.ones(offset.shape[:-1], dtype=torch.float32,
                      device=offset.device)
    return modulated_deform_conv(x, offset, mask, weight, bias, kernel_size,
                                 stride, padding, dilation)
