"""Modulated deformable convolution (DCNv2), forward and backward.

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

Where no graph is recorded (serving, the test runner, validation,
``torch.export``) and the shape is one the fused kernel takes
(``fused_applicable``: 3x3 taps, stride 1, dilation 1, any padding, a
group width of whole 16-byte vectors), the forward is one launch over the
batch of ``deform_conv_fused`` (``csrc/deform_conv_fused.cu``), which
samples into shared memory and contracts there on the tensor cores: no
columns in device memory, no upcast, no ``torch.matmul``, no per-image
loop. Every other shape, and every forward under autograd, takes the
columns.

The gradient is the ``torch.autograd.Function`` ``_ModulatedDeformConv``
over the whole op of a batch. Its backward computes the offset and mask
gradients, and grad_x when autograd asks for it, for every image in one
launch of B3's backward kernel (``csrc/deform_conv_backward.cu``,
``deform_conv_backward``), which forms the columns' gradient
``grad_out @ w_kc^T`` on the tensor cores and never stores it; the weight
and bias gradients are ``torch.matmul`` and a sum. A shape wider than the
kernel takes (a group of more than ``BACKWARD_MAX_GROUP`` channels, Co
above ``BACKWARD_MAX_CO`` or off a multiple of 4) is served by several
launches of the same kernel (``split_backward``). The semantics are those
of ``jax.grad`` through the JAX package's ``_mdc_fast_single``: floor has
zero derivative, a sample outside the image contributes nothing, and
corners outside the image are zeros that receive no gradient.

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
from typing import List, Optional

import torch
import torch.nn.functional as F

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + [ctypes.c_void_p])
_ENTRY = {torch.float32: 'c2m_mdc_im2col_f32',
          torch.bfloat16: 'c2m_mdc_im2col_bf16'}
_COL2IM_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 14
                    + [ctypes.c_void_p])
_COL2IM_ENTRY = {torch.float32: 'c2m_mdc_col2im_f32',
                 torch.bfloat16: 'c2m_mdc_col2im_bf16'}
_BACKWARD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 16
                      + [ctypes.c_void_p])
_BACKWARD_ENTRY = {torch.float32: 'c2m_mdc_backward_f32',
                   torch.bfloat16: 'c2m_mdc_backward_bf16'}
_FUSED_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 16
                   + [ctypes.c_void_p])
_FUSED_ENTRY = {torch.float32: 'c2m_mdc_fused_f32',
                torch.bfloat16: 'c2m_mdc_fused_bf16'}
# the backward kernel takes groups of at most this many channels, and
# grad_out rows of at most this many (its tile of them in shared memory)
BACKWARD_MAX_GROUP = 64
BACKWARD_MAX_CO = 320

_fns = {}


def _kernel(lib, name, argtypes):
    """The C entry ``name`` of kernel library ``lib``, its argument types
    set at the first call."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _device(x, name):
    """'cpu' or 'cuda'; any other device (meta included, where an operator
    would take its fake implementation) is refused."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name}: unsupported device {x.device}')
    return x.device.type


def _pair(v):
    return [v, v] if isinstance(v, int) else list(v)


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

    Calls the registered operator ``torch.ops.c2matching.deform_im2col``:
    on a CPU tensor the plain version, on a CUDA tensor the kernel (or a
    refusal); ``deform_im2col.launches`` counts the kernel's launches.
    """
    _device(x, 'deform_im2col')
    return torch.ops.c2matching.deform_im2col(
        x, offset, mask, _pair(kernel_size), _pair(stride), _pair(padding),
        _pair(dilation))


deform_im2col.launches = 0


@torch.library.custom_op('c2matching::deform_im2col', mutates_args=())
def _deform_im2col_op(x: torch.Tensor, offset: torch.Tensor,
                      mask: torch.Tensor, kernel_size: List[int],
                      stride: List[int], padding: List[int],
                      dilation: List[int]) -> torch.Tensor:
    """The operator behind ``deform_im2col``."""
    if _device(x, 'deform_im2col') == 'cpu':
        return deform_im2col_plain(x, offset, mask, kernel_size, stride,
                                   padding, dilation)
    _im2col_check(x, offset, mask, kernel_size)
    h, w, c = x.shape
    ho, wo, g, k, _ = offset.shape
    kh, kw = kernel_size
    x = x.contiguous()
    offset = offset.contiguous()
    mask = mask.contiguous()
    cols = torch.empty((ho * wo, k * c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel('deform_conv', _ENTRY[x.dtype], _ARGTYPES)(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), cols.data_ptr(),
            h, w, c, ho, wo, g, kh, kw, *stride, *padding, *dilation,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'deform_im2col kernel launch failed: CUDA error '
                           f'{err}')
    deform_im2col.launches += 1
    return cols


@_deform_im2col_op.register_fake
def _(x, offset, mask, kernel_size, stride, padding, dilation):
    _check(x, offset, mask)
    if x.device.type == 'cuda':
        _im2col_check(x, offset, mask, kernel_size)
    ho, wo, _, k, _ = offset.shape
    return x.new_empty((ho * wo, k * x.shape[-1]))


def _im2col_check(x, offset, mask, kernel_size):
    """Refuse what the kernel does not take."""
    _check(x, offset, mask)
    if x.dtype not in _ENTRY:
        raise TypeError(f'deform_im2col: x must be float32 or bfloat16, got '
                        f'{x.dtype}')
    if offset.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError('deform_im2col: offset and mask must be float32')
    if offset.device != x.device or mask.device != x.device:
        raise ValueError('deform_im2col: tensors lie on different devices')
    kh, kw = kernel_size
    if kh * kw != offset.shape[3]:
        raise ValueError(f'kernel_size {kh}x{kw} does not give '
                         f'{offset.shape[3]} taps')


def deform_im2col_backward_plain(x, offset, mask, grad_cols,
                                 kernel_size=(3, 3), stride=(1, 1),
                                 padding=(1, 1), dilation=(1, 1),
                                 needs=(True, True, True)):
    """Plain version of ``deform_col2im``: per tap, the four corners'
    values dotted with the group's grad_cols, and grad_x scattered with
    ``index_put_``. ``needs`` says which of (grad_x, grad_offset, grad_mask)
    to compute; the others are None. grad_x is in x's dtype, the other two
    f32."""
    _check(x, offset, mask)
    h, w, c = x.shape
    ho, wo, g, k, _ = offset.shape
    p = ho * wo
    cg = c // g
    base_y, base_x, ky, kx = _base_grid(
        ho, wo, *_pair(kernel_size), _pair(stride), _pair(padding),
        _pair(dilation), x.device)
    off = offset.float().reshape(p, g, k, 2)
    m = mask.float().reshape(p, g, k)
    xf = x.float().reshape(h * w, g, cg)
    gc = grad_cols.float().reshape(p, k, g, cg)
    groups = torch.arange(g, device=x.device)[None, :].expand(p, g)
    grad_x = torch.zeros_like(xf) if needs[0] else None
    grad_off = torch.zeros(p, g, k, 2, device=x.device) if needs[1] else None
    grad_m = torch.zeros(p, g, k, device=x.device) if needs[2] else None
    for t in range(k):
        sy = base_y[:, None] + ky[t] + off[:, :, t, 0]
        sx = base_x[:, None] + kx[t] + off[:, :, t, 1]
        valid = (sy > -1.0) & (sy < h) & (sx > -1.0) & (sx < w)
        y0 = torch.floor(sy)
        x0 = torch.floor(sx)
        fy = sy - y0
        fx = sx - x0
        y0i = y0.clamp(-2, h).to(torch.int64)
        x0i = x0.clamp(-2, w).to(torch.int64)
        mt = torch.where(valid, m[:, :, t], 0.0)
        g_t = gc[:, t]                                    # (P, G, Cg)
        d_y = d_x = sample = 0
        for dy in (0, 1):
            for dx in (0, 1):
                yy = y0i + dy
                xx = x0i + dx
                inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                flat = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
                vals = xf[flat, groups] * inb[..., None].to(xf.dtype)
                dot = (vals * g_t).sum(-1)                # (P, G)
                wy = fy if dy else 1.0 - fy
                wx = fx if dx else 1.0 - fx
                sample = sample + wy * wx * dot
                # d wy / d fy = +1 for the lower corner row, -1 for the upper
                d_y = d_y + (wx if dy else -wx) * dot
                d_x = d_x + (wy if dx else -wy) * dot
                if grad_x is not None:
                    coef = torch.where(inb, mt * wy * wx, 0.0)
                    grad_x.index_put_((flat, groups), g_t * coef[..., None],
                                      accumulate=True)
        if grad_off is not None:
            grad_off[:, :, t, 0] = torch.where(valid, mt * d_y, 0.0)
            grad_off[:, :, t, 1] = torch.where(valid, mt * d_x, 0.0)
        if grad_m is not None:
            grad_m[:, :, t] = torch.where(valid, sample, 0.0)
    return (None if grad_x is None else grad_x.reshape(h, w, c).to(x.dtype),
            None if grad_off is None else grad_off.reshape(ho, wo, g, k, 2),
            None if grad_m is None else grad_m.reshape(ho, wo, g, k))


def deform_col2im(x, offset, mask, grad_cols, kernel_size=(3, 3),
                  stride=(1, 1), padding=(1, 1), dilation=(1, 1),
                  needs=(True, True, True)):
    """The gradients of ``deform_im2col`` of one image from grad_cols
    (Ho*Wo, K*C): (grad_x (H, W, C) in x's dtype, grad_offset
    (Ho, Wo, G, K, 2) f32, grad_mask (Ho, Wo, G, K) f32), each None unless
    ``needs`` asks for it. The columns' route: grad_cols is formed in device
    memory first (``grad_out @ w_kc^T``). No path of the port calls it;
    chip_smoke.py times it as the yardstick of ``deform_conv_backward``,
    which forms grad_cols inside its kernel. On a CPU tensor the plain
    version runs; on a CUDA tensor the kernel launches or raises."""
    if x.device.type == 'cpu':
        return deform_im2col_backward_plain(x, offset, mask, grad_cols,
                                            kernel_size, stride, padding,
                                            dilation, needs=needs)
    if x.device.type != 'cuda':
        raise ValueError(f'deform_col2im: unsupported device {x.device}')
    _check(x, offset, mask)
    if x.dtype not in _COL2IM_ENTRY:
        raise TypeError(f'deform_col2im: x must be float32 or bfloat16, got '
                        f'{x.dtype}')
    if (offset.dtype != torch.float32 or mask.dtype != torch.float32
            or grad_cols.dtype != torch.float32):
        raise TypeError('deform_col2im: offset, mask and grad_cols must be '
                        'float32')
    if any(t.device != x.device for t in (offset, mask, grad_cols)):
        raise ValueError('deform_col2im: tensors lie on different devices')
    h, w, c = x.shape
    ho, wo, g, k, _ = offset.shape
    kh, kw = _pair(kernel_size)
    if kh * kw != k:
        raise ValueError(f'kernel_size {kh}x{kw} does not give {k} taps')
    if tuple(grad_cols.shape) != (ho * wo, k * c):
        raise ValueError(f'grad_cols {tuple(grad_cols.shape)} is not '
                         f'{(ho * wo, k * c)}')
    x = x.contiguous()
    offset = offset.contiguous()
    mask = mask.contiguous()
    grad_cols = grad_cols.contiguous()
    need_x, need_offset, need_mask = needs
    if not any(needs):
        return None, None, None
    # grad_x accumulates with f32 atomics; a bf16 x is cast once at the end
    grad_x = (torch.zeros((h, w, c), dtype=torch.float32, device=x.device)
              if need_x else None)
    grad_offset = torch.empty_like(offset) if need_offset else None
    grad_mask = torch.empty_like(mask) if need_mask else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        err = _kernel('deform_conv', _COL2IM_ENTRY[x.dtype],
                      _COL2IM_ARGTYPES)(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            grad_cols.data_ptr(), ptr(grad_offset), ptr(grad_mask),
            ptr(grad_x), h, w, c, ho, wo, g, kh, kw, *_pair(stride),
            *_pair(padding), *_pair(dilation),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'deform_col2im kernel launch failed: CUDA error '
                           f'{err}')
    deform_col2im.launches += 1
    if grad_x is not None:
        grad_x = grad_x.to(x.dtype)
    return grad_x, grad_offset, grad_mask


deform_col2im.launches = 0


def _backward_check(x, offset, mask, grad_out, w_kc):
    if x.dim() != 4 or offset.dim() != 6 or mask.dim() != 5:
        raise ValueError('deform_conv_backward takes a batch: x '
                         '(B, H, W, C), offset (B, Ho, Wo, G, K, 2), mask '
                         '(B, Ho, Wo, G, K)')
    b, _, _, c = x.shape
    _, ho, wo, g, k, _ = offset.shape
    if offset.shape[0] != b or offset.shape[:5] != mask.shape:
        raise ValueError(f'x {tuple(x.shape)}, offset {tuple(offset.shape)} '
                         f'and mask {tuple(mask.shape)} do not pair')
    if w_kc.dim() != 2 or w_kc.shape[0] != k * c:
        raise ValueError(f'w_kc {tuple(w_kc.shape)} is not (K*C, Co) with '
                         f'K*C = {k * c}')
    if tuple(grad_out.shape) != (b, ho, wo, w_kc.shape[1]):
        raise ValueError(f'grad_out {tuple(grad_out.shape)} is not '
                         f'{(b, ho, wo, w_kc.shape[1])}')
    if c % g:
        raise ValueError('channels must divide into the deformable groups')


def deform_conv_backward_plain(x, offset, mask, grad_out, w_kc,
                               kernel_size=(3, 3), stride=(1, 1),
                               padding=(1, 1), dilation=(1, 1),
                               needs=(True, True, True)):
    """Plain version of ``deform_conv_backward``: per image, the columns'
    gradient ``grad_out[i] @ w_kc^T`` by ``torch.matmul``, then
    ``deform_im2col_backward_plain``."""
    _backward_check(x, offset, mask, grad_out, w_kc)
    b, ho, wo, co = grad_out.shape
    outs = []
    for i in range(b):
        grad_cols = torch.matmul(grad_out[i].reshape(ho * wo, co).float(),
                                 w_kc.t())
        outs.append(deform_im2col_backward_plain(
            x[i], offset[i], mask[i], grad_cols, kernel_size, stride, padding,
            dilation, needs=needs))
    return tuple(None if outs[0][j] is None
                 else torch.stack([o[j] for o in outs]) for j in range(3))


def deform_conv_backward(x, offset, mask, grad_out, w_kc, kernel_size=(3, 3),
                         stride=(1, 1), padding=(1, 1), dilation=(1, 1),
                         needs=(True, True, True)):
    """The x, offset and mask gradients of the batched deformable conv
    ``out[b, p] = cols_b[p] @ w_kc`` from grad_out (B, Ho, Wo, Co) f32 and
    w_kc (K*C, Co) f32: (grad_x (B, H, W, C) in x's dtype, grad_offset
    (B, Ho, Wo, G, K, 2) f32, grad_mask (B, Ho, Wo, G, K) f32), each None
    unless ``needs`` asks for it. On a CUDA tensor one launch of the kernel
    covers the whole batch and forms the columns' gradient on the tensor
    cores; a wider shape is cut into pieces the kernel takes, each a launch
    of it (``split_backward``). On a CPU tensor the plain version runs."""
    if not any(needs):
        return None, None, None
    if x.device.type == 'cpu':
        return deform_conv_backward_plain(x, offset, mask, grad_out, w_kc,
                                          kernel_size, stride, padding,
                                          dilation, needs=needs)
    if x.device.type != 'cuda':
        raise ValueError(f'deform_conv_backward: unsupported device '
                         f'{x.device}')
    _backward_check(x, offset, mask, grad_out, w_kc)
    if x.dtype not in _BACKWARD_ENTRY:
        raise TypeError(f'deform_conv_backward: x must be float32 or '
                        f'bfloat16, got {x.dtype}')
    if any(t.dtype != torch.float32 for t in (offset, mask, grad_out, w_kc)):
        raise TypeError('deform_conv_backward: offset, mask, grad_out and '
                        'w_kc must be float32')
    if any(t.device != x.device for t in (offset, mask, grad_out, w_kc)):
        raise ValueError('deform_conv_backward: tensors lie on different '
                         'devices')
    k = offset.shape[4]
    kh, kw = _pair(kernel_size)
    if kh * kw != k:
        raise ValueError(f'kernel_size {kh}x{kw} does not give {k} taps')
    return split_backward(_backward_launch, x, offset, mask, grad_out, w_kc,
                          (kernel_size, stride, padding, dilation), needs)


def _backward_launch(x, offset, mask, grad_out, w_kc, kernel_size, stride,
                     padding, dilation, needs):
    """One launch of the backward kernel over the batch, at a shape it
    takes (checked by ``deform_conv_backward``, pieces cut by
    ``split_backward``)."""
    b, h, w, c = x.shape
    _, ho, wo, g, k, _ = offset.shape
    co = w_kc.shape[1]
    kh, kw = _pair(kernel_size)
    if c // g > BACKWARD_MAX_GROUP or co % 4 or co > BACKWARD_MAX_CO:
        raise ValueError(f'deform_conv_backward: the kernel takes groups of '
                         f'at most {BACKWARD_MAX_GROUP} channels and Co a '
                         f'multiple of 4 up to {BACKWARD_MAX_CO}, got '
                         f'{c // g} and {co}')
    need_x, need_offset, need_mask = needs
    x = x.contiguous()
    offset = offset.contiguous()
    mask = mask.contiguous()
    grad_out = grad_out.contiguous()
    w_kc = w_kc.contiguous()
    # grad_x accumulates with f32 atomics; a bf16 x is cast once at the end
    grad_x = (torch.zeros((b, h, w, c), dtype=torch.float32, device=x.device)
              if need_x else None)
    grad_offset = torch.empty_like(offset) if need_offset else None
    grad_mask = torch.empty_like(mask) if need_mask else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        err = _kernel('deform_conv_backward', _BACKWARD_ENTRY[x.dtype],
                      _BACKWARD_ARGTYPES)(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            grad_out.data_ptr(), w_kc.data_ptr(), ptr(grad_offset),
            ptr(grad_mask), ptr(grad_x), b, h, w, c, ho, wo, g, kh, kw,
            *_pair(stride), *_pair(padding), *_pair(dilation), co,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'deform_conv_backward kernel launch failed: CUDA '
                           f'error {err}')
    deform_conv_backward.launches += 1
    if grad_x is not None:
        grad_x = grad_x.to(x.dtype)
    return grad_x, grad_offset, grad_mask


deform_conv_backward.launches = 0


def _subgroups(cg, widest):
    """The fewest sub-groups, of equal width at most ``widest``, that a
    group of ``cg`` channels splits into."""
    return next(s for s in range(1, cg + 1) if cg % s == 0
                and cg // s <= widest)


def split_backward(launch, x, offset, mask, grad_out, w_kc, conv,
                   needs=(True, True, True)):
    """``launch(x, offset, mask, grad_out, w_kc, *conv, needs=needs)`` --
    the backward of one shape the kernel takes -- over as many pieces as a
    wider shape needs, their gradients summed back:

    - a group of more than ``BACKWARD_MAX_GROUP`` channels is split into
      the fewest equal sub-groups of at most that many channels (the
      channel order is unchanged, so x, w_kc and grad_x keep their
      layout); each
      sub-group samples at its group's offsets and mask, and the
      sub-groups' offset and mask gradients, sums over their channels, add
      up to the group's;
    - Co above ``BACKWARD_MAX_CO`` or off a multiple of 4 is cut into
      chunks of at most that many columns of w_kc and grad_out, each
      padded with zero columns to a multiple of 4; every gradient is
      linear in grad_out, so the chunks' gradients add up to the whole's.

    Exact up to the order of the f32 sums (grad_x is summed in f32 and
    rounded to x's dtype once). A shape the kernel takes is one call of
    ``launch``."""
    g = offset.shape[3]
    cg = x.shape[-1] // g
    s = _subgroups(cg, BACKWARD_MAX_GROUP)
    if s > 1:
        offset = offset.repeat_interleave(s, dim=3)
        mask = mask.repeat_interleave(s, dim=3)
    co = w_kc.shape[1]
    step = BACKWARD_MAX_CO
    if co <= step and co % 4 == 0:
        pieces = [(w_kc, grad_out)]
    else:
        pieces = []
        for a in range(0, co, step):
            pad = (-min(step, co - a)) % 4
            pieces.append((F.pad(w_kc[:, a:a + step], (0, pad)),
                           F.pad(grad_out[..., a:a + step], (0, pad))))
    total = [None, None, None]
    for w_piece, g_piece in pieces:
        grads = launch(x, offset, mask, g_piece.contiguous(),
                       w_piece.contiguous(), *conv, needs=needs)
        total = [t if t is None else (t.float() if acc is None
                                      else acc + t.float())
                 for acc, t in zip(total, grads)]
    grad_x, grad_offset, grad_mask = total
    if grad_x is not None:
        grad_x = grad_x.to(x.dtype)
    if s > 1:
        if grad_offset is not None:
            grad_offset = grad_offset.unflatten(3, (g, s)).sum(4)
        if grad_mask is not None:
            grad_mask = grad_mask.unflatten(3, (g, s)).sum(4)
    return grad_x, grad_offset, grad_mask


def _mdc_forward(x, offset, mask, w_kc, bias, conv, kept=None,
                 im2col=deform_im2col):
    """B3's columns per image (``im2col``) times w_kc (``torch.matmul``),
    plus the bias: (B, Ho, Wo, Co) f32. Each image's f32 columns are
    appended to ``kept`` when it is a list, and otherwise freed before the
    next image's."""
    b = x.shape[0]
    _, ho, wo, _, _, _ = offset.shape
    outs = []
    for i in range(b):
        col = im2col(x[i], offset[i], mask[i], *conv).float()
        outs.append(torch.matmul(col, w_kc))
        if kept is not None:
            kept.append(col)
        del col
    out = torch.stack(outs).reshape(b, ho, wo, w_kc.shape[1])
    if bias is not None:
        out = out + bias
    return out


def fused_applicable(x, offset, kernel_size=(3, 3), stride=(1, 1),
                     dilation=(1, 1)):
    """Whether ``deform_conv_fused`` takes this shape: 3x3 taps, stride 1,
    dilation 1 (any padding, a band's negative top padding included), x
    float32 or bfloat16 with a group width of whole 16-byte vectors (4 f32
    or 8 bf16 channels). Decided from shapes alone, before any launch."""
    if x.dtype not in _FUSED_ENTRY:
        return False
    if (list(_pair(kernel_size)) != [3, 3] or list(_pair(stride)) != [1, 1]
            or list(_pair(dilation)) != [1, 1]):
        return False
    c, g = x.shape[-1], offset.shape[3]
    vector = 16 // x.element_size()
    return c % g == 0 and (c // g) % vector == 0


def deform_conv_fused_plain(x, offset, mask, w_kc, bias=None,
                            kernel_size=(3, 3), stride=(1, 1),
                            padding=(1, 1), dilation=(1, 1)):
    """Plain version of ``deform_conv_fused``: the columns path's
    arithmetic with ``deform_im2col_plain`` for B3 (the columns per image
    in x's dtype, taken to f32, times w_kc by ``torch.matmul``, stacked,
    plus the bias)."""
    return _mdc_forward(x, offset, mask, w_kc, bias,
                        (kernel_size, stride, padding, dilation),
                        im2col=deform_im2col_plain)


def deform_conv_fused(x, offset, mask, w_kc, bias=None, kernel_size=(3, 3),
                      stride=(1, 1), padding=(1, 1), dilation=(1, 1)):
    """The forward of the batched deformable conv without a graph:
    ``out[b, p] = cols_b[p] @ w_kc + bias``, (B, Ho, Wo, Co) f32.

    Args:
        x: (B, H, W, C) float32 or bfloat16, NHWC.
        offset: (B, Ho, Wo, G, K, 2) float32; mask: (B, Ho, Wo, G, K)
            float32.
        w_kc: (K*C, Co) float32, rounded to x's dtype where x is bf16.
        bias: (Co,) float32 or None.

    Calls the registered operator ``torch.ops.c2matching.deform_conv_fused``:
    on a CPU tensor the plain version, on a CUDA tensor one launch of the
    fused kernel over the batch (or a refusal, for a shape outside
    ``fused_applicable``); ``deform_conv_fused.launches`` counts them.
    """
    _device(x, 'deform_conv_fused')
    return torch.ops.c2matching.deform_conv_fused(
        x, offset, mask, w_kc, bias, _pair(kernel_size), _pair(stride),
        _pair(padding), _pair(dilation))


deform_conv_fused.launches = 0


@torch.library.custom_op('c2matching::deform_conv_fused', mutates_args=())
def _deform_conv_fused_op(x: torch.Tensor, offset: torch.Tensor,
                          mask: torch.Tensor, w_kc: torch.Tensor,
                          bias: Optional[torch.Tensor],
                          kernel_size: List[int], stride: List[int],
                          padding: List[int],
                          dilation: List[int]) -> torch.Tensor:
    """The operator behind ``deform_conv_fused``."""
    if _device(x, 'deform_conv_fused') == 'cpu':
        _fused_check(x, offset, mask, w_kc, bias, kernel_size, stride,
                     dilation, kernel=False)
        return deform_conv_fused_plain(x, offset, mask, w_kc, bias,
                                       kernel_size, stride, padding,
                                       dilation)
    _fused_check(x, offset, mask, w_kc, bias, kernel_size, stride, dilation)
    b, h, w, c = x.shape
    _, ho, wo, g, _, _ = offset.shape
    co = w_kc.shape[1]
    # the kernel reads x in 16-byte vectors and the offsets in pairs: a view
    # that starts off those boundaries is copied to storage of its own
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    offset = offset.contiguous()
    if offset.data_ptr() % 8:
        offset = offset.clone()
    mask = mask.contiguous()
    w_kc = w_kc.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((b, ho, wo, co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel('deform_conv_fused', _FUSED_ENTRY[x.dtype],
                      _FUSED_ARGTYPES)(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            w_kc.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), b, h, w, c, ho, wo, g, *kernel_size, *stride,
            *padding, *dilation, co, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'deform_conv_fused kernel launch failed: CUDA '
                           f'error {err}')
    deform_conv_fused.launches += 1
    return out


@_deform_conv_fused_op.register_fake
def _(x, offset, mask, w_kc, bias, kernel_size, stride, padding, dilation):
    _fused_check(x, offset, mask, w_kc, bias, kernel_size, stride, dilation,
                 kernel=x.device.type == 'cuda')
    b, ho, wo = offset.shape[:3]
    return x.new_empty((b, ho, wo, w_kc.shape[1]), dtype=torch.float32)


def _fused_check(x, offset, mask, w_kc, bias, kernel_size, stride, dilation,
                 kernel=True):
    """Refuse what the operator does not take (``kernel``: what the kernel
    does not take too)."""
    if x.dim() != 4 or offset.dim() != 6 or mask.dim() != 5:
        raise ValueError('deform_conv_fused takes a batch: x (B, H, W, C), '
                         'offset (B, Ho, Wo, G, K, 2), mask (B, Ho, Wo, G, '
                         'K)')
    b, _, _, c = x.shape
    _, _, _, g, k, _ = offset.shape
    if (offset.shape[0] != b or offset.shape[:5] != mask.shape
            or offset.shape[-1] != 2):
        raise ValueError(f'x {tuple(x.shape)}, offset {tuple(offset.shape)} '
                         f'and mask {tuple(mask.shape)} do not pair')
    if w_kc.dim() != 2 or w_kc.shape[0] != k * c:
        raise ValueError(f'w_kc {tuple(w_kc.shape)} is not (K*C, Co) with '
                         f'K*C = {k * c}')
    if bias is not None and tuple(bias.shape) != (w_kc.shape[1],):
        raise ValueError(f'bias {tuple(bias.shape)} is not '
                         f'({w_kc.shape[1]},)')
    if c % g:
        raise ValueError('channels must divide into the deformable groups')
    kh, kw = kernel_size
    if kh * kw != k:
        raise ValueError(f'kernel_size {kh}x{kw} does not give {k} taps')
    if not kernel:
        return
    if x.dtype not in _FUSED_ENTRY:
        raise TypeError(f'deform_conv_fused: x must be float32 or bfloat16, '
                        f'got {x.dtype}')
    if any(t is not None and t.dtype != torch.float32
           for t in (offset, mask, w_kc, bias)):
        raise TypeError('deform_conv_fused: offset, mask, w_kc and bias '
                        'must be float32')
    if any(t is not None and t.device != x.device
           for t in (offset, mask, w_kc, bias)):
        raise ValueError('deform_conv_fused: tensors lie on different '
                         'devices')
    if not fused_applicable(x, offset, kernel_size, stride, dilation):
        raise ValueError(f'deform_conv_fused: the kernel takes 3x3 taps at '
                         f'stride 1 and dilation 1 with groups of whole '
                         f'16-byte vectors, got kernel {list(kernel_size)}, '
                         f'stride {list(stride)}, dilation {list(dilation)}, '
                         f'{c // g} channels a group of {x.dtype}')


class _ModulatedDeformConv(torch.autograd.Function):
    """The deformable conv of a batch, differentiable in x, offset, mask,
    w_kc and bias. Forward: B3's columns per image (bf16 columns are
    rounded in x's dtype, as the forward stores them, then taken to f32)
    times w_kc by ``torch.matmul``, plus the bias, one image at a time. An
    image's f32 columns are kept for the weight's gradient only when w_kc
    needs one; otherwise they take one image's memory. Backward: the x,
    offset and mask gradients of the whole batch in one
    ``deform_conv_backward``, grad_x only when autograd asks for it (never
    on the training path, whose sampled feature comes from the frozen
    VGG19); w_kc's gradient ``sum_i cols_i^T @ grad_out_i`` and the bias's
    by torch."""

    @staticmethod
    def forward(ctx, x, offset, mask, w_kc, bias, conv):
        kept = [] if ctx.needs_input_grad[3] else None
        out = _mdc_forward(x, offset, mask, w_kc, bias, conv, kept)
        ctx.save_for_backward(x, offset, mask, w_kc, *(kept or ()))
        ctx.conv = conv
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, offset, mask, w_kc, *cols = ctx.saved_tensors
        need_x, need_offset, need_mask, need_w, need_bias = \
            ctx.needs_input_grad[:5]
        grad_out = grad_out.float().contiguous()
        grad_x, grad_offset, grad_mask = deform_conv_backward(
            x, offset, mask, grad_out, w_kc, *ctx.conv,
            needs=(need_x, need_offset, need_mask))
        grad_w = grad_bias = None
        if need_w:
            rows = grad_out.reshape(len(cols), -1, grad_out.shape[-1])
            grad_w = sum(torch.matmul(col.t(), rows[i])
                         for i, col in enumerate(cols))
        if need_bias:
            grad_bias = grad_out.sum(dim=(0, 1, 2))
        return grad_x, grad_offset, grad_mask, grad_w, grad_bias, None


def modulated_deform_conv(x, offset, mask, weight, bias=None,
                          kernel_size=(3, 3), stride=(1, 1), padding=(1, 1),
                          dilation=(1, 1)):
    """Batched modulated deformable convolution (DCNv2).

    Args:
        x:      (B, H, W, C) the feature to sample (f32 or bf16).
        offset: (B, Ho, Wo, G, K, 2) sampling offsets, last dim (dy, dx).
        mask:   (B, Ho, Wo, G, K) modulation (already sigmoid-ed).
        weight: (K, C, Cout) taps in row-major (ky, kx) order.
        bias:   (Cout,) or None.

    Returns:
        (B, Ho, Wo, Cout) float32. With grad enabled, differentiable in
        every argument through ``_ModulatedDeformConv``, whose forward
        forms the columns one image at a time: one launch of B3's backward
        kernel gives the x, offset and mask gradients of the whole batch.
        Under ``no_grad`` / ``inference_mode`` the forward runs alone: one
        ``deform_conv_fused`` over the batch where ``fused_applicable``
        holds, else the columns.
    """
    _, _, _, c = x.shape
    _, _, _, _, k, _ = offset.shape
    co = weight.shape[-1]
    # bf16 columns meet bf16-rounded weights; products accumulate in f32
    w_kc = weight.reshape(k * c, co).to(x.dtype).float()
    offset, mask = offset.float(), mask.float()
    bias = None if bias is None else bias.float()
    conv = (kernel_size, stride, padding, dilation)
    if not torch.is_grad_enabled():
        # no graph to record: the forward alone, which torch.export traces
        # as the operators it calls
        if fused_applicable(x, offset, kernel_size, stride, dilation):
            return deform_conv_fused(x, offset, mask, w_kc, bias, *conv)
        return _mdc_forward(x, offset, mask, w_kc, bias, conv)
    return _ModulatedDeformConv.apply(x, offset, mask, w_kc, bias, conv)


def deform_conv(x, offset, weight, bias=None, kernel_size=(3, 3),
                stride=(1, 1), padding=(1, 1), dilation=(1, 1)):
    """Unmodulated deformable convolution (DCNv1): DCNv2 with mask 1."""
    mask = torch.ones(offset.shape[:-1], dtype=torch.float32,
                      device=offset.device)
    return modulated_deform_conv(x, offset, mask, weight, bias, kernel_size,
                                 stride, padding, dilation)


def deform_psroi_pooling(x, rois, offsets, output_dim, group_size,
                         pooled_size, spatial_scale=1.0, trans_std=0.0,
                         no_trans=False, sample_per_part=4, part_size=None):
    """Deformable position-sensitive ROI pooling of one image, as DCNv2's
    ``dcn_v2_psroi_pooling`` computes it: rounded ROI corners
    ([round(x1) * ss - 0.5, (round(x2) + 1) * ss - 0.5)), bins at least 0.1
    wide, a ``sample_per_part`` x ``sample_per_part`` grid of samples a bin
    averaged over the samples inside [-0.5, W - 0.5] (each clamped to
    [0, W - 1] before its floor/ceil bilinear read), and learned offsets
    per part and class (part floor(p / ps * part), class
    ctop // (output_dim / num_classes)). Plain torch ops on x's device; no
    model calls it.

    Args:
        x: (H, W, C) position-sensitive score maps, C = output_dim *
            group_size^2, channel c = (ctop * gs + gh) * gs + gw.
        rois: (N, 5) [batch_idx, x1, y1, x2, y2] in input coordinates
            (batch_idx is not read).
        offsets: (N, num_classes, 2, part_size, part_size) normalised part
            offsets, (x, y) channel order, or None.
    Returns:
        (N, pooled_size, pooled_size, output_dim)
    """
    h, w, _ = x.shape
    dev = x.device
    ps, gs, spp = pooled_size, group_size, sample_per_part
    part = pooled_size if part_size is None else part_size
    fps = torch.arange(ps, dtype=torch.float32, device=dev)
    g_of = torch.floor(fps * gs / ps).long().clamp(0, gs - 1)
    part_of = torch.floor(fps / ps * part).long()
    xg = x.reshape(h, w, output_dim, gs, gs)
    rois = rois.float()
    n = rois.shape[0]
    r = torch.round(rois[:, 1:5])
    roi_start_w = (r[:, 0] * spatial_scale - 0.5)[:, None, None, None]
    roi_start_h = (r[:, 1] * spatial_scale - 0.5)[:, None, None, None]
    roi_w = ((r[:, 2] + 1.) * spatial_scale - 0.5
             - roi_start_w[:, 0, 0, 0]).clamp_min(0.1)[:, None, None, None]
    roi_h = ((r[:, 3] + 1.) * spatial_scale - 0.5
             - roi_start_h[:, 0, 0, 0]).clamp_min(0.1)[:, None, None, None]
    bin_w, bin_h = roi_w / ps, roi_h / ps
    if no_trans or offsets is None:
        tx = ty = torch.zeros(n, output_dim, ps, ps, device=dev)
    else:
        num_classes = offsets.shape[1]
        class_of = (torch.arange(output_dim, device=dev)
                    // max(output_dim // num_classes, 1))
        off = offsets.float()[:, :, :, part_of][:, :, :, :, part_of]
        tx = off[:, :, 0][:, class_of] * trans_std       # (N, od, ps, ps)
        ty = off[:, :, 1][:, class_of] * trans_std
    # the samples' coordinates: (N, od, ph, pw, ih, iw)
    wstart = fps[None, None, None, :] * bin_w + roi_start_w + tx * roi_w
    hstart = fps[None, None, :, None] * bin_h + roi_start_h + ty * roi_h
    steps = torch.arange(spp, dtype=torch.float32, device=dev)
    sw = (wstart[..., None, None]
          + steps[None, :] * (bin_w / spp)[..., None, None])
    sh = (hstart[..., None, None]
          + steps[:, None] * (bin_h / spp)[..., None, None])
    valid = (sw >= -0.5) & (sw <= w - 0.5) & (sh >= -0.5) & (sh <= h - 0.5)
    swc = sw.clamp(0., w - 1.)
    shc = sh.clamp(0., h - 1.)
    x1i, x2i = torch.floor(swc).long(), torch.ceil(swc).long()
    y1i, y2i = torch.floor(shc).long(), torch.ceil(shc).long()
    dx, dy = swc - x1i, shc - y1i
    od_i = torch.arange(output_dim, device=dev)[:, None, None, None, None]
    gh_i = g_of[None, :, None, None, None]
    gw_i = g_of[None, None, :, None, None]

    def at(yy, xx):
        return xg[yy, xx, od_i, gh_i, gw_i]

    val = ((1 - dx) * (1 - dy) * at(y1i, x1i) + (1 - dx) * dy * at(y2i, x1i)
           + dx * (1 - dy) * at(y1i, x2i) + dx * dy * at(y2i, x2i))
    vf = valid.to(val.dtype)
    cnt = vf.sum(dim=(-1, -2))
    total = (val * vf).sum(dim=(-1, -2))
    pooled = torch.where(cnt > 0, total / cnt.clamp_min(1.), 0.)
    return pooled.permute(0, 2, 3, 1)


def torch_weight_to_kco(w_oihw):
    """A torch DCN weight (Cout, Cin, kh, kw) in this op's (K, Cin, Cout)
    layout, taps in row-major (ky, kx) order."""
    cout, cin, kh, kw = w_oihw.shape
    return w_oihw.permute(2, 3, 1, 0).reshape(kh * kw, cin, cout)
