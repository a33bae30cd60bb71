"""Tent-weighted window contraction (kernel B2) of the windowed deformable
conv, forward only.

Counterpart of ``c2matching_tpu/ops/pallas/dcn_window_kernel.py``
(``window_contract_pallas``). The CUDA source is ``csrc/dcn_window.cu``. On
a CPU tensor ``window_contract`` takes its plain version,
``window_contract_plain`` (the dense einsums of the JAX package's
``_tents`` and ``_window_contract_xla``); on a CUDA tensor it launches the
kernel or raises.

The Pallas kernel's helpers ``_expand_field``, ``_fold_weight`` and
``_fold_r`` are not carried over: they pre-expand the (G, K, P) fields to
128-lane slices and fold the weight to match, because Mosaic cannot slice
lanes below 128. The CUDA kernel reads the (G, K, P) fields and the
(K, C, Co) weight as they are. ``qt``, a TPU tile size, is dropped too.
"""
import ctypes

import torch

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
_ENTRY = {torch.float32: 'c2m_window_contract_f32',
          torch.bfloat16: 'c2m_window_contract_bf16'}

# the kernel's tiling (csrc/dcn_window.cu): output pixels per thread block,
# weight rows staged per step, and the shared memory a block may opt into
_PIX = 64
_CCH = 32
_MAX_SMEM = 232448
_MAX_CO = 256


def _kernel(dtype):
    fn = getattr(_build.load('dcn_window'), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _smem_bytes(c, g, co):
    """Dynamic shared memory of one thread block of the kernel."""
    cop = -(-co // 64) * 64
    return _PIX * g * (16 + 8) + _PIX * (c + 4) * 4 + _CCH * cop * 4


def _tents(ry, rx, mm, blk, win, nby, nbx):
    """Tent weights in block-major layout: ty, txm (NB, Q=blk^2, G, K, win)
    f32, with the modulation folded into txm."""
    g, k, _ = ry.shape

    def blockify(t):                                      # -> (NB, Q, G, K)
        t = t.reshape(g, k, nby, blk, nbx, blk).permute(2, 4, 3, 5, 0, 1)
        return t.reshape(nby * nbx, blk * blk, g, k)

    iw = torch.arange(win, dtype=torch.float32, device=ry.device)
    ty = (1. - (blockify(ry)[..., None] - iw).abs()).clamp_min(0.)
    tx = (1. - (blockify(rx)[..., None] - iw).abs()).clamp_min(0.)
    return ty, tx * blockify(mm)[..., None]


def window_contract_plain(rows, ry, rx, mm, weight, blk, win, nby, nbx):
    """Plain version of ``window_contract``: dense tents over every window
    cell, two einsums, then the weight. Same arguments and result."""
    ty, txm = _tents(ry, rx, mm, blk, win, nby, nbx)
    nb, k = rows.shape[:2]
    co = weight.shape[-1]
    c = rows.shape[-1] // win
    g = ty.shape[2]
    rows5 = rows.float().reshape(nb, k, win, win, g, c // g)
    t1 = torch.einsum('nkyxgc,nqgkx->nqkgyc', rows5, txm)
    cols = torch.einsum('nqkgyc,nqgky->nqkgc', t1, ty)
    cols = cols.reshape(nb, blk * blk, k * c)
    out = torch.matmul(cols, weight.float().reshape(k * c, co))
    out = out.reshape(nby, nbx, blk, blk, co).permute(0, 2, 1, 3, 4)
    return out.reshape(nby * blk, nbx * blk, co)


def window_contract(rows, ry, rx, mm, weight, blk, win, nby, nbx):
    """Tent-weighted window contraction, then the conv weight.

    ``cols[p, k*C + c] = sum_wy sum_wx tent(ry - wy) tent(rx - wx) mm
    rows[b(p), k, wy, wx*C + c]`` with ``tent(d) = max(0, 1 - |d|)`` and
    the group of channel c, then ``out[p] = cols[p] @ weight``.

    Args:
        rows: (NB, K, win, win*C) windows, float32 or bfloat16; NB = nby*nbx
            output blocks of blk x blk pixels, block-major.
        ry, rx: (G, K, P) float32 coords relative to each block's window
            origin; P = Ho*Wo pixels, row-major. Any value: window cells
            that do not exist contribute zero.
        mm: (G, K, P) float32 modulation times validity.
        weight: (K, C, Co); taken in float32 whatever the rows' dtype.
    Returns:
        (Ho, Wo, Co) float32, Ho = nby*blk, Wo = nbx*blk.
    """
    if rows.device.type == 'cpu':
        return window_contract_plain(rows, ry, rx, mm, weight, blk, win, nby,
                                     nbx)
    if rows.device.type != 'cuda':
        raise ValueError(f'window_contract: unsupported device {rows.device}')
    if rows.dtype not in _ENTRY:
        raise TypeError(f'window_contract: rows must be float32 or bfloat16, '
                        f'got {rows.dtype}')
    fields = (ry, rx, mm)
    if any(t.dtype != torch.float32 for t in fields):
        raise TypeError('window_contract: ry, rx and mm must be float32')
    if any(t.device != rows.device for t in (*fields, weight)):
        raise ValueError('window_contract: tensors lie on different devices')
    nb, k, wy, winc = rows.shape
    g = ry.shape[0]
    c = winc // win
    kw, cw, co = weight.shape
    if (wy != win or winc != win * c or nb != nby * nbx or nb == 0
            or any(t.shape != (g, k, nb * blk * blk) for t in fields)
            or (kw, cw) != (k, c) or c % g):
        raise ValueError(
            f'window_contract: rows {tuple(rows.shape)}, fields '
            f'{tuple(ry.shape)}, weight {tuple(weight.shape)} do not pair '
            f'for blk {blk}, win {win}, {nby}x{nbx} blocks')
    if c % 4 or not 0 < co <= _MAX_CO:
        raise ValueError(f'window_contract: C = {c} must be a multiple of 4 '
                         f'and Co = {co} in 1..{_MAX_CO}')
    if _smem_bytes(c, g, co) > _MAX_SMEM:
        raise ValueError(f'window_contract: C = {c}, G = {g}, Co = {co} need '
                         f'{_smem_bytes(c, g, co)} bytes of shared memory '
                         f'per block, more than {_MAX_SMEM}')
    rows = rows.contiguous()
    ry, rx, mm = (t.contiguous() for t in fields)
    w32 = weight.float().contiguous()
    out = torch.empty((nby * blk, nbx * blk, co), dtype=torch.float32,
                      device=rows.device)
    with torch.cuda.device(rows.device):
        err = _kernel(rows.dtype)(
            rows.data_ptr(), ry.data_ptr(), rx.data_ptr(), mm.data_ptr(),
            w32.data_ptr(), out.data_ptr(), nb, k, blk, win, c, g, co, nbx,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'window_contract kernel launch failed: CUDA error '
                           f'{err}')
    window_contract.launches += 1
    return out


window_contract.launches = 0
