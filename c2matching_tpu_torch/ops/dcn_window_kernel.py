"""Tent-weighted window contraction (kernel B2) of the windowed deformable
conv, forward only.

Counterpart of ``c2matching_tpu/ops/pallas/dcn_window_kernel.py``
(``window_contract_pallas``). The CUDA source is ``csrc/dcn_window.cu``.
One kernel serves two entry points, which differ only in where a window
cell lives:

- ``window_conv`` (image mode, what the windowed op runs) reads the image
  at each window's origin, so no window buffer exists;
- ``window_contract`` (rows mode, the Pallas kernel's own signature) reads
  windows gathered by ``_window_gather``.

On the same inputs the two give the same bits. On a CPU tensor each takes
its plain version (the dense einsums of the JAX package's ``_tents`` and
``_window_contract_xla``, after the gather in image mode); on a CUDA
tensor it launches the kernel or raises. A launch in either mode counts
on ``window_contract.launches``.

The Pallas kernel's helpers ``_expand_field``, ``_fold_weight`` and
``_fold_r`` are not carried over: they pre-expand the (G, K, P) fields to
128-lane slices and fold the weight to match, because Mosaic cannot slice
lanes below 128. The CUDA kernel reads the (G, K, P) fields and the
(K, C, Co) weight as they are. ``qt``, a TPU tile size, is dropped too.
"""
import ctypes

import torch
import torch.nn.functional as F

from . import _build

MARGIN = 2  # zero-pad ring; window origin O = floor(anchor) - 1 >= -2

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
             + [ctypes.c_void_p])
_ENTRY = {torch.float32: 'c2m_window_contract_f32',
          torch.bfloat16: 'c2m_window_contract_bf16'}

def _kernel(dtype):
    fn = getattr(_build.load('dcn_window'), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _window_gather(x, origins, win):
    """(NB, K, win, win*C) window rows in x's dtype: one indexed copy from
    a strided view of the zero-padded x, whose element [Y, X, i, j*C + c]
    is xpad[Y + i, X + j, c]."""
    h, w, c = x.shape
    m = MARGIN
    xpad = F.pad(x, (0, 0, m, m, m, m)).contiguous()
    hp, wp = h + 2 * m, w + 2 * m
    windows = xpad.as_strided((hp - win + 1, wp - win + 1, win, win * c),
                              (wp * c, c, wp * c, 1))
    oy = origins[..., 0].long() + m                       # (NB, K)
    ox = origins[..., 1].long() + m
    return windows[oy, ox]


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


def window_conv_plain(x, origins, ry, rx, mm, weight, blk, win, nby, nbx):
    """Plain version of ``window_conv``: the gather, then the plain
    contraction. Same arguments and result."""
    return window_contract_plain(_window_gather(x, origins, win), ry, rx, mm,
                                 weight, blk, win, nby, nbx)


def _launch(name, src, origins, ry, rx, mm, weight, blk, win, nby, nbx, c,
            image_hw):
    """Checks what both modes share and launches the kernel on ``src``
    (the image when ``origins`` is given, else the windows)."""
    if src.dtype not in _ENTRY:
        raise TypeError(f'{name}: the image or windows must be float32 or '
                        f'bfloat16, got {src.dtype}')
    fields = (ry, rx, mm)
    if any(t.dtype != torch.float32 for t in fields):
        raise TypeError(f'{name}: ry, rx and mm must be float32')
    others = (*fields, weight) + (() if origins is None else (origins,))
    if any(t.device != src.device for t in others):
        raise ValueError(f'{name}: tensors lie on different devices')
    g, k = ry.shape[:2]
    kw, cw, co = weight.shape
    nb = nby * nbx
    if (nb == 0 or any(t.shape != (g, k, nb * blk * blk) for t in fields)
            or (kw, cw) != (k, c) or c % g or co < 1):
        raise ValueError(
            f'{name}: fields {tuple(ry.shape)} and weight '
            f'{tuple(weight.shape)} do not pair with C = {c} for blk {blk}, '
            f'win {win}, {nby}x{nbx} blocks')
    src = src.contiguous()
    ry, rx, mm = (t.contiguous() for t in fields)
    # 16-byte aligned weight rows for the kernel's cp.async copies
    w32 = weight.float().contiguous()
    ldw = -(-co // 4) * 4
    if ldw != co or w32.data_ptr() % 16:
        padded = w32.new_zeros((k, c, ldw))
        padded[..., :co] = w32
        w32 = padded
    out = torch.empty((nby * blk, nbx * blk, co), dtype=torch.float32,
                      device=src.device)
    h, w = image_hw
    with torch.cuda.device(src.device):
        err = _kernel(src.dtype)(
            src.data_ptr(), 0 if origins is None else origins.data_ptr(),
            ry.data_ptr(), rx.data_ptr(), mm.data_ptr(), w32.data_ptr(),
            out.data_ptr(), nb, k, blk, win, c, g, co, ldw, nbx, h, w,
            torch.cuda.current_stream().cuda_stream)
    if err:
        # the launcher refuses what its tiles cannot take (error 1: shared
        # memory past a block's limit, an image or windows not aligned to
        # its 4-channel loads, 32-bit cell indices overflowing) before any
        # launch
        raise RuntimeError(f'{name}: kernel launch failed with CUDA error '
                           f'{err} (C = {c}, G = {g}, Co = {co}, '
                           f'{src.dtype}, {tuple(src.shape)})')
    window_contract.launches += 1
    return out


def _check_device(name, t):
    if t.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name}: unsupported device {t.device}')
    return t.device.type == 'cpu'


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
    if _check_device('window_contract', rows):
        return window_contract_plain(rows, ry, rx, mm, weight, blk, win, nby,
                                     nbx)
    nb, k, wy, winc = rows.shape
    if wy != win or winc % win or nb != nby * nbx:
        raise ValueError(f'window_contract: rows {tuple(rows.shape)} do not '
                         f'pair with win {win}, {nby}x{nbx} blocks')
    return _launch('window_contract', rows, None, ry, rx, mm, weight, blk,
                   win, nby, nbx, winc // win, (0, 0))


def window_conv(x, origins, ry, rx, mm, weight, blk, win, nby, nbx):
    """What ``window_contract(_window_gather(x, origins, win), ry, rx, mm,
    weight, blk, win, nby, nbx)`` returns, read from the image itself: a
    window cell (wy, wx) of (block b, tap k) is ``x[oy + wy, ox + wx]``
    with (oy, ox) = origins[b, k], and zero outside the image.

    Args:
        x: (H, W, C) one image, float32 or bfloat16.
        origins: (NB, K, 2) int32 window origins (y, x) from
            ``_window_prep``, clamped to [-MARGIN, H + MARGIN - win] (and
            the same for x), so every window lies in the zero-padded image.
        ry, rx, mm, weight, blk, win, nby, nbx: as for ``window_contract``.
    Returns:
        (nby*blk, nbx*blk, Co) float32.
    """
    if _check_device('window_conv', x):
        return window_conv_plain(x, origins, ry, rx, mm, weight, blk, win,
                                 nby, nbx)
    h, w, c = x.shape
    if (origins.dtype != torch.int32
            or origins.shape != (nby * nbx, ry.shape[1], 2)):
        raise ValueError(f'window_conv: origins {tuple(origins.shape)} '
                         f'{origins.dtype} must be int32 of shape '
                         f'({nby * nbx}, {ry.shape[1]}, 2)')
    return _launch('window_conv', x, origins.contiguous(), ry, rx, mm, weight,
                   blk, win, nby, nbx, c, (h, w))


window_contract.launches = 0
