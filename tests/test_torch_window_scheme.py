"""Kernel B2's image mode (``window_conv``, csrc/dcn_window.cu) on the CPU:
its plain version and an emulation of the kernel's arithmetic, against the
JAX package's windowed contraction.

The JAX package gathers the windows and contracts them in its Pallas
kernel (``_mdc_window_single(..., use_pallas=True)``, run in interpret mode
here as tests/test_torch_dcn_window.py runs it). The port's image mode
reads the image at each window's origin instead; its plain version is the
gather followed by the dense contraction. The emulation does what the CUDA
kernel does: per (pixel, tap, group) at most the 2 x 2 cells with a
non-zero tent, tents zeroed outside the image (image mode) or zero cells
read from the gathered windows (rows mode), then the weight as 3xTF32
split by bit operations, each 8-channel step's three products added to
the running sum with one rounded f32 add.
"""
from importlib import import_module

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from c2matching_tpu.ops.pallas.dcn_window_kernel import window_contract_pallas
from c2matching_tpu_torch.ops import (window_contract, window_conv,
                                      window_conv_plain)
from test_torch_dcn_window import _case, _t
from test_torch_match_f32_scheme import split_tf32, tf32_rna

jax_win = import_module('c2matching_tpu.ops.dcn_window')
win_mod = import_module('c2matching_tpu_torch.ops.dcn_window')

# f32 sums of the same products in another order (outputs of O(1)), as in
# tests/test_torch_dcn_window.py
CONTRACT_TOL = 1e-5
CASES = ['structured', 'block2', 'border', 'huge']


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(name, dtype='float32'):
    """Image 0 of a case of tests/test_torch_dcn_window.py, its JAX prep
    (origins, ry, rx, mm) and a weight at the DCN's init scale, as numpy
    arrays; x cast to ``dtype`` and back, so both sides see the same
    values. Returns (x, origins, ry, rx, mm, weight, blk, win, nby, nbx)."""
    x, off, mask, _, _, blk, win, _ = _case(name)
    h, w, c = x.shape[1:]
    prep = jax_win._window_prep(jnp.asarray(x[0]), jnp.asarray(off[0]),
                                jnp.asarray(mask[0]), blk, win)
    origins, ry, rx, mm = (np.array(a) for a in prep[:4])
    weight = (np.random.RandomState(h + c).randn(9, c, 6)
              / np.sqrt(9 * c)).astype(np.float32)
    xd = np.array(jnp.asarray(x[0]).astype(dtype).astype(jnp.float32))
    return xd, origins, ry, rx, mm, weight, blk, win, h // blk, w // blk


def _jax_pallas(x, origins, ry, rx, mm, weight, blk, win, dtype):
    return np.asarray(jax_win._mdc_window_single(
        jnp.asarray(x).astype(dtype), *map(jnp.asarray,
                                           (origins, ry, rx, mm, weight)),
        blk, win, use_pallas=True))


# ------------------------------------------------------- the plain version
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', CASES)
def test_window_conv_plain_matches_jax_pallas(name, dtype):
    """Origins clamp at both ends (border, huge) and cells fall in the
    zero ring; bf16 images as the JAX side gathers them, in bf16."""
    x, origins, ry, rx, mm, weight, blk, win, nby, nbx = _inputs(name, dtype)
    want = _jax_pallas(x, origins, ry, rx, mm, weight, blk, win, dtype)
    xt = _t(x).to(getattr(torch, dtype))
    args = (_t(origins), _t(ry), _t(rx), _t(mm), _t(weight), blk, win, nby,
            nbx)
    got = window_conv_plain(xt, *args)
    assert got.dtype == torch.float32
    assert got.shape == (nby * blk, nbx * blk, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CONTRACT_TOL)
    # what the windowed op runs: the same function through the wrapper
    np.testing.assert_array_equal(
        win_mod._mdc_window_single(xt, *args[:5], blk, win).numpy(),
        got.numpy())


def test_window_conv_cpu_takes_the_plain_version():
    """Image mode on a CPU tensor: the plain version, bit for bit, and no
    launch counted; equal to the rows mode on the gathered windows; a
    device that is neither CPU nor CUDA is refused."""
    x, origins, ry, rx, mm, weight, blk, win, nby, nbx = _inputs('border')
    args = tuple(map(_t, (origins, ry, rx, mm, weight))) + (blk, win, nby,
                                                            nbx)
    n = window_contract.launches
    got = window_conv(_t(x), *args)
    assert window_contract.launches == n
    assert torch.equal(got, window_conv_plain(_t(x), *args))
    rows = win_mod._window_gather(_t(x), args[0], win)
    assert torch.equal(got, window_contract(rows, *args[1:]))
    with pytest.raises(ValueError):
        window_conv(torch.empty(x.shape, device='meta'),
                    *(torch.empty(a.shape, dtype=a.dtype, device='meta')
                      for a in args[:5]), *args[5:])


# ------------------------------------------- the kernel's arithmetic on CPU
def _tent(r, first, exists):
    return torch.where(exists, (1. - (r - first).abs()).clamp_min(0.), 0.)


def sample_columns(x, origins, ry, rx, mm, blk, win, nby, nbx, image=True):
    """The kernel's columns, (P, K, C) f32. For each (group, tap, pixel):
    the first cell of each axis floor(r) clamped to [-2, win], the tents
    there and one cell on (zero for cells outside the window, and in image
    mode for cells outside the image), the x-tents times the modulation;
    at most the 2 x 2 cells whose weight is not zero read, from the image
    at the window's origin (``image``) or from the gathered windows, where
    cells outside the image are 0.0."""
    h, w, c = x.shape
    g, k, p = ry.shape
    cg = c // g
    wo = nbx * blk
    pix = torch.arange(p)
    block = (pix // wo // blk) * nbx + (pix % wo) // blk
    oy = origins[block, :, 0].T.long()                   # (K, P)
    ox = origins[block, :, 1].T.long()
    y0f = ry.floor().clamp(-2, win)
    x0f = rx.floor().clamp(-2, win)
    y0, x0 = y0f.long(), x0f.long()
    ty = [_tent(ry, y0f + d, (y0 + d >= 0) & (y0 + d < win)) for d in (0, 1)]
    tx = [_tent(rx, x0f + d, (x0 + d >= 0) & (x0 + d < win)) * mm
          for d in (0, 1)]
    iy, ix = oy + y0, ox + x0                            # (G, K, P)
    if image:
        ty = [torch.where((iy + d >= 0) & (iy + d < h), t, 0.)
              for d, t in enumerate(ty)]
        tx = [torch.where((ix + d >= 0) & (ix + d < w), t, 0.)
              for d, t in enumerate(tx)]
        src = F.pad(x.float(), (0, 0, 2, 2, 2, 2))       # read 0.0 outside
    else:
        rows = win_mod._window_gather(x, origins, win).float()
        rows = rows.reshape(*rows.shape[:2], win, win, c)
    kk = torch.arange(k)[:, None]
    cols = torch.zeros(g, k, p, cg)
    for gi in range(g):
        chans = slice(gi * cg, (gi + 1) * cg)
        v = {}
        for dy in (0, 1):
            for dx in (0, 1):
                used = (ty[dy][gi] != 0) & (tx[dx][gi] != 0)
                if image:
                    cy = (iy[gi] + dy).clamp(-2, h + 1) + 2
                    cx = (ix[gi] + dx).clamp(-2, w + 1) + 2
                    cell = src[cy, cx, chans]
                else:
                    cy = (y0[gi] + dy).clamp(0, win - 1)
                    cx = (x0[gi] + dx).clamp(0, win - 1)
                    cell = rows[block[None], kk, cy, cx, chans]
                v[dy, dx] = torch.where(used[..., None], cell, 0.)
        t = [a[gi][..., None] for a in (*ty, *tx)]
        s0 = v[0, 1] * t[3] + v[0, 0] * t[2]
        s1 = v[1, 1] * t[3] + v[1, 0] * t[2]
        cols[gi] = s1 * t[1] + s0 * t[0]
    return cols.permute(2, 1, 0, 3).reshape(p, k, c)


def contract(cols, weight, passes=3):
    """The kernel's products, (P, Co): per tap, 8 channels at a time, the
    three TF32 products (big.small + small.big + big.big) summed in a fresh
    f32 value, then one rounded f32 add into the running sum. ``passes=1``
    is a single TF32 product, the scheme the kernel does not use."""
    p, k, c = cols.shape
    acc = torch.zeros(p, weight.shape[-1])
    for kt in range(k):
        for c0 in range(0, c, 8):
            a = cols[:, kt, c0:c0 + 8]
            b = weight[kt, c0:c0 + 8].float()
            if passes == 3:
                ab, a_s = split_tf32(a)
                bb, b_s = split_tf32(b)
                acc = acc + (ab @ b_s + a_s @ bb + ab @ bb)
            else:
                acc = acc + tf32_rna(a) @ tf32_rna(b)
    return acc


def _emulated(inputs, passes=3, image=True):
    x, origins, ry, rx, mm, weight, blk, win, nby, nbx = inputs
    cols = sample_columns(_t(x), _t(origins), _t(ry), _t(rx), _t(mm), blk,
                          win, nby, nbx, image)
    out = contract(cols, _t(weight), passes)
    return out.reshape(nby * blk, nbx * blk, -1)


@pytest.mark.parametrize('name', CASES)
def test_kernel_scheme_matches_jax(name):
    """The emulated kernel against JAX's dense einsums
    (``_window_contract_xla``) and its Pallas kernel in interpret mode."""
    inputs = _inputs(name)
    x, origins, ry, rx, mm, weight, blk, win, nby, nbx = inputs
    rows = jax_win._window_gather(jnp.asarray(x), jnp.asarray(origins), win)
    fj = [jnp.asarray(a) for a in (ry, rx, mm)]
    ty, txm = jax_win._tents(*fj, blk, win, nby, nbx)
    want_xla = np.asarray(jax_win._window_contract_xla(
        rows, ty, txm, jnp.asarray(weight), blk, win, nby, nbx))
    want_pallas = np.asarray(window_contract_pallas(
        rows, *fj, jnp.asarray(weight), blk, win, nby, nbx))
    got = _emulated(inputs).numpy()
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=CONTRACT_TOL)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=CONTRACT_TOL)


@pytest.mark.parametrize('name', ['border', 'huge'])
def test_image_and_rows_sampling_give_the_same_bits(name):
    """Image mode zeroes the tents of cells outside the image where rows
    mode reads the gathered zeros: the columns are equal bit for bit, so
    the two modes of the kernel are too."""
    inputs = _inputs(name)
    x, origins, ry, rx, mm, _, blk, win, nby, nbx = inputs
    args = (_t(x), _t(origins), _t(ry), _t(rx), _t(mm), blk, win, nby, nbx)
    image = sample_columns(*args, image=True)
    rows = sample_columns(*args, image=False)
    assert torch.equal(image, rows)
    if name == 'border':  # origins at both clamps, cells in the zero ring
        o = origins.reshape(-1, 2)
        h, w = x.shape[:2]
        assert (o == -2).any() and (o[:, 0] == h + 2 - win).any()


def test_one_tf32_pass_misses_the_tolerance():
    """Why 3xTF32: a single TF32 product per term is ~1e-3 off at the DCN's
    init scale, far past CONTRACT_TOL, where 3xTF32 stays within it."""
    inputs = _inputs('structured')
    x, origins, ry, rx, mm, weight, blk, win, nby, nbx = inputs
    want = _jax_pallas(x, origins, ry, rx, mm, weight, blk, win, 'float32')
    three = np.abs(_emulated(inputs).numpy() - want).max()
    one = np.abs(_emulated(inputs, passes=1).numpy() - want).max()
    assert three <= CONTRACT_TOL < 10 * CONTRACT_TOL < one
