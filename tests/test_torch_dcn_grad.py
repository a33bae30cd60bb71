"""The port's modulated deformable conv under autograd against ``jax.grad``
of the JAX package's op.

``c2matching_tpu.ops.deform_conv.modulated_deform_conv`` is pure XLA, so
``jax.grad`` through it is the reference for every gradient: x, offset,
mask, weight and bias. On the CPU the port's backward runs its plain
version (``deform_conv_backward_plain``: the columns' gradient by
``torch.matmul``, then ``deform_im2col_backward_plain``), the function
kernel B3's backward (``csrc/deform_conv_backward.cu``,
``deform_conv_backward``) computes for a whole batch on the card.

Tolerances, of each gradient's largest magnitude: 1e-4 in f32 (sums in
other orders); 2^-5 with a bf16 image, where the JAX op also rounds its
bilinear factors and the products to bf16 and the port rounds each column
once. The offsets put taps on exact integers (fy = 0, where the derivative
still reads the next corner row) and across the -1 < y < H and -1 < x < W
edges, as the main path's integer match offsets do.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jdc = importlib.import_module('c2matching_tpu.ops.deform_conv')
tdc = importlib.import_module('c2matching_tpu_torch.ops.deform_conv')

F32_REL = 1e-4
BF16_REL = 2 ** -5
# (B, H, W, C, Co, G): C / G of 8, 16 and 32 are the training shapes' group
# widths (relu1, relu2, relu3); 3 is an odd one. Batch 2: the backward
# takes a DynAgg's whole batch at once.
SHAPES = ((2, 9, 11, 64, 16, 8), (2, 7, 6, 128, 8, 8),
          (2, 5, 6, 256, 8, 8), (2, 8, 7, 24, 5, 8))


def _offsets(rng, b, h, w, g, k=9):
    """Integer shifts (the match offsets) plus a residual that is exactly
    0 for a third of the taps, and shifts that carry taps onto and across
    the image's edges."""
    shift = rng.randint(-3, 4, size=(b, h, w, 1, k, 2)).astype(np.float32)
    frac = rng.uniform(-0.9, 0.9, size=(b, h, w, g, k, 2)).astype(np.float32)
    frac[rng.rand(b, h, w, g, k, 2) < 1 / 3] = 0.0
    off = shift + frac
    # a band of taps pushed to exactly -1 - base (invalid) and to h - 1
    # (valid, its lower corner row outside the image)
    off[:, 0, :, :, 0, 0] = -1.0 + 1.0       # y = oy - 1 + 0 + 0 = -1
    off[:, -1, :, :, 8, 0] = -1.0            # y = (h - 1) - 1 + 2 - 1 = h - 1
    off[:, :, 0, :, 3, 1] = 0.5              # x = -0.5, in (-1, 0)
    off[:, :, -1, :, 5, 1] = 0.0             # x = w exactly: invalid
    return off


def _inputs(seed, b, h, w, c, co, g):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    offset = _offsets(rng, b, h, w, g)
    mask = rng.uniform(0, 1, size=(b, h, w, g, 9)).astype(np.float32)
    weight = (rng.randn(9, c, co) / np.sqrt(9 * c)).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    cot = rng.randn(b, h, w, co).astype(np.float32)
    return x, offset, mask, weight, bias, cot


def _jax_grads(x, offset, mask, weight, bias, cot, bf16):
    def loss(x, offset, mask, weight, bias):
        xi = x.astype(jnp.bfloat16) if bf16 else x
        out = jdc.modulated_deform_conv(xi, offset, mask, weight, bias)
        return jnp.sum(out * cot)

    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, offset, mask, weight, bias)))
    return [np.asarray(g, np.float32) for g in grads]


def _port_grads(x, offset, mask, weight, bias, cot, bf16):
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (x, offset, mask, weight, bias)]
    xi = ts[0].to(torch.bfloat16) if bf16 else ts[0]
    out = tdc.modulated_deform_conv(xi, *ts[1:])
    (out * torch.from_numpy(cot)).sum().backward()
    return [t.grad.numpy() for t in ts]


NAMES = ('x', 'offset', 'mask', 'weight', 'bias')


@pytest.mark.parametrize('shape', SHAPES,
                         ids=['relu1-like', 'relu2-like', 'relu3-like',
                              'Cg3'])
@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_grads_match_jax(shape, bf16):
    args = _inputs(sum(shape), *shape)
    want = _jax_grads(*args, bf16)
    got = _port_grads(*args, bf16)
    rel = BF16_REL if bf16 else F32_REL
    for name, g_w, g_p in zip(NAMES, want, got):
        scale = np.abs(g_w).max()
        err = np.abs(g_p - g_w).max()
        assert scale > 0, name
        assert err <= rel * scale, (
            f'grad {name}: max |port - jax| {err:.3g} > {rel:g} x {scale:.3g}')


@pytest.mark.parametrize('shape', SHAPES[:2] + SHAPES[3:],
                         ids=['relu1-like', 'relu2-like', 'Cg3'])
def test_plain_backward_matches_autograd_of_plain_forward(shape):
    """``deform_im2col_backward_plain`` against autograd through
    ``deform_im2col_plain`` on one image, every gradient asked for, and
    with only offset and mask (stage 3: x is the detached reference
    feature)."""
    b, h, w, c, _, g = shape
    x, offset, mask, *_ = _inputs(7 + c, 1, h, w, c, 1, g)
    rng = np.random.RandomState(3)
    gcols = torch.from_numpy(
        rng.randn(h * w, 9 * c).astype(np.float32))
    xt, ot, mt = (torch.from_numpy(a[0]).requires_grad_(True)
                  for a in (x, offset, mask))
    cols = tdc.deform_im2col_plain(xt, ot, mt)
    want = torch.autograd.grad(cols, (xt, ot, mt), gcols)
    got = tdc.deform_im2col_backward_plain(xt.detach(), ot.detach(),
                                           mt.detach(), gcols)
    for name, g_w, g_p in zip(('x', 'offset', 'mask'), want, got):
        err = (g_p - g_w).abs().max().item()
        assert err <= 1e-5 * g_w.abs().max().item(), (name, err)
    only = tdc.deform_im2col_backward_plain(
        xt.detach(), ot.detach(), mt.detach(), gcols,
        needs=(False, True, True))
    assert only[0] is None
    assert torch.equal(only[1], got[1]) and torch.equal(only[2], got[2])


def test_autograd_asks_only_for_what_is_needed(monkeypatch):
    """With x detached (the stage-3 DynAgg), the backward is asked once for
    the whole batch, for the offset and mask gradients only; the weight
    still gets its gradient."""
    x, offset, mask, weight, bias, cot = _inputs(11, *SHAPES[0])
    seen = []
    real = tdc.deform_conv_backward_plain

    def spy(x, *args, needs=(True, True, True), **kwargs):
        seen.append((x.shape[0], tuple(needs)))
        return real(x, *args, needs=needs, **kwargs)

    monkeypatch.setattr(tdc, 'deform_conv_backward_plain', spy)
    ot, mt, wt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (offset, mask, weight))
    out = tdc.modulated_deform_conv(torch.from_numpy(x), ot, mt, wt,
                                    torch.from_numpy(bias))
    (out * torch.from_numpy(cot)).sum().backward()
    assert seen == [(x.shape[0], (False, True, True))]
    assert wt.grad is not None and ot.grad is not None


@pytest.mark.parametrize('wanted', ['x', 'offset', 'mask', 'weight', 'bias'])
def test_each_gradient_alone(wanted, monkeypatch):
    """Only the input that needs a gradient gets one, equal to its value
    when every input needs one; the x, offset and mask backward runs only
    when one of the three is asked for, and computes no grad_x unless x
    needs it."""
    args = _inputs(13, *SHAPES[1])
    full = _port_grads(*args, False)
    seen = []
    real = tdc.deform_conv_backward_plain

    def spy(*a, needs=(True, True, True), **kwargs):
        seen.append(tuple(needs))
        got = real(*a, needs=needs, **kwargs)
        assert all((g is None) == (not n) for g, n in zip(got, needs))
        return got

    monkeypatch.setattr(tdc, 'deform_conv_backward_plain', spy)
    ts = [torch.from_numpy(a).requires_grad_(name == wanted)
          for name, a in zip(NAMES, args)]
    out = tdc.modulated_deform_conv(*ts)
    (out * torch.from_numpy(args[-1])).sum().backward()
    i = NAMES.index(wanted)
    assert seen == ([tuple(n == wanted for n in NAMES[:3])] if i < 3 else [])
    for name, t, g in zip(NAMES, ts, full):
        if name == wanted:
            assert torch.equal(t.grad, torch.from_numpy(g)), name
        else:
            assert t.grad is None, name


@pytest.mark.parametrize('entry', ['batch', 'columns'])
def test_large_offsets_give_zero_gradients(entry):
    """Taps far outside the image (offsets of 1e4 to 3e30, as the forward's
    probes use) get exact zero offset and mask gradients and scatter
    nothing onto x: through the batched backward (``deform_conv_backward``)
    and through the columns' route (``deform_col2im``)."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 6, 5, 16).astype(np.float32))
    big = np.array([1e4, -1e4, 1e6, -3e30], np.float32)
    offset = torch.from_numpy(big[rng.randint(0, 4, (2, 6, 5, 8, 9, 2))])
    mask = torch.from_numpy(rng.rand(2, 6, 5, 8, 9).astype(np.float32))
    gout = torch.from_numpy(rng.randn(2, 6, 5, 12).astype(np.float32))
    w_kc = torch.from_numpy(rng.randn(9 * 16, 12).astype(np.float32))
    if entry == 'batch':
        gx, goff, gm = tdc.deform_conv_backward(x, offset, mask, gout, w_kc)
    else:
        gcols = gout[0].reshape(30, 12) @ w_kc.t()
        gx, goff, gm = tdc.deform_col2im(x[0], offset[0], mask[0], gcols)
    assert bool((gx == 0).all() and (goff == 0).all() and (gm == 0).all())
