"""The arithmetic of kernel B3's backward (``csrc/deform_conv_backward.cu``),
emulated in torch on the CPU, against ``jax.grad`` of the JAX package's
deformable conv.

On the card the kernel forms the columns' gradient G = grad_out @ w_kc^T
inside each block as 3xTF32 with wgmma: w_kc is split into big =
tf32(v) and small = tf32(v - big) by a pass before the products, and
grad_out's values the same way in registers (both here by ``split_tf32``
of tests/test_torch_match_f32_scheme.py, by bit operations). For each
32-deep stage of Co, the three products big.small, small.big and big.big
of each 8-deep step add, in that order, into a fresh accumulator as the
tensor cores add (``tensor_core_add``: every term cut toward zero at the
last place of the largest, the sum cut toward zero to f32), and one
rounded f32 add takes the stage into the running sum. For a bf16 x,
whose w_kc is bf16-rounded, the kernel drops big.small: w's small part is
zero. The four corner dots of G with x follow, as in the plain version.
The emulation is held against ``jax.grad`` with chip_smoke.py's gate for
the kernel against its plain version: B3B_REL of the largest offset and
mask gradient, at the group widths of stage-3 training (8, 16 and 32
channels a group, Co = C as in the DynAggs). A single TF32 pass, which
the kernel does not use, misses it.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dcn_grad import _offsets
from test_torch_match_f32_scheme import split_tf32, tf32_rna

jdc = importlib.import_module('c2matching_tpu.ops.deform_conv')
tdc = importlib.import_module('c2matching_tpu_torch.ops.deform_conv')

B3B_REL = 1e-5      # chip_smoke.py: |kernel - plain| of the offset and mask
                    # gradients, of their largest magnitude
CG = (8, 16, 32)    # relu1, relu2, relu3 of stage-3 training (G = 8)


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tensor_core_add(acc, products):
    """acc (f32) plus one wgmma step's products (float64, each exact), as
    the tensor cores add them: every term cut toward zero at the unit in
    the last place an f32 of the largest term has, the terms summed, and
    the sum cut toward zero to f32. products: (..., 8)."""
    terms = torch.cat([acc.double().unsqueeze(-1), products], -1)
    _, e = torch.frexp(terms.abs().amax(-1, keepdim=True))
    ulp = torch.ldexp(torch.ones_like(terms[..., :1]), e - 24)
    exact = (torch.trunc(terms / ulp) * ulp).sum(-1)
    f = exact.float()
    over = f.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def columns_grad(grad_out, w_kc, passes=3, stage=32, step=8):
    """G (P, K*C) as the kernel forms it: both operands split by
    ``split_tf32``, then over Co in stages of ``stage``, the products of
    each ``step``-deep step (big.small, small.big, big.big) added into a
    fresh accumulator by ``tensor_core_add``, and one rounded f32 add of
    the stage into the running sum. ``passes=2`` drops big.small (the
    kernel's bf16 path); ``passes=1`` is one TF32 product a step."""
    ab, a_s = split_tf32(grad_out)
    wb, ws = split_tf32(w_kc)
    pairs = {3: ((ab, ws), (a_s, wb), (ab, wb)), 2: ((a_s, wb), (ab, wb)),
             1: ((tf32_rna(grad_out), tf32_rna(w_kc)),)}[passes]
    acc = torch.zeros(grad_out.shape[0], w_kc.shape[0])
    for o0 in range(0, w_kc.shape[1], stage):
        part = torch.zeros_like(acc)
        for k in range(o0, min(o0 + stage, w_kc.shape[1]), step):
            o = slice(k, k + step)
            for a, b in pairs:
                part = tensor_core_add(
                    part, a[:, None, o].double() * b[None, :, o].double())
        acc = acc + part
    return acc


def _inputs(cg, seed, b=2, h=6, w=7, g=8):
    """A DynAgg-shaped case at width C = G * cg and Co = C, the offsets of
    tests/test_torch_dcn_grad.py, a weight at the DCN's init scale."""
    c = g * cg
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    offset = _offsets(rng, b, h, w, g)
    mask = rng.uniform(0, 1, size=(b, h, w, g, 9)).astype(np.float32)
    weight = (rng.randn(9, c, c) / np.sqrt(9 * c)).astype(np.float32)
    cot = rng.randn(b, h, w, c).astype(np.float32)
    return x, offset, mask, weight, cot


def _jax_offset_mask_grads(x, offset, mask, weight, cot):
    def loss(offset, mask):
        out = jdc.modulated_deform_conv(jnp.asarray(x), offset, mask,
                                        jnp.asarray(weight))
        return jnp.sum(out * cot)

    grads = jax.grad(loss, argnums=(0, 1))(jnp.asarray(offset),
                                           jnp.asarray(mask))
    return [np.asarray(g) for g in grads]


def _emulated(x, offset, mask, weight, cot, passes=3):
    """The kernel's offset and mask gradients: G by ``columns_grad``, then
    the corner dots image by image."""
    b, h, w, c = x.shape
    w_kc = torch.from_numpy(weight).reshape(9 * c, c)
    goff, gm = [], []
    for i in range(b):
        gcols = columns_grad(torch.from_numpy(cot[i]).reshape(h * w, c),
                             w_kc, passes=passes)
        _, go, gmi = tdc.deform_im2col_backward_plain(
            torch.from_numpy(x[i]), torch.from_numpy(offset[i]),
            torch.from_numpy(mask[i]), gcols, needs=(False, True, True))
        goff.append(go)
        gm.append(gmi)
    return torch.stack(goff).numpy(), torch.stack(gm).numpy()


def _worst(got, want):
    """max |got - want| over the offset and mask gradients, and the
    largest of their magnitudes."""
    err = max(np.abs(g - w).max() for g, w in zip(got, want))
    return err, max(np.abs(w).max() for w in want)


@pytest.mark.parametrize('cg', CG)
def test_kernel_scheme_matches_jax(cg):
    args = _inputs(cg, seed=cg)
    want = _jax_offset_mask_grads(*args)
    err, scale = _worst(_emulated(*args), want)
    assert err <= B3B_REL * scale, (err, scale)


@pytest.mark.parametrize('cg', CG)
def test_plain_backward_matches_jax_within_the_gate(cg):
    """The plain version (true f32 G, the card's reference for the kernel)
    meets the same gate against JAX, so the gate measures the scheme."""
    x, offset, mask, weight, cot = _inputs(cg, seed=cg)
    c = x.shape[-1]
    got = tdc.deform_conv_backward_plain(
        *(torch.from_numpy(a) for a in (x, offset, mask, cot)),
        torch.from_numpy(weight).reshape(9 * c, c), needs=(False, True, True))
    err, scale = _worst([g.numpy() for g in got[1:]],
                        _jax_offset_mask_grads(x, offset, mask, weight, cot))
    assert err <= B3B_REL * scale, (err, scale)


def test_one_tf32_pass_misses_the_gate():
    """Why 3xTF32: one TF32 product a step is far past B3B_REL at the relu3
    width, where the three products stay within it."""
    args = _inputs(32, seed=32)
    want = _jax_offset_mask_grads(*args)
    three, scale = _worst(_emulated(*args), want)
    one, _ = _worst(_emulated(*args, passes=1), want)
    assert three <= B3B_REL * scale < 10 * B3B_REL * scale < one


def test_bf16_path_drops_a_zero_product():
    """For a bf16 x the kernel loads w's big part alone and drops
    big.small: on bf16-rounded w_kc, small is zero and G is bit for bit
    the three-product one."""
    rng = np.random.RandomState(3)
    w_kc = torch.from_numpy((rng.randn(9 * 64, 64) / 24).astype(np.float32))
    w_kc = w_kc.bfloat16().float()
    grad_out = torch.from_numpy(rng.randn(50, 64).astype(np.float32))
    three = columns_grad(grad_out, w_kc, passes=3)
    two = columns_grad(grad_out, w_kc, passes=2)
    assert torch.equal(three, two)


@pytest.mark.parametrize('co', [64, 36, 20])
def test_weight_split_plain(co):
    """The pre-split's plain version (``split_tf32``, as the emulation
    splits w_kc): big and small are TF32 values whose sum is w_kc to
    within TF32's rounding of the rest; on bf16-rounded w_kc, big is w_kc
    itself and small is zero, so the bf16 path's dropped product adds
    zeros."""
    rng = np.random.RandomState(co)
    w_kc = torch.from_numpy(rng.randn(9 * 24, co).astype(np.float32))
    big, small = split_tf32(w_kc)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1fff).any()
    assert torch.equal(big, tf32_rna(w_kc))
    rest = (big.double() + small.double() - w_kc.double()).abs()
    assert (rest <= 2.0 ** -21 * w_kc.double().abs()).all()
    bf = w_kc.bfloat16().float()
    big, small = split_tf32(bf)
    assert torch.equal(big, bf) and not small.any()
