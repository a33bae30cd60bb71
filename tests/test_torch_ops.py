"""The port's ops (c2matching_tpu_torch.ops) against the JAX package's.

Inputs are made with numpy from a seed and fed to both sides. On the CPU
the kernel wrappers take their plain versions; the kernels themselves are
held against those plain versions on the card by chip_smoke.py.
"""
from importlib import import_module

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from c2matching_tpu.ops.pallas import match_argmax as jax_match_argmax
from c2matching_tpu_torch.ops import (deform_conv, deform_im2col,
                                      deform_im2col_plain, match_argmax,
                                      modulated_deform_conv)

# the packages' __init__ re-export functions under their modules' names
jax_dcn = import_module('c2matching_tpu.ops.deform_conv')
jax_flow = import_module('c2matching_tpu.ops.flow')
jax_pm = import_module('c2matching_tpu.ops.patch_match')
jax_resize = import_module('c2matching_tpu.ops.resize')
flow = import_module('c2matching_tpu_torch.ops.flow')
patch_match = import_module('c2matching_tpu_torch.ops.patch_match')
resize = import_module('c2matching_tpu_torch.ops.resize')

# Same f32 formulas on both sides; XLA may fuse multiply-adds and sum in
# another order, which moves the last bits only.
F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------- resize
@pytest.mark.parametrize('valid', [None, (5, 4)])
def test_upscale_matches_jax(valid):
    """The port upsamples the exact ``valid`` rows and columns; the JAX
    package the whole batch, clamped at the last valid row and column,
    cut to the valid region."""
    x = np.random.RandomState(0).randn(2, 7, 6, 3).astype(np.float32)
    vh, vw = x.shape[1:3] if valid is None else valid
    want = np.asarray(jax_resize.upscale(jnp.asarray(x), 4, 'bilinear',
                                         valid_shape=valid))
    got = resize.upscale(_t(x[:, :vh, :vw]), 4, 'bilinear').numpy()
    np.testing.assert_allclose(got, want[:, :4 * vh, :4 * vw], rtol=0,
                               atol=F32_TOL)


def test_pixel_shuffle_channel_order_matches_jax():
    x = np.random.RandomState(2).randn(2, 3, 5, 4 * 6).astype(np.float32)
    want = np.asarray(jax_resize.pixel_shuffle(jnp.asarray(x), 2))
    np.testing.assert_array_equal(resize.pixel_shuffle(_t(x), 2).numpy(),
                                  want)


# ----------------------------------------------------------------- flow
@pytest.mark.parametrize('valid', [None, (7, 6)])
def test_pre_offsets_match_jax(valid):
    """The port's pre-offsets of matches on the exact (vh-2) x (vw-2)
    grid; the JAX package's of the same matches on the padded 6 x 5 grid
    with ``valid_shape``, cut to the valid region."""
    vh, vw = (8, 7) if valid is None else valid
    rng = np.random.RandomState(3)
    idx = rng.randint(0, (vh - 2) * (vw - 2), (2, vh - 2, vw - 2))
    padded = rng.randint(0, 30, (2, 6, 5))
    padded[:, :vh - 2, :vw - 2] = (idx // (vw - 2)) * 5 + idx % (vw - 2)
    want = jax_flow.batched_pre_offsets(jnp.asarray(padded.astype(np.int32)),
                                        valid_shape=valid)
    got = flow.batched_pre_offsets(_t(idx.astype(np.int32)))
    assert set(got) == set(want)
    for key, f in (('relu3_1', 1), ('relu2_1', 2), ('relu1_1', 4)):
        np.testing.assert_array_equal(
            got[key].numpy(), np.asarray(want[key])[:, :, :vh * f, :vw * f])


# ---------------------------------------------------------- patch match
def _feats(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_patch_match_matches_jax():
    fi, fr = _feats(4, (12, 12, 8)), _feats(5, (12, 12, 8))
    want_i, want_v = jax_pm.patch_match(jnp.asarray(fi), jnp.asarray(fr),
                                        use_pallas=False)
    got_i, got_v = patch_match.patch_match(_t(fi), _t(fr))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=F32_TOL)


def test_batched_patch_match_exact_shape_matches_jax_padded():
    """The port's match of the exact 9 x 10 features; the JAX package's of
    the 12 x 12 ones with ``valid_shape``, cut to the valid query region,
    its indices read on the valid 7 x 8 grid."""
    fi, fr = _feats(6, (2, 12, 12, 8)), _feats(7, (2, 12, 12, 8))
    vs = (9, 10)
    want_i, want_v = (np.asarray(a)[:, :7, :8] for a in
                      jax_pm.batched_patch_match(jnp.asarray(fi),
                                                 jnp.asarray(fr),
                                                 valid_shape=vs))
    got_i, got_v = patch_match.batched_patch_match(_t(fi[:, :9, :10]),
                                                   _t(fr[:, :9, :10]))
    np.testing.assert_array_equal(got_i.numpy(),
                                  (want_i // 10) * 8 + want_i % 10)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=0, atol=F32_TOL)


def test_patch_match_bf16_operands_match_jax():
    """compute_dtype casts only the operands on both sides. bf16 products
    are exact in f32, so the scores differ by f32 summation order only;
    this seed has no near-tie that such a difference could flip."""
    fi, fr = _feats(8, (10, 11, 16)), _feats(9, (10, 11, 16))
    want_i, want_v = jax_pm.patch_match(jnp.asarray(fi), jnp.asarray(fr),
                                        use_pallas=False,
                                        compute_dtype='bfloat16')
    got_i, got_v = patch_match.patch_match(_t(fi), _t(fr),
                                           compute_dtype='bfloat16')
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=F32_TOL)


def test_patch_match_golden():
    """tests/test_golden.py::test_golden_patch_match's inputs and values."""
    r = np.random.RandomState(7)
    r.randn(1, 12, 10, 8)
    r.randn(1, 12, 10, 2, 9, 2)
    r.rand(1, 12, 10, 2, 9)
    r.randn(9, 8, 6)
    fi = _t(r.randn(14, 14, 8).astype(np.float32))
    fr = _t(r.randn(14, 14, 8).astype(np.float32))
    idx, val = patch_match.patch_match(fi, fr)
    assert int(idx.sum()) == 9844
    np.testing.assert_allclose(float(val.sum()), 44.579063, rtol=1e-5)


def test_match_argmax_matches_pallas_interpret():
    """Shapes that are not multiples of the Pallas tiles."""
    rng = np.random.RandomState(0)
    q = rng.randn(300, 64).astype(np.float32)
    r = rng.randn(470, 64).astype(np.float32)
    want_i, want_v = jax_match_argmax(jnp.asarray(q), jnp.asarray(r),
                                      tile_q=128, tile_r=128, interpret=True)
    got_i, got_v = match_argmax(_t(q), _t(r))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=1e-4)  # scores of O(10), f32 sums


def test_match_argmax_ties_first_wins_like_pallas():
    """Duplicated ref rows across the Pallas tile boundaries: exact ties,
    and the lowest index wins on both sides."""
    rng = np.random.RandomState(1)
    base = rng.randn(40, 32).astype(np.float32)
    r = np.concatenate([base, base, base])
    q = base[:8] * 2.0
    want_i, _ = jax_match_argmax(jnp.asarray(q), jnp.asarray(r), tile_q=8,
                                 tile_r=16, interpret=True)
    got_i, _ = match_argmax(_t(q), _t(r))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(), np.arange(8))


def test_match_argmax_ref_bias_matches_pallas():
    rng = np.random.RandomState(3)
    q = rng.randn(70, 32).astype(np.float32)
    r = rng.randn(200, 32).astype(np.float32)
    keep = (rng.rand(200) > 0.5).astype(np.float32)
    bias = ((1.0 - keep) * -1e30).astype(np.float32)
    want_i, want_v = jax_match_argmax(jnp.asarray(q), jnp.asarray(r),
                                      ref_bias=jnp.asarray(bias), tile_q=32,
                                      tile_r=32, interpret=True)
    got_i, got_v = match_argmax(_t(q), _t(r), _t(bias))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=1e-4)
    assert np.all(keep[got_i.numpy()] == 1.0)


def test_cpu_tensors_take_the_plain_versions():
    """No launch is counted for a CPU tensor, and a device that is neither
    CPU nor CUDA is refused rather than computed some other way."""
    n_match, n_dcn = match_argmax.launches, deform_im2col.launches
    match_argmax(torch.randn(5, 8), torch.randn(6, 8))
    deform_im2col(torch.randn(4, 4, 8), torch.zeros(4, 4, 2, 9, 2),
                  torch.ones(4, 4, 2, 9))
    assert (match_argmax.launches, deform_im2col.launches) == (n_match,
                                                               n_dcn)
    with pytest.raises(ValueError):
        match_argmax(torch.empty(5, 8, device='meta'),
                     torch.empty(6, 8, device='meta'))
    with pytest.raises(ValueError):
        deform_im2col(torch.empty(4, 4, 8, device='meta'),
                      torch.empty(4, 4, 2, 9, 2, device='meta'),
                      torch.empty(4, 4, 2, 9, device='meta'))


# ---------------------------------------------------------- deform conv
def _dcn_inputs(seed, b=2, h=12, w=10, c=16, g=2, co=6, ho=None, wo=None):
    r = np.random.RandomState(seed)
    ho, wo = ho or h, wo or w
    x = r.randn(b, h, w, c).astype(np.float32)
    off = (3.0 * r.randn(b, ho, wo, g, 9, 2)).astype(np.float32)
    mask = r.rand(b, ho, wo, g, 9).astype(np.float32)
    wgt = (0.1 * r.randn(9, c, co)).astype(np.float32)
    bias = r.randn(co).astype(np.float32)
    return x, off, mask, wgt, bias


def test_modulated_deform_conv_matches_jax():
    x, off, mask, wgt, bias = _dcn_inputs(10)
    want = np.asarray(jax_dcn.modulated_deform_conv(
        *map(jnp.asarray, (x, off, mask, wgt, bias))))
    got = modulated_deform_conv(*map(_t, (x, off, mask, wgt, bias))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_modulated_deform_conv_strided_dilated_matches_jax():
    """A non-default config, which the JAX package runs through its
    reference formulation."""
    x, off, mask, wgt, _ = _dcn_inputs(11, ho=5, wo=4)
    cfg = dict(stride=(2, 2), padding=(1, 1), dilation=(2, 2))
    want = np.asarray(jax_dcn.modulated_deform_conv(
        *map(jnp.asarray, (x, off, mask, wgt)), **cfg))
    got = modulated_deform_conv(*map(_t, (x, off, mask, wgt)), **cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_deform_conv_v1_matches_jax():
    x, off, _, wgt, bias = _dcn_inputs(12)
    want = np.asarray(jax_dcn.deform_conv(
        *map(jnp.asarray, (x, off, wgt, bias))))
    got = deform_conv(*map(_t, (x, off, wgt, bias))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_modulated_deform_conv_bf16_matches_jax_bf16():
    """x in bf16 on both sides. JAX rounds the bilinear factor and each
    corner product to bf16; the port rounds the summed column once. Each
    side is within a few bf16 roundings (2^-8 relative each) of the exact
    terms, so the bound is 2^-6 of the sum of |terms|: the plain columns
    of |x| contracted with |weight|."""
    x, off, mask, wgt, bias = _dcn_inputs(13)
    xb = x.astype(jnp.bfloat16)
    want = np.asarray(jax_dcn.modulated_deform_conv(
        jnp.asarray(xb), *map(jnp.asarray, (off, mask, wgt, bias))))
    got = modulated_deform_conv(_t(x).to(torch.bfloat16),
                                *map(_t, (off, mask, wgt, bias))).numpy()
    xa = np.abs(np.asarray(xb, np.float32))
    size = np.abs(np.stack([
        (deform_im2col_plain(_t(xa[i]), _t(off[i]), _t(mask[i])).numpy()
         @ np.abs(wgt).reshape(-1, wgt.shape[-1]))
        for i in range(x.shape[0])])).reshape(got.shape)
    assert np.all(np.abs(got - want) <= 2 ** -6 * size + F32_TOL)
    assert np.abs(got - want).max() > 0   # the two really round apart


def test_deform_im2col_large_offsets_give_exact_zeros():
    x, off, mask, _, _ = _dcn_inputs(14, b=1)
    big = np.where(np.random.RandomState(0).rand(*off.shape[1:]) > 0.5,
                   1e4, -1e6).astype(np.float32)
    cols = deform_im2col(_t(x[0]), _t(big), _t(mask[0]))
    assert torch.equal(cols, torch.zeros_like(cols))


def test_modulated_deform_conv_golden():
    """tests/test_golden.py::test_golden_deform_conv's inputs and sums."""
    r = np.random.RandomState(7)
    x = _t(r.randn(1, 12, 10, 8).astype(np.float32))
    off = _t(r.randn(1, 12, 10, 2, 9, 2).astype(np.float32))
    mask = _t(r.rand(1, 12, 10, 2, 9).astype(np.float32))
    wgt = _t(r.randn(9, 8, 6).astype(np.float32) * 0.1)
    out = modulated_deform_conv(x, off, mask, wgt)
    np.testing.assert_allclose(float(out.sum()), -19.133776, rtol=1e-4)
    np.testing.assert_allclose(float(out.abs().sum()), 157.98320, rtol=1e-4)
