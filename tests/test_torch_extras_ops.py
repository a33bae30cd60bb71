"""The port's off-path ops against the JAX package's, on the CPU.

- ``resize_flow`` (by ratio and to a shape, up and down, non-square) and
  ``flow_warp`` (non-square, samples across the border, where the
  reference's v * n / (n - 1) - 0.5 rescale and the zero padding show):
  1e-5 of JAX's (f32 sums in other orders).
- ``bilinear_resize``, ``nearest_up`` and ``pixel_unshuffle`` (and its
  round trip through ``pixel_shuffle``): 1e-6, and the round trip exact.
- ``deform_psroi_pooling`` without offsets, with offsets and with a
  ``part_size`` other than the pooled size: 1e-5 of JAX's.
- ``torch_weight_to_kco``: exact.
- The B3 backward's split (``split_backward``), driven with the plain
  backward as the launch, against the unsplit plain backward: a group of
  128 channels (two sub-groups of 64), Co 330 (chunks of 320 and 10
  padded to 12) and Co 6 (padded to 8), at 1e-5 of each gradient's
  largest magnitude (the same sums in another order); and the pieces it
  hands the launch are shapes the kernel takes.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jflow = importlib.import_module('c2matching_tpu.ops.flow')
jres = importlib.import_module('c2matching_tpu.ops.resize')
jdc = importlib.import_module('c2matching_tpu.ops.deform_conv')
tflow = importlib.import_module('c2matching_tpu_torch.ops.flow')
tres = importlib.import_module('c2matching_tpu_torch.ops.resize')
tdc = importlib.import_module('c2matching_tpu_torch.ops.deform_conv')

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(
        want).max()), rtol=0)


@pytest.mark.parametrize('size_type,sizes', [
    ('ratio', (2.0, 0.5)), ('ratio', (0.5, 3.0)), ('shape', (11, 7)),
    ('shape', (4, 13))])
def test_resize_flow(size_type, sizes):
    flow = np.random.RandomState(0).randn(2, 6, 9, 2).astype(np.float32)
    want = jflow.resize_flow(jnp.asarray(flow), size_type, sizes)
    _close(tflow.resize_flow(torch.from_numpy(flow), size_type, sizes), want)


def test_resize_flow_refuses():
    flow = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match='ratio or shape'):
        tflow.resize_flow(flow, 'scale', (2, 2))
    with pytest.raises(NotImplementedError):
        tflow.resize_flow(flow, 'ratio', (2, 2), method='nearest')


@pytest.mark.parametrize('h,w', [(7, 10), (1, 5), (9, 4)])
def test_flow_warp(h, w):
    rng = np.random.RandomState(h * w)
    x = rng.randn(2, h, w, 3).astype(np.float32)
    # shifts that carry samples past every edge, and zero flow (the
    # border rescale reads -0.5 at v = 0)
    flow = rng.uniform(-3, 3, size=(2, h, w, 2)).astype(np.float32)
    flow[1] = 0.0
    want = jflow.flow_warp(jnp.asarray(x), jnp.asarray(flow))
    got = tflow.flow_warp(torch.from_numpy(x), torch.from_numpy(flow))
    _close(got, want)
    assert np.abs(np.asarray(want[1])).max() > 0


@pytest.mark.parametrize('out', [(13, 5), (3, 20), (7, 10)])
def test_bilinear_resize(out):
    x = np.random.RandomState(1).randn(2, 7, 10, 3).astype(np.float32)
    _close(tres.bilinear_resize(torch.from_numpy(x), *out),
           jres.bilinear_resize(jnp.asarray(x), *out), 1e-6)


@pytest.mark.parametrize('factor', [2, 3])
def test_nearest_up_and_pixel_unshuffle(factor):
    x = np.random.RandomState(2).randn(2, 6, 12, 4).astype(np.float32)
    _close(tres.nearest_up(torch.from_numpy(x), factor),
           jres.nearest_up(jnp.asarray(x), factor), 0)
    _close(tres.pixel_unshuffle(torch.from_numpy(x), factor),
           jres.pixel_unshuffle(jnp.asarray(x), factor), 0)
    back = tres.pixel_shuffle(tres.pixel_unshuffle(torch.from_numpy(x),
                                                   factor), factor)
    assert torch.equal(back, torch.from_numpy(x))


@pytest.mark.parametrize('mode', ['no_trans', 'offsets', 'part_size'])
def test_deform_psroi_pooling(mode):
    rng = np.random.RandomState(3)
    od, gs, ps = 4, 3, 3
    x = rng.randn(20, 24, od * gs * gs).astype(np.float32)
    # ROIs inside, across the edges, and a degenerate one (bins >= 0.1)
    rois = np.array([[0, 2, 3, 15, 12], [0, -4, -2, 30, 25],
                     [0, 5, 5, 5, 5], [0, 20.4, 1.6, 22.5, 18.2]],
                    np.float32)
    part = 2 if mode == 'part_size' else ps
    offsets = None
    if mode != 'no_trans':
        offsets = rng.uniform(-1, 1, size=(4, 2, 2, part, part)).astype(
            np.float32)
    kw = dict(output_dim=od, group_size=gs, pooled_size=ps,
              spatial_scale=0.5, trans_std=0.3, no_trans=mode == 'no_trans',
              sample_per_part=3,
              part_size=part if mode == 'part_size' else None)
    want = jdc.deform_psroi_pooling(
        jnp.asarray(x), jnp.asarray(rois),
        None if offsets is None else jnp.asarray(offsets), **kw)
    got = tdc.deform_psroi_pooling(
        torch.from_numpy(x), torch.from_numpy(rois),
        None if offsets is None else torch.from_numpy(offsets), **kw)
    assert got.shape == (4, ps, ps, od)
    _close(got, want)


def test_torch_weight_to_kco():
    w = np.random.RandomState(4).randn(5, 3, 3, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tdc.torch_weight_to_kco(torch.from_numpy(w)).numpy(),
        np.asarray(jdc.torch_weight_to_kco(w)))


def _backward_inputs(seed, b, h, w, c, co, g):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32))
    offset = torch.from_numpy(rng.uniform(-2.5, 2.5, size=(
        b, h, w, g, 9, 2)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(0, 1, size=(b, h, w, g, 9)).astype(
        np.float32))
    grad_out = torch.from_numpy(rng.randn(b, h, w, co).astype(np.float32))
    w_kc = torch.from_numpy((rng.randn(9 * c, co) / np.sqrt(9 * c)).astype(
        np.float32))
    return x, offset, mask, grad_out, w_kc


@pytest.mark.parametrize('c,co,g,pieces', [(128, 16, 1, 1), (64, 330, 8, 2),
                                           (16, 6, 2, 1), (256, 330, 2, 2)])
def test_backward_split(c, co, g, pieces):
    conv = ((3, 3), (1, 1), (1, 1), (1, 1))
    args = _backward_inputs(c + co, 2, 5, 6, c, co, g)
    calls = []

    def launch(x, offset, mask, grad_out, w_kc, *conv, needs):
        # each piece is a shape the kernel takes
        calls.append((x.shape[-1] // offset.shape[3], w_kc.shape[1]))
        assert x.shape[-1] // offset.shape[3] <= tdc.BACKWARD_MAX_GROUP
        assert w_kc.shape[1] % 4 == 0
        assert w_kc.shape[1] <= tdc.BACKWARD_MAX_CO
        return tdc.deform_conv_backward_plain(x, offset, mask, grad_out, w_kc,
                                              *conv, needs=needs)

    for needs in ((True, True, True), (False, True, True),
                  (True, False, False)):
        calls.clear()
        got = tdc.split_backward(launch, *args, conv, needs)
        want = tdc.deform_conv_backward_plain(*args, *conv, needs=needs)
        assert len(calls) == pieces
        for g_got, g_want, need in zip(got, want, needs):
            if not need:
                assert g_got is None and g_want is None
                continue
            assert g_got.shape == g_want.shape
            scale = g_want.abs().max().item()
            assert (g_got - g_want).abs().max().item() <= TOL * scale
