"""The port's eval metrics against the JAX package's.

``c2matching_tpu_torch.utils.metrics`` builds the SSIM window and the
filter without cv2; on the same images every metric must equal the JAX
package's (which calls cv2) to 1e-10, float64 sums in another order.
"""
import cv2
import numpy as np
import pytest

from c2matching_tpu.utils import metrics as jax_metrics
from c2matching_tpu_torch.utils import metrics

TOL = 1e-10


def _pair(seed, shape, dtype):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape) * 255
    b = np.clip(a + rng.randn(*shape) * 12, 0, 255)
    if dtype == np.uint8:
        return a.round().astype(np.uint8), b.round().astype(np.uint8)
    return a.astype(dtype), b.astype(dtype)


def test_gaussian_window_is_cv2s():
    """Equal up to one rounding of the normalisation (an ulp of 0.27 is
    5.6e-17)."""
    want = cv2.getGaussianKernel(11, 1.5)[:, 0]
    assert np.abs(metrics.gaussian_kernel() - want).max() <= 1e-16


@pytest.mark.parametrize('shape,dtype,crop', [
    ((160, 160, 3), np.uint8, 4),
    ((83, 125, 3), np.uint8, 0),
    ((64, 48, 3), np.float64, 4),
    ((40, 52), np.float32, 2),
    ((30, 29, 1), np.uint8, 1),
])
def test_psnr_ssim_match_jax(shape, dtype, crop):
    a, b = _pair(0, shape, dtype)
    for name in ('psnr', 'ssim'):
        got = getattr(metrics, name)(a, b, crop_border=crop)
        want = getattr(jax_metrics, name)(a, b, crop_border=crop)
        assert abs(got - want) <= TOL, (name, got, want)


@pytest.mark.parametrize('dtype', [np.uint8, np.float64, np.float32])
@pytest.mark.parametrize('only_y', [True, False])
def test_bgr2ycbcr_matches_jax(dtype, only_y):
    a, _ = _pair(1, (37, 41, 3), np.uint8)
    img = a if dtype == np.uint8 else (a / 255.).astype(dtype)
    got = metrics.bgr2ycbcr(img, only_y=only_y)
    want = jax_metrics.bgr2ycbcr(img, only_y=only_y)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_chw_order_and_identical_images():
    a, b = _pair(2, (3, 40, 44), np.uint8)
    for name in ('psnr', 'ssim'):
        got = getattr(metrics, name)(a, b, 2, input_order='CHW')
        want = getattr(jax_metrics, name)(a, b, 2, input_order='CHW')
        assert abs(got - want) <= TOL
    assert metrics.psnr(a, a) == float('inf')
    assert metrics.ssim(a, a, input_order='CHW') == pytest.approx(1.0,
                                                                   abs=1e-12)
    with pytest.raises(ValueError):
        metrics.psnr(a, b[:, 1:])
