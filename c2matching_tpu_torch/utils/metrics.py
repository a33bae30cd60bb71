"""Evaluation metrics: PSNR, MATLAB-compatible SSIM, BT.601 Y conversion.

Counterpart of ``c2matching_tpu/utils/metrics.py``, in float64 numpy on
the host, on the final uint8 images, as the published protocol defines
them. Without cv2: the 11-tap Gaussian window (sigma 1.5) is built here as
``cv2.getGaussianKernel(11, 1.5)`` builds it, and ``cv2.filter2D`` becomes
a 'valid' correlation in two 1-D passes. The reference crops
``[5:-5, 5:-5]`` off every filtered map, which removes exactly the pixels
whose window reaches past the image, so no border mode is needed.
"""
import numpy as np

_SSIM_TAPS = 11
_SSIM_SIGMA = 1.5


def reorder_image(img, input_order='HWC'):
    """Return image as HWC (2D images get a trailing singleton channel)."""
    if input_order not in ('HWC', 'CHW'):
        raise ValueError(f'Wrong input_order {input_order}')
    if img.ndim == 2:
        return img[..., None]
    if input_order == 'CHW':
        return img.transpose(1, 2, 0)
    return img


def psnr(img1, img2, crop_border=0, input_order='HWC'):
    """PSNR over [0, 255] images, with border cropping."""
    if img1.shape != img2.shape:
        raise ValueError(f'Image shapes differ: {img1.shape} vs {img2.shape}')
    img1 = reorder_image(img1, input_order).astype(np.float64)
    img2 = reorder_image(img2, input_order).astype(np.float64)
    if crop_border != 0:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border]
    mse = np.mean((img1 - img2)**2)
    if mse == 0:
        return float('inf')
    return 20. * np.log10(255. / np.sqrt(mse))


def gaussian_kernel(taps=_SSIM_TAPS, sigma=_SSIM_SIGMA):
    """(taps,) float64 Gaussian, exp(-(i - (taps-1)/2)^2 / (2 sigma^2))
    normalised to sum 1, the column cv2.getGaussianKernel returns."""
    x = np.arange(taps, dtype=np.float64) - (taps - 1) / 2
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return k / k.sum()


def _filter_valid(img, kernel):
    """2-D correlation of ``img`` with the separable window
    outer(kernel, kernel), at the positions where the window lies inside
    the image: cv2.filter2D cropped by the window's half-size on every
    side. Two 1-D passes, rows then columns."""
    n = len(kernel)
    h, w = img.shape
    rows = sum(kernel[i] * img[i:h - n + 1 + i] for i in range(n))
    return sum(kernel[j] * rows[:, j:w - n + 1 + j] for j in range(n))


def _ssim_single(img1, img2):
    """SSIM for one channel, MATLAB-window protocol (11x11 gaussian, 1.5)."""
    c1 = (0.01 * 255)**2
    c2 = (0.03 * 255)**2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    kernel = gaussian_kernel()

    mu1 = _filter_valid(img1, kernel)
    mu2 = _filter_valid(img2, kernel)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = _filter_valid(img1**2, kernel) - mu1_sq
    sigma2_sq = _filter_valid(img2**2, kernel) - mu2_sq
    sigma12 = _filter_valid(img1 * img2, kernel) - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


def ssim(img1, img2, crop_border=0, input_order='HWC'):
    """Channel-averaged MATLAB-compatible SSIM over [0, 255] images."""
    if img1.shape != img2.shape:
        raise ValueError(f'Image shapes differ: {img1.shape} vs {img2.shape}')
    img1 = reorder_image(img1, input_order)
    img2 = reorder_image(img2, input_order)
    if crop_border != 0:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border]
    return np.mean(
        [_ssim_single(img1[..., i], img2[..., i])
         for i in range(img1.shape[2])])


def bgr2ycbcr(img, only_y=True):
    """BT.601 BGR->YCbCr, matching MATLAB rgb2ycbcr on BGR-ordered input.

    uint8 input in [0, 255] -> rounded uint8 output; float input in [0, 1]
    -> float output in [0, 1].
    """
    in_img_type = img.dtype
    img = img.astype(np.float64)
    if in_img_type != np.uint8:
        img = img * 255.
    if only_y:
        rlt = np.dot(img, [24.966, 128.553, 65.481]) / 255.0 + 16.0
    else:
        rlt = np.matmul(
            img, [[24.966, 112.0, -18.214], [128.553, -74.203, -93.786],
                  [65.481, -37.797, 112.0]]) / 255.0 + [16, 128, 128]
    if in_img_type == np.uint8:
        rlt = rlt.round()
    else:
        rlt = rlt / 255.
    return rlt.astype(in_img_type)
