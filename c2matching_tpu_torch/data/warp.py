"""The three OpenCV calls of the contrastive data, in numpy, without cv2.

- ``get_perspective_transform``: ``cv2.getPerspectiveTransform`` (the
  8 x 8 system of the four point pairs, solved in double by OpenCV's LU
  with partial pivoting: the same operations in the same order, so the
  same bits).
- ``warp_perspective``: ``cv2.warpPerspective`` with its defaults
  (``INTER_LINEAR``, ``BORDER_CONSTANT`` 0) on float32 images. The matrix
  is inverted in double as OpenCV inverts a 3 x 3 (the closed form over
  the determinant), then rounded to float32; each destination pixel maps
  to ``(M0 x + (M1 y + M2)) / (M6 x + (M7 y + M8))`` with fused
  multiply-adds in float32 (the last ``w % WARP_LANES`` columns as
  ``((M0 x + M1 y) + M2) / ...``), and the bilinear blend is
  ``v0 = p00 + a (p01 - p00)``, ``v1`` alike, ``v0 + b (v1 - v0)``, each a
  fused multiply-add. A corner outside the image reads 0; a point whose
  four corners are all outside is 0. This is the arithmetic of OpenCV 5's
  float32 warp kernels, bit for bit.
- ``resize_cubic``: ``cv2.resize(..., interpolation=cv2.INTER_CUBIC)``:
  source position ``(d + 0.5) * scale - 0.5`` rounded to float32, the
  A = -0.75 cubic weights in float32, source indices clamped, no
  antialias when shrinking, horizontal pass then vertical, each a sum of
  four products from the left, in the image's dtype; the same size is a
  copy. This is OpenCV's own resampler and equals cv2 bit for bit on
  float64 images. On float32 images cv2 5 hands the resize to Intel IPP,
  whose weights differ in the last bits (measured in
  ``tests/test_torch_contras_data.py``).
"""
import numpy as np


# ------------------------------------------------------------ homography
def _lu_solve(a, b):
    """OpenCV's ``LUImpl`` on a copy of (a, b): partial pivoting on the
    first largest magnitude, row updates ``a_j += (a_ji * -1/a_ii) a_i``,
    back substitution from the left."""
    a = np.array(a, np.float64)
    b = np.array(b, np.float64)
    m = a.shape[0]
    for i in range(m):
        k = i + int(np.argmax(np.abs(a[i:, i])))
        if abs(a[k, i]) < np.finfo(np.float64).eps * 100:
            raise ValueError('get_perspective_transform: singular system')
        if k != i:
            a[[i, k], i:] = a[[k, i], i:]
            b[[i, k]] = b[[k, i]]
        d = -1.0 / a[i, i]
        alpha = a[i + 1:, i] * d
        a[i + 1:, i + 1:] += alpha[:, None] * a[i, i + 1:]
        b[i + 1:] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for k in range(i + 1, m):
            s -= a[i, k] * b[k]
        b[i] = s / a[i, i]
    return b


def get_perspective_transform(src, dst):
    """The 3 x 3 float64 homography mapping the four (x, y) points ``src``
    onto ``dst`` (float32 coordinates), as ``cv2.getPerspectiveTransform``
    gives it."""
    src = np.asarray(src, np.float32).reshape(4, 2)
    dst = np.asarray(dst, np.float32).reshape(4, 2)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        (sx, sy), (dx, dy) = src[i], dst[i]
        a[i, 0] = a[i + 4, 3] = sx
        a[i, 1] = a[i + 4, 4] = sy
        a[i, 2] = a[i + 4, 5] = 1.0
        # float products, as OpenCV's Point2f arithmetic
        a[i, 6] = -sx * dx
        a[i, 7] = -sy * dx
        a[i + 4, 6] = -sx * dy
        a[i + 4, 7] = -sy * dy
        b[i] = dx
        b[i + 4] = dy
    return np.append(_lu_solve(a, b), 1.0).reshape(3, 3)


def _invert3(m):
    """OpenCV's closed-form inverse of a 3 x 3 double matrix, flat."""
    m = np.asarray(m, np.float64)
    det = (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
           - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
           + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))
    if det == 0:
        raise ValueError('warp_perspective: singular matrix')
    d = 1.0 / det
    return np.array([
        (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) * d,
        (m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]) * d,
        (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * d,
        (m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]) * d,
        (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * d,
        (m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]) * d,
        (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]) * d,
        (m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]) * d,
        (m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]) * d])


# --------------------------------------------------------------- warping
# the columns of one step of OpenCV's vector loop (two AVX2 registers of
# float32)
WARP_LANES = 16


def fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, as a fused multiply-add. The
    product of two float32 is exact in float64; the sum is rounded to odd
    (TwoSum's error picks the odd neighbour) so that its rounding to
    float32 is the correctly rounded result."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    step = np.isfinite(s) & (err != 0) & even
    s = np.where(step, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)),
                 s)
    return s.astype(np.float32)


def warp_perspective(img, m, dsize):
    """``cv2.warpPerspective(img, m, dsize)``: float32 (H, W, C) ``img``,
    ``m`` the 3 x 3 source-to-destination matrix (inverted inside),
    ``dsize`` (width, height). Returns float32."""
    src = np.asarray(img)
    if src.dtype != np.float32 or src.ndim != 3:
        raise TypeError(f'warp_perspective takes float32 (H, W, C), got '
                        f'{src.dtype} {src.shape}')
    h_src, w_src = src.shape[:2]
    w, h = dsize
    mf = _invert3(m).astype(np.float32)
    xs = np.arange(w, dtype=np.float32)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    # OpenCV maps WARP_LANES columns at a time as M0 x + (M1 y + M2), and
    # the last w % WARP_LANES columns one by one as (M0 x + M1 y) + M2
    vec = np.arange(w)[None, :] < w - w % WARP_LANES

    def mapped(m0, m1, m2):
        return np.where(vec, fma32(m0, xs, ys * m1 + m2),
                        fma32(xs, m0, ys * m1) + m2)

    den = mapped(mf[6], mf[7], mf[8])
    sx = mapped(mf[0], mf[1], mf[2]) / den
    sy = mapped(mf[3], mf[4], mf[5]) / den

    finite = np.isfinite(sx) & np.isfinite(sy)
    fx = np.floor(np.where(finite, sx, 0)).astype(np.float32)
    fy = np.floor(np.where(finite, sy, 0)).astype(np.float32)
    a = np.where(finite, sx - fx, 0).astype(np.float32)[..., None]
    b = np.where(finite, sy - fy, 0).astype(np.float32)[..., None]
    # image corners past 2^30 px are as outside as any
    ix = np.clip(fx, -2 ** 30, 2 ** 30).astype(np.int64)
    iy = np.clip(fy, -2 ** 30, 2 ** 30).astype(np.int64)

    def corner(yy, xx):
        inside = (yy >= 0) & (yy < h_src) & (xx >= 0) & (xx < w_src)
        vals = src[np.clip(yy, 0, h_src - 1), np.clip(xx, 0, w_src - 1)]
        return np.where(inside[..., None], vals, np.float32(0))

    p00, p01 = corner(iy, ix), corner(iy, ix + 1)
    p10, p11 = corner(iy + 1, ix), corner(iy + 1, ix + 1)
    v0 = fma32(a, p01 - p00, p00)
    v1 = fma32(a, p11 - p10, p10)
    out = fma32(b, v1 - v0, v0)
    gone = (~finite | (ix >= w_src) | (ix + 1 < 0) | (iy >= h_src)
            | (iy + 1 < 0))
    out[gone] = 0
    return out


# -------------------------------------------------------------- resizing
def _cubic_taps(n_in, n_out):
    """(indices (n_out, 4), float32 weights (n_out, 4)) of OpenCV's
    INTER_CUBIC along one axis."""
    scale = 1.0 / (n_out / n_in)   # OpenCV inverts its dsize / ssize
    d = np.arange(n_out, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    x = (f - s).astype(np.float32)
    one = np.float32(1)
    a = np.float32(-0.75)
    xp = x + one
    c0 = ((a * xp - np.float32(5) * a) * xp + np.float32(8) * a) * xp \
        - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    omx = one - x
    c2 = ((a + np.float32(2)) * omx - (a + np.float32(3))) * omx * omx + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0,
                  n_in - 1)
    return idx, np.stack([c0, c1, c2, c3], axis=-1).astype(np.float32)


def _sum4(taps, weights):
    """((t0 w0 + t1 w1) + t2 w2) + t3 w3 over the tap axis 1."""
    acc = taps[:, 0] * weights[:, 0]
    for k in range(1, 4):
        acc = acc + taps[:, k] * weights[:, k]
    return acc


def resize_cubic(img, size_wh):
    """``cv2.resize(img, size_wh, interpolation=cv2.INTER_CUBIC)`` on a
    float32 or float64 (H, W, C) image; ``size_wh`` is (width, height)."""
    src = np.asarray(img)
    if src.dtype not in (np.float32, np.float64) or src.ndim != 3:
        raise TypeError(f'resize_cubic takes float32 or float64 (H, W, C), '
                        f'got {src.dtype} {src.shape}')
    w_out, h_out = size_wh
    h, w = src.shape[:2]
    if (w_out, h_out) == (w, h):
        return src.copy()
    ix, ax = _cubic_taps(w, w_out)
    iy, ay = _cubic_taps(h, h_out)
    dt = src.dtype.type
    rows = _sum4(src[:, ix].transpose(1, 2, 0, 3),           # (w_out, 4, h, C)
                 ax.astype(dt)[:, :, None, None])           # -> (w_out, h, C)
    rows = rows.transpose(1, 0, 2)                          # (h, w_out, C)
    out = _sum4(rows[iy], ay.astype(dt)[:, :, None, None])  # (h_out, w_out, C)
    return out.astype(dt)
