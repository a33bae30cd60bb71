"""PNG codec on the standard library's zlib (no cv2, no PIL).

``decode`` reads what the eval data needs: non-interlaced PNGs of
bit depth 8 (and 1, 2 or 4 for gray and palette images) in every colour
type (gray, RGB, palette, gray + alpha, RGBA), with the five row filters.
It returns a BGR uint8 (H, W, 3) array as ``cv2.imdecode(...,
IMREAD_COLOR)`` does: gray is replicated to three channels and alpha is
dropped. Interlaced and 16-bit files raise ``ValueError``: they are not
guessed at.

``encode`` writes 8-bit RGB PNGs with filter 0 on every row.
"""
import struct
import zlib

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# samples per pixel by colour type: gray, RGB, palette, gray+alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


def _chunks(data):
    """Yield (type, payload) of each chunk after the signature, checking
    each CRC."""
    if data[:8] != SIGNATURE:
        raise ValueError('not a PNG file (bad signature)')
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length or pos + 12 + length > len(data):
            raise ValueError(f'truncated PNG chunk {kind!r}')
        crc, = struct.unpack('>I', data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f'PNG chunk {kind!r}: CRC mismatch')
        yield kind, payload
        if kind == b'IEND':
            return
        pos += 12 + length
    raise ValueError('PNG file ends without an IEND chunk')


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw, height, stride, bpp):
    """Undo the per-row filters of ``raw`` (height rows of 1 + stride
    bytes) into a (height, stride) uint8 array. ``bpp`` is the filter's
    byte distance, the bytes of one pixel rounded up to 1."""
    if len(raw) < height * (stride + 1):
        raise ValueError('PNG image data is shorter than its size says')
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        kind = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:          # Sub: add the byte bpp to the left
            pad = (-stride) % bpp
            cols = np.concatenate([line, np.zeros(pad, np.int32)])
            cur = (np.cumsum(cols.reshape(-1, bpp), axis=0).reshape(-1)
                   [:stride]) & 0xFF
        elif kind == 2:          # Up: add the byte above
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):     # Average, Paeth: each byte needs its left
            ll, pl = line.tolist(), prev.tolist()
            cl = [0] * stride
            for x in range(stride):
                left = cl[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (left + pl[x]) >> 1
                else:
                    pred = _paeth(left, pl[x], pl[x - bpp] if x >= bpp else 0)
                cl[x] = (ll[x] + pred) & 0xFF
            cur = np.asarray(cl, np.int32)
        else:
            raise ValueError(f'PNG row {y}: unknown filter type {kind}')
        out[y] = cur
        prev = cur
    return out


def _unpack_bits(rows, width, depth):
    """(H, stride) packed samples of 1, 2 or 4 bits -> (H, width) uint8,
    the most significant bits first."""
    if depth == 8:
        return rows[:, :width]
    bits = np.unpackbits(rows, axis=1)
    h = rows.shape[0]
    groups = bits.reshape(h, -1, depth)[:, :width]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (groups * weights).sum(axis=-1).astype(np.uint8)


def decode(data):
    """PNG bytes -> BGR uint8 (H, W, 3), as cv2.imdecode(IMREAD_COLOR)."""
    header = None
    palette = None
    idat = []
    for kind, payload in _chunks(bytes(data)):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', payload)
        elif kind == b'PLTE':
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b'IDAT':
            idat.append(payload)
    if header is None:
        raise ValueError('PNG file has no IHDR chunk')
    width, height, depth, color, comp, filt, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color]:
        raise ValueError(f'PNG colour type {color} with bit depth {depth} '
                         'is not valid PNG')
    if depth == 16:
        raise ValueError('16-bit PNG is not supported (8-bit only)')
    if interlace:
        raise ValueError('interlaced (Adam7) PNG is not supported')
    if comp or filt:
        raise ValueError(f'unknown PNG compression {comp} or filter method '
                         f'{filt}')
    channels = _CHANNELS[color]
    stride = (width * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    rows = _unfilter(zlib.decompress(b''.join(idat)), height, stride, bpp)
    samples = _unpack_bits(rows, width * channels, depth).reshape(
        height, width, channels)
    if color == 3:
        if palette is None:
            raise ValueError('palette PNG without a PLTE chunk')
        if int(samples.max(initial=0)) >= len(palette):
            raise ValueError('PNG palette index past the end of PLTE')
        rgb = palette[samples[..., 0]]
    elif color in (0, 4):
        gray = samples[..., 0]
        if depth < 8:            # scale to 8 bits as libpng does
            gray = (gray.astype(np.uint16) * 255 // ((1 << depth) - 1)) \
                .astype(np.uint8)
        rgb = np.repeat(gray[..., None], 3, axis=-1)
    else:
        rgb = samples[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def _chunk(kind, payload):
    return (struct.pack('>I', len(payload)) + kind + payload
            + struct.pack('>I', zlib.crc32(kind + payload)))


def encode(img):
    """An 8-bit RGB PNG of a BGR uint8 (H, W, 3) image (cv2.imwrite's
    channel order)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'PNG encode takes uint8 (H, W, 3), got {img.dtype} '
                         f'{img.shape}')
    height, width = img.shape[:2]
    rows = np.ascontiguousarray(img[..., ::-1]).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    return (SIGNATURE
            + _chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8, 2, 0,
                                          0, 0))
            + _chunk(b'IDAT', zlib.compress(raw.tobytes(), 6))
            + _chunk(b'IEND', b''))
