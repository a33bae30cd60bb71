"""Baseline JPEG decoder in numpy, without cv2 or PIL.

Decodes what ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` decodes through
libjpeg-turbo, with the same pixels: sequential Huffman-coded 8-bit files
(SOF0 / SOF1), gray or three-component, at any sampling factors (4:4:4,
4:2:2, 4:2:0, 4:4:0 and the other integer ratios), interleaved or not,
with restart markers, at any size. It follows libjpeg-turbo's defaults,
which cv2 keeps:

- the ISLOW integer inverse DCT (``jidctint.c``), its range limit
  included;
- fancy upsampling of the chroma (``jdsample.c``: the triangle filters of
  h2v1, h1v2 and h2v2, the edge sample repeated at the component's own
  width and height; plain replication for other ratios, and for h2v1 and
  h2v2 where the chroma is at most 2 samples wide);
- the integer YCbCr -> RGB conversion (``jdcolor.c``, 16 fraction bits);
  three components are RGB as they are where an Adobe marker says so or
  their ids are 'R', 'G', 'B'.

The result is BGR uint8 (H, W, 3), a gray file's value in all three,
turned by the EXIF orientation tag where the file carries one, as cv2's
``ExifTransform`` turns it. Progressive, arithmetic-coded, lossless,
hierarchical and 12-bit files and four-component (CMYK) ones raise a
``ValueError`` that names the mode.

The Huffman decoding is a Python loop over the coefficients; the inverse
DCT, the upsampling and the colour conversion are numpy over the whole
image.
"""
import numpy as np

MAGIC = b'\xff\xd8\xff'

# the zig-zag order: ZIGZAG[k] is the natural (row-major) index of the
# k-th coefficient of a block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
    43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63])
# the natural index of each zig-zag position, padded with 63 as libjpeg's
# jpeg_natural_order is, so that a corrupt run past the block stays inside
_NATURAL = list(ZIGZAG) + [63] * 16

_MODES = {0xC2: 'progressive', 0xC3: 'lossless', 0xC5: 'hierarchical',
          0xC6: 'hierarchical progressive', 0xC7: 'hierarchical lossless',
          0xC9: 'arithmetic-coded', 0xCA: 'arithmetic-coded progressive',
          0xCB: 'arithmetic-coded lossless',
          0xCD: 'arithmetic-coded hierarchical',
          0xCE: 'arithmetic-coded hierarchical progressive',
          0xCF: 'arithmetic-coded hierarchical lossless'}


def _huffman_lookup(counts, symbols):
    """A Huffman table as a 16-bit lookup: ``lookup[peek]`` is
    (symbol << 5) | code length, 0 for a code the table lacks."""
    lookup = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            span = 1 << (16 - length)
            lookup[code * span:(code + 1) * span] = (symbols[k] << 5) | length
            code += 1
            k += 1
        code <<= 1
    return lookup.tolist()


def _segments(data):
    """(marker, payload) of each marker segment up to EOI; a scan's
    (SOS) payload is (its header, its entropy-coded bytes)."""
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f'JPEG: no marker at byte {pos}')
        while pos < n and data[pos] == 0xFF:     # fill bytes
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:                       # EOI
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise ValueError('JPEG: truncated marker segment')
        length = (data[pos] << 8) | data[pos + 1]
        payload = data[pos + 2:pos + length]
        if len(payload) != length - 2:
            raise ValueError('JPEG: truncated marker segment')
        pos += length
        if marker != 0xDA:
            yield marker, payload
            continue
        # the scan's entropy-coded data runs to the next marker that is
        # neither a stuffed 0xFF00 nor a restart marker
        end = pos
        while True:
            end = data.find(b'\xff', end)
            if end < 0 or end + 1 >= n:
                end = n
                break
            nxt = data[end + 1]
            if nxt == 0x00 or 0xD0 <= nxt <= 0xD7:
                end += 2
                continue
            if nxt == 0xFF:                      # fill byte before a marker
                end += 1
                continue
            break
        yield marker, (payload, data[pos:end])
        pos = end
    raise ValueError('JPEG: no EOI marker')


class _Bits:
    """MSB-first bit reader over one restart interval's unstuffed bytes;
    past the end it reads zeros, as libjpeg does."""

    def __init__(self, data):
        self.data = data.replace(b'\xff\x00', b'\xff') + b'\x00' * 4
        self.pos = 0

    def peek16(self):
        d = self.data
        b = self.pos >> 3
        if b + 3 > len(d):
            return 0
        v = (d[b] << 16) | (d[b + 1] << 8) | d[b + 2]
        return (v >> (8 - (self.pos & 7))) & 0xFFFF

    def decode(self, table):
        entry = table[self.peek16()]
        if not entry:
            raise ValueError('JPEG: bad Huffman code')
        self.pos += entry & 31
        return entry >> 5

    def receive_extend(self, s):
        """The s-bit value that follows, sign-extended as JPEG's
        EXTEND."""
        if s == 0:
            return 0
        v = self.peek16() >> (16 - s)
        self.pos += s
        return v if v >= 1 << (s - 1) else v - (1 << s) + 1


def _decode_scan(header, entropy, frame, huff, restart):
    comps = frame['comps']
    ns = header[0]
    scan = []
    for i in range(ns):
        cid, tables = header[1 + 2 * i], header[2 + 2 * i]
        comp = next((c for c in comps if c['id'] == cid), None)
        if comp is None:
            raise ValueError(f'JPEG: scan names component {cid}, which the '
                             'frame lacks')
        scan.append((comp, huff[(0, tables >> 4)], huff[(1, tables & 15)]))
    ss, se, ahal = header[1 + 2 * ns:4 + 2 * ns]
    if ss != 0 or se != 63 or ahal != 0:
        raise ValueError('JPEG: spectral selection in a sequential scan')
    if ns == 1:
        comp = scan[0][0]
        mcus_x = -(-comp['width'] // 8)
        mcus_y = -(-comp['height'] // 8)
        layout = [(scan[0], 0, 0)]
    else:
        mcus_x, mcus_y = frame['mcus_x'], frame['mcus_y']
        layout = [(s, dy, dx) for s in scan
                  for dy in range(s[0]['v']) for dx in range(s[0]['h'])]
    # the restart intervals' data, split at the RSTn markers
    parts, start, pos = [], 0, 0
    while True:
        pos = entropy.find(b'\xff', pos)
        if pos < 0 or pos + 1 >= len(entropy):
            break
        if 0xD0 <= entropy[pos + 1] <= 0xD7:
            parts.append(entropy[start:pos])
            start = pos + 2
        pos += 2
    parts.append(entropy[start:])
    total = mcus_x * mcus_y
    bits = _Bits(parts[0])
    part = 0
    preds = {}
    for m in range(total):
        if restart and m and m % restart == 0:
            part += 1
            bits = _Bits(parts[part] if part < len(parts) else b'')
            preds = {}
        my, mx = divmod(m, mcus_x)
        for (comp, dc, ac), dy, dx in layout:
            if ns == 1:
                by, bx = my, mx
            else:
                by, bx = my * comp['v'] + dy, mx * comp['h'] + dx
            coef = [0] * 64
            s = bits.decode(dc)
            pred = preds.get(comp['id'], 0) + bits.receive_extend(s)
            preds[comp['id']] = pred
            coef[0] = pred
            k = 1
            while k < 64:
                rs = bits.decode(ac)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    coef[_NATURAL[k]] = bits.receive_extend(s)
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
            comp['coefs'][by, bx] = coef


# ISLOW constants (jidctint.c), 13 fraction bits
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(d, shift, out_scale):
    """One pass of jpeg_idct_islow along the last axis of ``d`` (int64,
    8 entries): the even and odd parts, then DESCALE by ``shift`` bits.
    ``out_scale`` is the left shift of the DC terms (CONST_BITS)."""
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (d[..., 0] + d[..., 4]) << out_scale
    tmp1 = (d[..., 0] - d[..., 4]) << out_scale
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0 = t0 * _F0298
    t1 = t1 * _F2053
    t2 = t2 * _F3072
    t3 = t3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([(v + half) >> shift for v in out], axis=-1)


def idct_islow(coefs, qtable):
    """Dequantize and inverse-DCT blocks (..., 64), natural order, as
    libjpeg-turbo's jpeg_idct_islow: uint8 samples (..., 8, 8)."""
    d = coefs.astype(np.int64).reshape(*coefs.shape[:-1], 8, 8) \
        * np.asarray(qtable, np.int64).reshape(8, 8)
    # pass 1 down the columns, pass 2 along the rows
    ws = _idct_1d(np.swapaxes(d, -1, -2), _CONST_BITS - _PASS1_BITS,
                  _CONST_BITS)
    ws = np.swapaxes(ws, -1, -2)
    out = _idct_1d(ws, _CONST_BITS + _PASS1_BITS + 3, _CONST_BITS)
    # the range limit: the low 10 bits as a signed value, +128, clamped
    idx = out & 1023
    signed = np.where(idx < 512, idx, idx - 1024)
    return np.clip(signed + 128, 0, 255).astype(np.uint8)


def _edge(a, axis, before, after):
    """``a`` with its first / last entry along ``axis`` repeated."""
    return np.concatenate(
        [np.take(a, [0], axis)] * before + [a]
        + [np.take(a, [a.shape[axis] - 1], axis)] * after, axis=axis)


def _h2v1_fancy(x):
    x = x.astype(np.int32)
    p = _edge(x, 1, 1, 1)
    near = 3 * x
    left = (near + p[:, :-2] + 1) >> 2
    right = (near + p[:, 2:] + 2) >> 2
    return np.stack([left, right], axis=2).reshape(x.shape[0], -1)


def _h1v2_fancy(x):
    x = x.astype(np.int32)
    p = _edge(x, 0, 1, 1)
    near = 3 * x
    upper = (near + p[:-2] + 1) >> 2
    lower = (near + p[2:] + 2) >> 2
    return np.stack([upper, lower], axis=1).reshape(-1, x.shape[1])


def _h2v2_fancy(x):
    x = x.astype(np.int32)
    p = _edge(x, 0, 1, 1)
    rows = []
    for far in (p[:-2], p[2:]):                 # the row above, then below
        colsum = 3 * x + far
        c = _edge(colsum, 1, 1, 1)
        left = (3 * colsum + c[:, :-2] + 8) >> 4
        right = (3 * colsum + c[:, 2:] + 7) >> 4
        rows.append(np.stack([left, right], axis=2).reshape(x.shape[0], -1))
    return np.stack(rows, axis=1).reshape(2 * x.shape[0], -1)


def _upsample(x, fy, fx):
    """A component's samples (its own height and width) upsampled by
    (fy, fx) as libjpeg-turbo's jinit_upsampler picks the method."""
    if (fy, fx) == (1, 1):
        return x
    w = x.shape[1]
    if (fy, fx) == (1, 2) and w > 2:
        return _h2v1_fancy(x)
    if (fy, fx) == (2, 1):
        return _h1v2_fancy(x)
    if (fy, fx) == (2, 2) and w > 2:
        return _h2v2_fancy(x)
    return x.repeat(fy, 0).repeat(fx, 1)


def _ycc_to_rgb(y, cb, cr):
    """jdcolor.c's ycc_rgb_convert: 16-bit fixed point, clamped."""
    def fix(v):
        return int(v * (1 << 16) + 0.5)
    half = 1 << 15
    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb + half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return [np.clip(c, 0, 255).astype(np.uint8) for c in (r, g, b)]


def _frame(marker, payload):
    if marker in _MODES:
        raise ValueError(f'JPEG: {_MODES[marker]} files are not decoded '
                         '(baseline and extended sequential Huffman only)')
    precision = payload[0]
    if precision != 8:
        raise ValueError(f'JPEG: {precision}-bit samples are not decoded '
                         '(8-bit only)')
    height = (payload[1] << 8) | payload[2]
    width = (payload[3] << 8) | payload[4]
    n = payload[5]
    if height == 0 or width == 0:
        raise ValueError('JPEG: a zero height (DNL) or width is not decoded')
    if n not in (1, 3):
        raise ValueError(f'JPEG: {n}-component files are not decoded (gray '
                         'and three-component only)')
    comps = []
    for i in range(n):
        cid, hv, tq = payload[6 + 3 * i:9 + 3 * i]
        comps.append({'id': cid, 'h': hv >> 4, 'v': hv & 15, 'tq': tq})
    if n == 1:                  # one component is never subsampled
        comps[0]['h'] = comps[0]['v'] = 1
    hmax = max(c['h'] for c in comps)
    vmax = max(c['v'] for c in comps)
    mcus_x = -(-width // (8 * hmax))
    mcus_y = -(-height // (8 * vmax))
    for c in comps:
        c['width'] = -(-width * c['h'] // hmax)
        c['height'] = -(-height * c['v'] // vmax)
        c['coefs'] = np.zeros((mcus_y * c['v'], mcus_x * c['h'], 64),
                              np.int32)
    return {'width': width, 'height': height, 'comps': comps,
            'hmax': hmax, 'vmax': vmax, 'mcus_x': mcus_x, 'mcus_y': mcus_y}


def exif_orientation(payload):
    """The orientation (1-8) of an APP1 ``Exif`` payload's first IFD, 1
    where it has none or cannot be read."""
    tiff = payload[6:]
    if payload[:6] != b'Exif\x00\x00' or len(tiff) < 8 \
            or tiff[:2] not in (b'II', b'MM'):
        return 1
    order = 'little' if tiff[:2] == b'II' else 'big'

    def num(at, n):
        return int.from_bytes(tiff[at:at + n], order)

    ifd = num(4, 4)
    if ifd + 2 > len(tiff):
        return 1
    for i in range(num(ifd, 2)):
        entry = ifd + 2 + 12 * i
        if entry + 12 > len(tiff):
            break
        if num(entry, 2) == 0x0112 and num(entry + 2, 2) == 3:  # SHORT
            value = num(entry + 8, 2)
            return value if 1 <= value <= 8 else 1
    return 1


def _orient(img, orientation):
    """cv2's ExifTransform: flips and transposes by the EXIF
    orientation."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode(content):
    """BGR uint8 (H, W, 3) of a baseline JPEG's bytes, as
    ``cv2.imdecode(..., cv2.IMREAD_COLOR)`` gives it (see the module
    docstring for what raises)."""
    data = bytes(content)
    if data[:3] != MAGIC:
        raise ValueError('JPEG: no SOI marker')
    qtables, huff = {}, {}
    frame = None
    restart = 0
    adobe_transform = None
    jfif = False
    orientation = 1
    scanned = False
    for marker, payload in _segments(data):
        if marker == 0xDB:                                  # DQT
            pos = 0
            while pos < len(payload):
                pq, tq = payload[pos] >> 4, payload[pos] & 15
                if pq:
                    vals = np.frombuffer(payload[pos + 1:pos + 129], '>u2')
                    pos += 129
                else:
                    vals = np.frombuffer(payload[pos + 1:pos + 65], np.uint8)
                    pos += 65
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                qtables[tq] = table
        elif marker == 0xC4:                                # DHT
            pos = 0
            while pos < len(payload):
                tc, th = payload[pos] >> 4, payload[pos] & 15
                counts = list(payload[pos + 1:pos + 17])
                symbols = list(payload[pos + 17:pos + 17 + sum(counts)])
                huff[(tc, th)] = _huffman_lookup(counts, symbols)
                pos += 17 + sum(counts)
        elif marker == 0xDD:                                # DRI
            restart = (payload[0] << 8) | payload[1]
        elif marker == 0xE0 and payload[:5] == b'JFIF\x00':
            jfif = True
        elif marker == 0xE1 and orientation == 1:
            orientation = exif_orientation(payload)
        elif marker == 0xEE and payload[:5] == b'Adobe' and len(payload) > 11:
            adobe_transform = payload[11]
        elif marker == 0xCC:
            raise ValueError('JPEG: arithmetic-coded files are not decoded')
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8):
            if frame is not None:
                raise ValueError('JPEG: more than one frame')
            frame = _frame(marker, payload)
        elif marker == 0xDA:                                # SOS
            if frame is None:
                raise ValueError('JPEG: a scan before the frame header')
            header, entropy = payload
            for i in range(header[0]):
                comp = next((c for c in frame['comps']
                             if c['id'] == header[1 + 2 * i]), None)
                if comp is not None and 'q' not in comp:
                    if comp['tq'] not in qtables:
                        raise ValueError('JPEG: a component\'s quantization '
                                         'table is missing')
                    comp['q'] = qtables[comp['tq']]
            try:
                _decode_scan(header, entropy, frame, huff, restart)
            except KeyError as exc:
                raise ValueError('JPEG: a scan names a missing Huffman '
                                 'table') from exc
            scanned = True
    if not scanned:
        raise ValueError('JPEG: no scan')
    planes = []
    for c in frame['comps']:
        if 'q' not in c:
            raise ValueError(f'JPEG: component {c["id"]} has no scan')
        blocks = idct_islow(c['coefs'], c['q'])            # (by, bx, 8, 8)
        by, bx = blocks.shape[:2]
        plane = blocks.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        plane = plane[:c['height'], :c['width']]
        plane = _upsample(plane, frame['vmax'] // c['v'],
                          frame['hmax'] // c['h'])
        planes.append(plane[:frame['height'], :frame['width']])
    if len(planes) == 1:
        return _orient(np.repeat(planes[0][..., None], 3, axis=2),
                       orientation)
    ids = tuple(c['id'] for c in frame['comps'])
    # libjpeg's guess of the colour space: JFIF is YCbCr, then an Adobe
    # marker's transform, then the component ids
    rgb = not jfif and (adobe_transform == 0 if adobe_transform is not None
                        else ids == (82, 71, 66))
    if rgb:
        r, g, b = planes
    else:
        r, g, b = _ycc_to_rgb(*planes)
    return _orient(np.stack([b, g, r], axis=-1), orientation)
