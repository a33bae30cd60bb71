"""Plain PyTorch reference of C2-Matching's stage-3 nets (NCHW, float32).

Written from the published architecture (github.com/yumingj/C2-Matching,
``mmsr/models/archs``) and independent of the package under test: it
imports nothing of it and calls no custom kernel. Weights are a flat dict
keyed by the upstream state-dict names (``vgg_net.conv1_1.weight`` ...),
which the benchmark draws from its seed and hands to both sides.

``Precision`` says in which precision each kind of operation rounds its
operands; the default is float32 throughout. The benchmark runs the
reference with TF32 off (``exact_float32``), so float32 here is float32.
A lower ``Precision`` is the control that the comparison must reject.
"""
import contextlib
from dataclasses import dataclass

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VGG19 = ['conv1_1', 'relu1_1', 'conv1_2', 'relu1_2', 'pool1', 'conv2_1',
         'relu2_1', 'conv2_2', 'relu2_2', 'pool2', 'conv3_1', 'relu3_1',
         'conv3_2', 'relu3_2', 'conv3_3', 'relu3_3', 'conv3_4', 'relu3_4',
         'pool3', 'conv4_1', 'relu4_1', 'conv4_2', 'relu4_2', 'conv4_3',
         'relu4_3', 'conv4_4', 'relu4_4', 'pool4', 'conv5_1', 'relu5_1']
# the contrastive extractor: VGG16 up to conv3_1, before its ReLU
VGG16_TO_CONV3_1 = ['conv1_1', 'relu1_1', 'conv1_2', 'relu1_2', 'pool1',
                    'conv2_1', 'relu2_1', 'conv2_2', 'relu2_2', 'pool2',
                    'conv3_1']
VGG_CHANNELS = {1: 64, 2: 128, 3: 256, 4: 512, 5: 512}
# (scale name, VGG layer of the reference feature, its channels)
SCALES = (('small', 'relu3_1', 256), ('medium', 'relu2_1', 128),
          ('large', 'relu1_1', 64))
TAPS = 9


@dataclass(frozen=True)
class Precision:
    """Operand precision by kind: ``conv`` for every convolution and the
    pixel-wise matrix products, ``match`` for the correlation's operands,
    ``gather`` for the deformable conv's sampled feature, columns and
    weight. Each is 'float32', 'tfloat32', 'bfloat16' or 'float8'."""
    conv: str = 'float32'
    match: str = 'float32'
    gather: str = 'float32'


FLOAT32 = Precision()


def rnd(x, kind):
    """``x`` rounded to ``kind`` and returned in float32; the gradient
    passes the rounding unchanged. float8 is e4m3 with one scale for the
    tensor (its largest magnitude at 224)."""
    if kind == 'float32':
        return x.float()
    x = x.float()
    with torch.no_grad():
        if kind == 'bfloat16':
            r = x.to(torch.bfloat16).float()
        elif kind == 'tfloat32':    # 10 mantissa bits, to nearest even
            bits = x.contiguous().view(torch.int32)
            bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
            r = bits.view(torch.float32)
        elif kind == 'float8':
            scale = x.abs().amax().clamp_min(1e-30) / 224.0
            r = (x / scale).to(torch.float8_e4m3fn).float() * scale
        else:
            raise ValueError(f'unknown precision {kind!r}')
    return x + (r - x).detach() if x.requires_grad else r


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN and matmul while the reference runs."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def conv(x, w, b, prec, stride=1):
    """Same-padded convolution with operands in ``prec.conv``."""
    pad = w.shape[-1] // 2
    if prec.conv == 'float32':
        return F.conv2d(x, w, b, stride=stride, padding=pad)
    return F.conv2d(rnd(x, prec.conv), rnd(w, prec.conv),
                    None if b is None else rnd(b, prec.conv),
                    stride=stride, padding=pad)


def lrelu(x, slope=0.1):
    return torch.where(x >= 0, x, x * slope)


def vgg(x, weights, prefix, names, prec, wanted=None):
    """Run the VGG layer sequence ``names`` on NCHW ``x`` in [0, 1],
    ImageNet-normalised first. Returns {layer: activation} of ``wanted``,
    or the last activation."""
    mean = x.new_tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
    std = x.new_tensor(IMAGENET_STD).view(1, 3, 1, 1)
    x = (x - mean) / std
    out = {}
    for name in names:
        if name.startswith('conv'):
            x = conv(x, weights[f'{prefix}{name}.weight'],
                     weights[f'{prefix}{name}.bias'], prec)
        elif name.startswith('relu'):
            x = F.relu(x)
        else:
            x = F.max_pool2d(x, 2, 2)
        if wanted is not None and name in wanted:
            out[name] = x
    return x if wanted is None else out


def vgg_param_shapes(prefix, names):
    shapes, cin = {}, 3
    for name in names:
        if name.startswith('conv'):
            cout = VGG_CHANNELS[int(name[4])]
            shapes[f'{prefix}{name}.weight'] = (cout, cin, 3, 3)
            shapes[f'{prefix}{name}.bias'] = (cout,)
            cin = cout
    return shapes


# ------------------------------------------------------------ extractor
EXTRACTOR_BRANCHES = ('feature_extraction_image1', 'feature_extraction_image2')


def extractor(img_up, img_ref, weights, prec):
    """ContrasExtractorSep: two unshared VGG16 prefixes to conv3_1."""
    return tuple(vgg(img, weights, f'net_extractor.{branch}.model.',
                     VGG16_TO_CONV3_1, prec)
                 for img, branch in zip((img_up, img_ref),
                                        EXTRACTOR_BRANCHES))


# -------------------------------------------------------------- matcher
def _descriptors(feat):
    """(C, H, W) -> (L, 9C) 3x3 patch descriptors of the per-pixel
    L2-normalised feature, L = (H-2)(W-2) in row-major order."""
    feat = feat / feat.norm(dim=0, keepdim=True).clamp_min(1e-12)
    return F.unfold(feat[None], 3)[0].t()


class Match:
    """The dense 3x3 patch match of one image pair: each input patch's
    cosine score against every reference patch (the reference patch
    L2-normalised with +1e-5 on its norm, the score divided by the input
    patch's norm + 1e-5). ``best()`` gives the first maximum;
    ``gap(idx)`` how far the scores of the chosen ``idx`` lie below it."""

    def __init__(self, feat_in, feat_ref, prec=FLOAT32, chunk=2048):
        q = _descriptors(feat_in)
        r = _descriptors(feat_ref)
        r = r / (r.norm(dim=1, keepdim=True) + 1e-5)
        self.q_norm = q.norm(dim=1) + 1e-5
        self.q = rnd(q, prec.match)
        self.r = rnd(r, prec.match)
        self.shape = (feat_in.shape[1] - 2, feat_in.shape[2] - 2)
        self.chunk = chunk

    def _scores(self):
        for start in range(0, self.q.shape[0], self.chunk):
            rows = slice(start, start + self.chunk)
            yield rows, self.q[rows] @ self.r.t()

    def best(self):
        vals, idx = [], []
        for rows, s in self._scores():
            v, i = s.max(dim=1)
            vals.append(v / self.q_norm[rows])
            idx.append(i)
        return torch.cat(vals), torch.cat(idx)

    def gap(self, idx):
        """Per query, best score minus the score of ``idx`` (L,), both
        divided by the query's norm; an index off the grid reads inf."""
        out = []
        n_ref = self.r.shape[0]
        for rows, s in self._scores():
            pick = idx[rows].long()
            ok = (pick >= 0) & (pick < n_ref)
            chosen = s.gather(1, pick.clamp(0, n_ref - 1)[:, None])[:, 0]
            gap = (s.max(dim=1).values - chosen) / self.q_norm[rows]
            out.append(torch.where(ok, gap, torch.full_like(gap,
                                                            float('inf'))))
        return torch.cat(out)


def pre_offsets(idx, shape):
    """Match indices (h*w,) on an h x w query grid (relu3 scale, h = H-2)
    -> {layer: (9, 2[x, y], H_s, W_s)} candidate offsets: the relative
    flow, zero-padded by 2 at the bottom and right, its copies shifted
    down/right by (i, j) * step, nearest-upsampled x2 and x4 with the
    values scaled for relu2_1 and relu1_1."""
    h, w = shape
    idx = idx.long().view(h, w)
    gy = torch.arange(h, device=idx.device)[:, None]
    gx = torch.arange(w, device=idx.device)[None, :]
    flow = torch.stack([(idx % w - gx).float(), (idx // w - gy).float()])
    flow = F.pad(flow, (0, 2, 0, 2))
    out = {}
    for key, f in (('relu3_1', 1), ('relu2_1', 2), ('relu1_1', 4)):
        up = flow if f == 1 else flow.repeat_interleave(
            f, 1).repeat_interleave(f, 2) * f
        hs, ws = up.shape[1:]
        cands = []
        for i in range(3):
            for j in range(3):
                sh, sw = i * f, j * f
                cands.append(F.pad(up, (sw, 0, sh, 0))[:, :hs, :ws])
        out[key] = torch.stack(cands)
    return out


# ------------------------------------------------- deformable conv, DynAgg
def modulated_deform_conv(x, offset, mask, weight, bias, prec, groups):
    """DCNv2 of one image, 3x3, stride 1, padding 1: for output pixel
    (y, x) and tap (ky, kx) of group g, the feature is sampled bilinearly
    at (y - 1 + ky + dy, x - 1 + kx + dx), zero outside the image and zero
    unless -1 < sample < size, times the mask, then contracted with the
    weight.

    x: (C, H, W); offset: (G, 9, 2[dy, dx], H, W); mask: (G, 9, H, W);
    weight: (Co, C, 3, 3). The sampled feature, the columns and the weight
    round to ``prec.gather``."""
    c, h, w = x.shape
    cg = c // groups
    xg = rnd(x, prec.gather).reshape(groups, cg, h * w)
    base_y = torch.arange(h, device=x.device, dtype=torch.float32)[:, None]
    base_x = torch.arange(w, device=x.device, dtype=torch.float32)[None, :]
    cols = []
    for t in range(TAPS):
        sy = base_y - 1 + t // 3 + offset[:, t, 0]            # (G, H, W)
        sx = base_x - 1 + t % 3 + offset[:, t, 1]
        inside = (sy > -1) & (sy < h) & (sx > -1) & (sx < w)
        y0 = torch.floor(sy)
        x0 = torch.floor(sx)
        fy, fx = sy - y0, sx - x0
        y0 = y0.clamp(-2, h).long()
        x0 = x0.clamp(-2, w).long()
        val = 0
        for dy in (0, 1):
            for dx in (0, 1):
                yy, xx = y0 + dy, x0 + dx
                wgt = (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
                inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                flat = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))
                picked = torch.gather(
                    xg, 2, flat.reshape(groups, 1, h * w).expand(
                        groups, cg, h * w))
                val = val + picked * (wgt * inb).reshape(groups, 1, h * w)
        val = val * (inside * mask[:, t]).reshape(groups, 1, h * w)
        cols.append(rnd(val.reshape(c, h * w), prec.gather))
    cols = torch.stack(cols, dim=1).reshape(c * TAPS, h * w)
    out = rnd(weight, prec.gather).reshape(weight.shape[0], -1) @ cols
    out = out.reshape(-1, h, w)
    return out if bias is None else out + bias[:, None, None]


def dyn_agg(ref, offset_feat, pre, weights, prefix, prec, groups):
    """DynAgg of one image: the learned offsets and mask from
    ``conv_offset_mask`` (channels (g, tap, [dy, dx]) then the mask's
    (g, tap)), plus the match's candidate offsets (9, 2[x, y], H, W) for
    every group. ref, offset_feat: (C, H, W), (C', H, W)."""
    out = conv(offset_feat[None], weights[f'{prefix}conv_offset_mask.weight'],
               weights[f'{prefix}conv_offset_mask.bias'], prec)[0]
    g, h, w = groups, out.shape[1], out.shape[2]
    offset = out[:2 * g * TAPS].reshape(g, TAPS, 2, h, w)
    mask = torch.sigmoid(out[2 * g * TAPS:]).reshape(g, TAPS, h, w)
    offset = offset + pre.flip(1)[None]
    return modulated_deform_conv(ref, offset, mask,
                                 weights[f'{prefix}weight'],
                                 weights[f'{prefix}bias'], prec, groups)


# ----------------------------------------------------------- restoration
def _res_blocks(x, weights, prefix, n_blocks, prec):
    for i in range(n_blocks):
        p = f'{prefix}{i}.'
        h = F.relu(conv(x, weights[f'{p}conv1.weight'],
                        weights[f'{p}conv1.bias'], prec))
        x = x + conv(h, weights[f'{p}conv2.weight'],
                     weights[f'{p}conv2.bias'], prec)
    return x


def _conv_w(weights, name, x, prec):
    return conv(x, weights[f'{name}.weight'], weights[f'{name}.bias'], prec)


def restoration(lr, pre, ref_feats, weights, prec, n_blocks, groups,
                taps=None):
    """RestorationNet on one image. lr: (1, 3, h, w); pre: {layer: (9, 2,
    H_s, W_s)}; ref_feats: {layer: (1, C_s, H_s, W_s)}. Returns (1, 3, 4h,
    4w); ``taps``, a dict, receives each DynAgg's output under its
    layer."""
    g = 'net_g.'
    base = F.interpolate(lr, scale_factor=4, mode='bilinear',
                         align_corners=False)
    x = lrelu(_conv_w(weights, f'{g}content_extractor.conv_first', lr, prec))
    x = _res_blocks(x, weights, f'{g}content_extractor.body.', n_blocks,
                    prec)
    d = f'{g}dyn_agg_restore.'
    for scale, key, _ in SCALES:
        ref = ref_feats[key]
        off = lrelu(_conv_w(weights, f'{d}{scale}_offset_conv1',
                            torch.cat([x, ref], 1), prec))
        off = lrelu(_conv_w(weights, f'{d}{scale}_offset_conv2', off, prec))
        swapped = dyn_agg(ref[0], off[0], pre[key], weights,
                          f'{d}{scale}_dyn_agg.', prec, groups)[None]
        if taps is not None:
            taps[key] = swapped
        swapped = lrelu(swapped)
        h = lrelu(_conv_w(weights, f'{d}head_{scale}.0',
                          torch.cat([x, swapped], 1), prec))
        h = _res_blocks(h, weights, f'{d}body_{scale}.', n_blocks, prec) + x
        if scale == 'large':
            h = lrelu(_conv_w(weights, f'{d}tail_large.0', h, prec))
            return _conv_w(weights, f'{d}tail_large.2', h, prec) + base
        x = lrelu(F.pixel_shuffle(
            _conv_w(weights, f'{d}tail_{scale}.0', h, prec), 2))


def restoration_param_shapes(ngf, n_blocks, groups):
    shapes = {}

    def conv_(name, cin, cout):
        shapes[f'net_g.{name}.weight'] = (cout, cin, 3, 3)
        shapes[f'net_g.{name}.bias'] = (cout,)

    def blocks(prefix):
        for i in range(n_blocks):
            conv_(f'{prefix}{i}.conv1', ngf, ngf)
            conv_(f'{prefix}{i}.conv2', ngf, ngf)

    conv_('content_extractor.conv_first', 3, ngf)
    blocks('content_extractor.body.')
    d = 'dyn_agg_restore.'
    for scale, _, ch in SCALES:
        conv_(f'{d}{scale}_offset_conv1', ngf + ch, ch)
        conv_(f'{d}{scale}_offset_conv2', ch, ch)
        conv_(f'{d}{scale}_dyn_agg.conv_offset_mask', ch, 3 * groups * TAPS)
        conv_(f'{d}{scale}_dyn_agg', ch, ch)
        conv_(f'{d}head_{scale}.0', ngf + ch, ngf)
        blocks(f'{d}body_{scale}.')
    conv_(f'{d}tail_small.0', ngf, 4 * ngf)
    conv_(f'{d}tail_medium.0', ngf, 4 * ngf)
    conv_(f'{d}tail_large.0', ngf, ngf // 2)
    conv_(f'{d}tail_large.2', ngf // 2, 3)
    # the DCN's own weight and bias are ``{scale}_dyn_agg.weight/.bias``
    return shapes


# ---------------------------------------------------------- serving path
def serve_image(lq, up, ref_img, weights, net, prec=FLOAT32,
                match_idx=None):
    """The whole eval forward of one request at its exact size.

    lq (1, 3, h, w), up and ref_img (1, 3, 4h, 4w). ``match_idx``: where
    given, the match indices the restoration follows (a judged program's),
    else the reference's own. Returns a dict: 'features' (the extractor's
    two), 'ref_feats', 'match' (the ``Match``), 'idx', 'taps' (DynAgg
    outputs by layer) and 'output' (1, 3, 4h, 4w)."""
    f_in, f_ref = extractor(up, ref_img, weights, prec)
    match = Match(f_in[0], f_ref[0], prec)
    idx = match.best()[1] if match_idx is None else match_idx
    ref_feats = vgg(ref_img, weights, 'net_map.vgg.vgg_net.', VGG19[:12],
                    prec, wanted={'relu1_1', 'relu2_1', 'relu3_1'})
    taps = {}
    out = restoration(lq, pre_offsets(idx, match.shape), ref_feats, weights,
                      prec, net['n_blocks'], net['groups'], taps)
    return {'features': (f_in, f_ref), 'ref_feats': ref_feats,
            'match': match, 'idx': idx, 'taps': taps, 'output': out}


def serving_param_shapes(net):
    """{name: shape} of every weight of the serving nets."""
    shapes = {}
    for branch in EXTRACTOR_BRANCHES:
        shapes.update(vgg_param_shapes(f'net_extractor.{branch}.model.',
                                       VGG16_TO_CONV3_1))
    shapes.update(vgg_param_shapes('net_map.vgg.vgg_net.', VGG19[:12]))
    shapes.update(restoration_param_shapes(net['ngf'], net['n_blocks'],
                                           net['groups']))
    return shapes
