"""Architecture building blocks (NHWC in and out).

Counterpart of ``c2matching_tpu/models/archs/arch_util.py``. Modules take
and return NHWC tensors; their convolutions run in cuDNN on the
``permute(0, 3, 1, 2)`` view, which is free and already in channels_last
memory order. Parameters carry the reference's torch state-dict names.

``dtype`` is the compute dtype of the convolutions, as the JAX package's
``dtype`` field on every network block: parameters stay float32, and each
conv casts its input, weight and bias to it (None is float32).

``band`` (a ``parallel.Band``, None for the whole image): the input holds
one rank's horizontal band of the image (``val_spatial_shard``); each
conv takes one row from each neighbouring band first.

A conv's epilogue (``act``: None, 'relu' or 'lrelu'; ``residual``, added
last) runs as the unfused ops where an autograd graph is recorded, and
otherwise in place in one pass (``ops.conv_epilogue``) after a
convolution without a bias, with the same values.

Initializers (``kaiming_scaled_init``, ``srntt_normal_init``) are
functions ``init(weight, generator)`` that fill an OIHW weight in place:
the reference's residual-block init (kaiming-normal, fan in, times a
scale) and the srntt init (normal(0, gain)) that RestorationNet's blocks
take.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ... import parallel
from ...ops.conv_epilogue import ACTS, DTYPES, conv_epilogue
from ...ops.patch_match import as_dtype
from ...ops.resize import pixel_shuffle
from ...parallel.spatial import exchange_halo


def kaiming_scaled_init(scale=0.1):
    """kaiming-normal (fan in, gain sqrt(2)) times ``scale``: the
    reference's residual-block weight init."""

    def init(weight, generator=None):
        std = math.sqrt(2.0 / weight[0].numel()) * scale
        with torch.no_grad():
            return weight.normal_(0.0, std, generator=generator)

    return init


def srntt_normal_init(gain=0.02):
    """normal(0, ``gain``): the srntt init of RestorationNet's blocks."""

    def init(weight, generator=None):
        with torch.no_grad():
            return weight.normal_(0.0, gain, generator=generator)

    return init


def conv_nhwc(x, weight, bias, band=None):
    """3x3, stride-1, same-padded convolution of NHWC ``x`` by an OIHW
    ``weight``; with a ``band`` the neighbours' rows (zeros past the image)
    take the place of the vertical zero padding. ``x`` is made contiguous
    first (no copy for an NHWC tensor), so that the conv runs channels-last
    and its output is contiguous NHWC whatever view ``x`` was."""
    padding = 1
    if band is not None:
        x = exchange_halo(x, band, 1, 1)
        padding = (0, 1)
    x = x.contiguous()
    if 1 in x.shape:
        # a size-1 dimension may carry any stride, which makes cuDNN and
        # oneDNN read a contiguous batch of one as NCHW: the canonical ones
        x = x.view(-1).view(x.shape)
    return F.conv2d(x.permute(0, 3, 1, 2), weight, bias,
                    padding=padding).permute(0, 2, 3, 1)


def unfused_epilogue(out, act=None, residual=None):
    """``act(out) [+ residual]`` as separate ops (the epilogue wherever a
    graph is recorded)."""
    if act not in ACTS:
        raise ValueError(f'act {act!r} is none of {list(ACTS)}')
    if act == 'relu':
        out = F.relu(out)
    elif act == 'lrelu':
        out = lrelu(out)
    return out if residual is None else residual + out


class Conv2d(nn.Conv2d):
    """3x3, stride-1, same-padded convolution on NHWC tensors, computed in
    ``compute_dtype`` (float32 unless given) from float32 parameters, with
    its epilogue ``act(conv + bias) [+ residual]``.

    Where autograd would record a graph (grad mode on and x, the weight,
    the bias or the residual requiring grad), or the compute dtype is one
    the kernel does not take (float64), the conv adds its bias and the
    epilogue runs as separate ops; otherwise cuDNN runs the conv without a
    bias and ``conv_epilogue`` applies bias, activation and residual in
    place in one pass, with the same values. A residual of another dtype
    than the compute dtype is added after it, promoting as ``residual +
    out`` does. ``fused_epilogues`` and ``graph_epilogues`` count, over
    every instance, the forwards of each path."""

    fused_epilogues = 0
    graph_epilogues = 0

    def __init__(self, in_channels, out_channels, device=None,
                 compute_dtype=None):
        super().__init__(in_channels, out_channels, 3, padding=1,
                         device=device)
        self.compute_dtype = as_dtype(compute_dtype) or torch.float32

    def forward(self, x, band=None, act=None, residual=None):
        dt = self.compute_dtype
        x, weight, bias = x.to(dt), self.weight.to(dt), self.bias.to(dt)
        if dt not in DTYPES or torch.is_grad_enabled() and (
                x.requires_grad or weight.requires_grad or bias.requires_grad
                or (residual is not None and residual.requires_grad)):
            Conv2d.graph_epilogues += 1
            return unfused_epilogue(conv_nhwc(x, weight, bias, band), act,
                                    residual)
        Conv2d.fused_epilogues += 1
        out = conv_nhwc(x, weight, None, band)
        if residual is not None and residual.dtype != dt:
            return residual + conv_epilogue(out, bias, act)
        return conv_epilogue(out, bias, act, residual)


def conv(in_channels, out_channels, generator=None, std=0.02, dtype=None,
         init=None):
    """A 3x3 ``Conv2d`` computing in ``dtype``, with weights drawn from
    normal(0, std) by ``generator`` (std 0 gives zeros) and a zero bias.
    ``std=None`` draws He-normal weights, normal(0, sqrt(2 / fan_in)).
    ``init`` (an ``init(weight, generator)``) draws them instead of
    ``std``."""
    layer = skip_init(Conv2d, in_channels, out_channels, compute_dtype=dtype)
    if std is None:
        std = math.sqrt(2.0 / (in_channels * 9))
    with torch.no_grad():
        if init is not None:
            init(layer.weight, generator)
        elif std:
            layer.weight.normal_(0.0, std, generator=generator)
        else:
            layer.weight.zero_()
        layer.bias.zero_()
    return layer


def _l2_normalize(x, eps=1e-12):
    return x / (torch.linalg.vector_norm(x) + eps)


class SpectralNormConv(nn.Module):
    """3x3 conv with spectral normalization: the weight divided by its
    largest singular value sigma, estimated by ``n_power_iterations`` of
    power iteration on the stored pair ``weight_u`` (O,) / ``weight_v``
    (I*9,) of the (O, I*9) weight matrix (torch's ``spectral_norm`` names:
    ``weight_orig``, ``weight_u``, ``weight_v``). As in the JAX package,
    the iteration runs, and the pair is stored, only when the module is
    training (``n_power_iterations=0`` reuses the stored pair); eval
    touches neither; sigma takes no gradient. With ``sn_bias`` the bias is
    divided by its exact sigma, ||b||_2 (+1e-12), also without a gradient.
    Computes in ``dtype`` from float32 parameters; its epilogue (``act``,
    ``residual``) is always the separate ops."""

    def __init__(self, in_channels, out_channels, generator=None, init=None,
                 n_power_iterations=1, sn_bias=True, dtype=None):
        super().__init__()
        self.n_power_iterations = n_power_iterations
        self.sn_bias = sn_bias
        self.compute_dtype = as_dtype(dtype) or torch.float32
        self.weight_orig = nn.Parameter(
            torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        (init or kaiming_scaled_init(0.1))(self.weight_orig, generator)
        with torch.no_grad():
            u = _l2_normalize(torch.randn(out_channels, generator=generator))
            v = _l2_normalize(self.weight_orig.reshape(out_channels, -1).t()
                              @ u)
        self.register_buffer('weight_u', u)
        self.register_buffer('weight_v', v)

    def forward(self, x, band=None, act=None, residual=None):
        w_mat = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        if self.training:
            with torch.no_grad():
                for _ in range(self.n_power_iterations):
                    v = _l2_normalize(w_mat.t() @ u)
                    u = _l2_normalize(w_mat @ v)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        sigma = (u @ (w_mat @ v)).detach()
        weight = self.weight_orig / sigma
        bias = self.bias
        if self.sn_bias:
            bias = bias / (torch.linalg.vector_norm(bias) + 1e-12).detach()
        dt = self.compute_dtype
        return unfused_epilogue(
            conv_nhwc(x.to(dt), weight.to(dt), bias.to(dt), band), act,
            residual)


def lrelu(x, slope=0.1):
    """Leaky ReLU whose derivative at exactly 0 is 1, as JAX's
    ``where(x >= 0, x, slope * x)`` gives (torch's ``leaky_relu`` gives
    ``slope`` there); the same values either way, so without a gradient
    the single fused op runs."""
    if x.requires_grad:
        return torch.where(x >= 0, x, x * slope)
    return F.leaky_relu(x, negative_slope=slope)


class ResidualBlockNoBN(nn.Module):
    """Conv-ReLU-Conv residual block without BN, ``x + res_scale * out``.
    At ``res_scale`` 1 the ReLU and the residual add are the convs'
    epilogues.
    Weights from ``init`` (kaiming-normal x 0.1 when None, the reference's
    init of a standalone block; RestorationNet's trunks pass the srntt
    init). ``sn``: spectral-normalized convs (``SpectralNormConv``, with
    ``n_power_iterations`` and ``sn_bias``)."""

    def __init__(self, nf=64, generator=None, dtype=None, res_scale=1.0,
                 init=None, sn=False, n_power_iterations=1, sn_bias=True):
        super().__init__()
        self.res_scale = res_scale
        init = init or kaiming_scaled_init(0.1)
        for name in ('conv1', 'conv2'):
            if sn:
                layer = SpectralNormConv(nf, nf, generator, init,
                                         n_power_iterations, sn_bias, dtype)
            else:
                layer = conv(nf, nf, generator, dtype=dtype, init=init)
            setattr(self, name, layer)

    def forward(self, x, band=None):
        if self.res_scale == 1.0:
            out = self.conv1(x, band, act='relu')
            return self.conv2(out, band, residual=x)
        out = self.conv2(self.conv1(x, band, act='relu'), band)
        return x + out * self.res_scale


class ResBlockStack(nn.ModuleList):
    """n sequential ResidualBlockNoBN (the reference's make_layer), with
    parameters named ``{i}.conv{1,2}.*``, srntt-initialized."""

    def __init__(self, nf=64, n_blocks=16, generator=None, dtype=None):
        super().__init__([ResidualBlockNoBN(nf, generator, dtype,
                                            init=srntt_normal_init())
                          for _ in range(n_blocks)])

    def forward(self, x, band=None):
        for block in self:
            x = block(x, band)
        return x


def _moments(x):
    """(mean, biased variance) per channel of NCHW ``x``, in float32 (or
    float64 for a float64 ``x``): the local batch's at world size 1, the
    global batch's above."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    if parallel.get_world_size() == 1:
        mean = x.mean(dim=(0, 2, 3))
        return mean, ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.)
    c = x.shape[1]
    count = x.new_full((1,), float(x.numel() // c))
    sums = parallel.all_reduce_sum(torch.cat(
        [x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)), count]))
    mean = sums[:c] / sums[-1]
    return mean, (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0.)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over NCHW with the JAX package's arithmetic (flax
    ``nn.BatchNorm``, momentum 0.9, epsilon 1e-5), not torch's: in train
    mode it normalizes by the batch's mean and biased variance, var =
    max(0, E[x^2] - E[x]^2), and moves the running statistics by 0.1
    toward the batch's mean and that same biased variance (torch would
    store the unbiased one); ``forward(x, update_stats=False)`` leaves them
    as they are. In eval mode the running statistics normalize. The
    statistics reduce in float32 and the result is cast to x's dtype. At
    world size > 1 the train-mode statistics are the global batch's,
    through one differentiable all-reduce of the per-channel sums. The
    state dict is torch's."""

    def __init__(self, num_features):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x, update_stats=True):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = _moments(x)
            if update_stats:
                with torch.no_grad():
                    self.running_mean.mul_(1 - self.momentum).add_(
                        self.momentum * mean)
                    self.running_var.mul_(1 - self.momentum).add_(
                        self.momentum * var)
                    self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                + self.bias[None, :, None, None]).to(x.dtype)



class ResidualBlockWithBN(nn.Module):
    """Conv-BN-ReLU-Conv-BN residual block, NHWC, the JAX package's
    BatchNorm (``FlaxBatchNorm2d``; train and eval follow
    ``module.training``); conv weights kaiming-normal, zero biases, BN
    scale 1 and shift 0."""

    def __init__(self, nf=64, generator=None, dtype=None):
        super().__init__()
        init = kaiming_scaled_init(1.0)
        self.conv1 = conv(nf, nf, generator, dtype=dtype, init=init)
        self.bn1 = FlaxBatchNorm2d(nf)
        self.conv2 = conv(nf, nf, generator, dtype=dtype, init=init)
        self.bn2 = FlaxBatchNorm2d(nf)

    def _bn(self, bn, x):
        return bn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, x):
        out = F.relu(self._bn(self.bn1, self.conv1(x)))
        return x + self._bn(self.bn2, self.conv2(out))


class Upsample(nn.Sequential):
    """PixelShuffle upsampler for scales 2^n (n convs nf -> 4nf, each then
    a x2 shuffle) and 3 (one conv nf -> 9nf, a x3 shuffle); any other
    scale raises. NHWC; weights srntt-initialized (normal(0, 0.02)) unless
    ``init`` is given; modules ``{0, 2, ...}`` are the convs, as the
    reference's ``nn.Sequential``."""

    def __init__(self, scale, nf, generator=None, dtype=None, init=None):
        init = init or srntt_normal_init()
        layers = []
        if scale & (scale - 1) == 0:
            for _ in range(int(math.log2(scale))):
                layers += [conv(nf, 4 * nf, generator, dtype=dtype,
                                init=init), _PixelShuffle(2)]
        elif scale == 3:
            layers += [conv(nf, 9 * nf, generator, dtype=dtype, init=init),
                       _PixelShuffle(3)]
        else:
            raise ValueError(f'scale {scale} is not supported. '
                             'Supported scales: 2^n and 3.')
        super().__init__(*layers)


class _PixelShuffle(nn.Module):
    """NHWC depth-to-space as a module."""

    def __init__(self, factor):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        return pixel_shuffle(x, self.factor)


class UpsampleShuffle(nn.Module):
    """conv(nf -> 4nf), x2 pixel shuffle, LeakyReLU(0.1): the
    tail_small / tail_medium stage of RestorationNet (the leaky ReLU is
    the conv's epilogue, before the shuffle: elementwise, the same
    values). NHWC; weights
    srntt-initialized unless ``init`` is given."""

    def __init__(self, nf, generator=None, dtype=None, init=None):
        super().__init__()
        self.conv = conv(nf, 4 * nf, generator, dtype=dtype,
                         init=init or srntt_normal_init())

    def forward(self, x):
        return pixel_shuffle(self.conv(x, act='lrelu'), 2)
