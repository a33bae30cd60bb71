"""Losses of stage-3 training.

Counterpart of ``c2matching_tpu/models/losses.py``: the pixel losses with
the weighted, masked reduction (``l1_loss``, ``mse_loss``,
``charbonnier_loss`` and their classes), ``gan_loss`` for the vanilla,
lsgan, wgan and hinge types (``loss_weight`` scales the generator side
only; the ``GANLoss`` class, which no stage-3 step calls, is not ported),
the WGAN-GP ``gradient_penalty_loss`` through
``torch.autograd.grad(..., create_graph=True)``, and ``gram_matrix`` with
``PerceptualLoss`` (criteria l1, l2 and fro; ground-truth features
detached; at world size > 1 the fro norm is the global batch's, through a
differentiable all-reduce of the squares). Tensors are NHWC, as in the
JAX package. ``MaskedTVLoss``, ``PerceptualLossMultiInputs``,
``TextureLoss`` and ``MapLoss`` belong to stages 1-2 and are not ported
yet.
"""
import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel
from .archs.vgg_arch import VGGFeatureExtractor

_REDUCTIONS = ('none', 'mean', 'sum')


def _reduce(loss, weight, reduction):
    """Weighted masked reduction: with an elementwise weight, 'mean'
    divides by the weight sum (a masked mean)."""
    if weight is not None:
        loss = loss * weight
    if reduction == 'none':
        return loss
    if reduction == 'sum':
        return loss.sum()
    if reduction == 'mean':
        if weight is None:
            return loss.mean()
        return loss.sum() / weight.sum().clamp_min(1e-12)
    raise ValueError(f'invalid reduction {reduction}')


def l1_loss(pred, target, weight=None, reduction='mean', loss_weight=1.0):
    return loss_weight * _reduce((pred - target).abs(), weight, reduction)


def mse_loss(pred, target, weight=None, reduction='mean', loss_weight=1.0):
    return loss_weight * _reduce((pred - target) ** 2, weight, reduction)


def charbonnier_loss(pred, target, weight=None, reduction='mean',
                     loss_weight=1.0, eps=1e-12):
    return loss_weight * _reduce(torch.sqrt((pred - target) ** 2 + eps),
                                 weight, reduction)


class _PixelLoss:
    """Callable with the reference's loss-class interface."""

    _fn = None

    def __init__(self, loss_weight=1.0, reduction='mean', **kwargs):
        if reduction not in _REDUCTIONS:
            raise ValueError(f'Unsupported reduction mode: {reduction}. '
                             f'Supported ones are: {list(_REDUCTIONS)}')
        self.loss_weight = loss_weight
        self.reduction = reduction
        self.kwargs = kwargs

    def __call__(self, pred, target, weight=None):
        return type(self)._fn(pred, target, weight=weight,
                              reduction=self.reduction,
                              loss_weight=self.loss_weight, **self.kwargs)


class L1Loss(_PixelLoss):
    _fn = staticmethod(l1_loss)


class MSELoss(_PixelLoss):
    _fn = staticmethod(mse_loss)


class CharbonnierLoss(_PixelLoss):
    _fn = staticmethod(charbonnier_loss)

    def __init__(self, loss_weight=1.0, reduction='mean', eps=1e-12):
        super().__init__(loss_weight, reduction, eps=eps)


PIXEL_LOSSES = {cls.__name__: cls for cls in (L1Loss, MSELoss,
                                              CharbonnierLoss)}


def gan_loss(pred, target_is_real, gan_type='wgan', real_label_val=1.0,
             fake_label_val=0.0, loss_weight=1.0, is_disc=False):
    """GAN loss; ``loss_weight`` scales only the generator-side loss."""
    if gan_type == 'wgan':
        loss = -pred.mean() if target_is_real else pred.mean()
    elif gan_type == 'vanilla':
        target = torch.full_like(
            pred, real_label_val if target_is_real else fake_label_val)
        loss = (pred.clamp_min(0) - pred * target
                + torch.log1p(torch.exp(-pred.abs()))).mean()
    elif gan_type == 'lsgan':
        target = torch.full_like(
            pred, real_label_val if target_is_real else fake_label_val)
        loss = ((pred - target) ** 2).mean()
    elif gan_type == 'hinge':
        if is_disc:
            pred = -pred if target_is_real else pred
            loss = F.relu(1 + pred).mean()
        else:
            loss = -pred.mean()
    else:
        raise NotImplementedError(f'GAN type {gan_type} is not implemented.')
    return loss if is_disc else loss * loss_weight


def gradient_penalty_loss(disc_fn, real_data, fake_data, alpha,
                          loss_weight=1.0):
    """WGAN-GP: D's input gradient at alpha * real + (1 - alpha) * fake,
    ``loss_weight * mean((||grad||_2 - 1)^2)``, the norm as
    sqrt(sum of squares + 1e-24).

    Args:
        disc_fn: x -> score (the caller decides D's mode and whether its
            running statistics may change).
        real_data, fake_data: (B, H, W, C); neither needs a gradient.
        alpha: (B, 1, 1, 1) interpolation coefficients.
    """
    b = real_data.shape[0]
    interpolates = (alpha * real_data.detach()
                    + (1. - alpha) * fake_data.detach()).requires_grad_(True)
    gradients, = torch.autograd.grad(disc_fn(interpolates).sum(),
                                     interpolates, create_graph=True)
    grad_norm = torch.sqrt((gradients.reshape(b, -1) ** 2).sum(1) + 1e-24)
    return loss_weight * ((grad_norm - 1.) ** 2).mean()


def gram_matrix(feat, normalize=True):
    """(B, H, W, C) -> (B, C, C) Gram, normalized by c * h * w."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    gram = torch.einsum('bnc,bnd->bcd', flat, flat)
    if normalize:
        gram = gram / (c * h * w)
    return gram


class PerceptualLoss(nn.Module):
    """VGG feature loss (and an optional Gram style term), criteria l1, l2
    and fro. ``forward(x, gt)`` returns (percep_loss, style_loss), either
    None when its weight is 0. The VGG's parameters are frozen; the JAX
    package draws them from its seeded init, and ``generator`` draws them
    here. Inputs are ImageNet-normalized (``use_input_norm``, the only
    setting ported).

    ``dtype`` (None is float32; a name such as 'bfloat16' as the JAX
    loss's ``perceptual_opt`` hands it) is the VGG's compute dtype: its
    parameters stay float32 and its features come out in ``dtype``. The
    criteria reduce as the JAX loss's ``jnp.mean`` / ``jnp.sum`` do: the
    difference in ``dtype``, the mean or sum accumulated in float32 and
    rounded to ``dtype`` (the fro norm's square root after it), so the
    loss is a ``dtype`` scalar."""

    def __init__(self, layer_weights, vgg_type='vgg19', use_input_norm=True,
                 perceptual_weight=1.0, style_weight=0.0, norm_img=False,
                 criterion='l1', generator=None, dtype=None):
        super().__init__()
        if not use_input_norm:
            raise NotImplementedError('PerceptualLoss: use_input_norm false '
                                      'is not ported')
        if criterion not in ('l1', 'l2', 'fro'):
            raise NotImplementedError(
                f'{criterion} criterion has not been supported.')
        self.layer_weights = dict(layer_weights)
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.norm_img = norm_img
        self.criterion = criterion
        self.vgg = VGGFeatureExtractor(list(self.layer_weights), vgg_type,
                                       generator=generator, dtype=dtype)
        self.vgg.requires_grad_(False)

    def _crit(self, a, b):
        acc = torch.promote_types(a.dtype, torch.float32)
        if self.criterion == 'l1':
            return (a - b).abs().mean(dtype=acc).to(a.dtype)
        if self.criterion == 'l2':
            return ((a - b) ** 2).mean(dtype=acc).to(a.dtype)
        # torch.norm(..., p='fro') over the whole tensor; at world size > 1
        # over the global batch (the squares summed over the ranks, through
        # the differentiable all-reduce, so each rank holds the global norm)
        return torch.sqrt(parallel.all_reduce_sum(
            ((a - b) ** 2).sum(dtype=acc)).to(a.dtype))

    def forward(self, x, gt):
        if self.norm_img:
            x = (x + 1.) * 0.5
            gt = (gt + 1.) * 0.5
        x_features = self.vgg(x)
        with torch.no_grad():
            gt_features = self.vgg(gt.detach())

        percep_loss = None
        if self.perceptual_weight > 0:
            percep_loss = 0.
            for k, w in self.layer_weights.items():
                percep_loss = percep_loss + self._crit(
                    x_features[k], gt_features[k]) * w
            percep_loss = percep_loss * self.perceptual_weight

        style_loss = None
        if self.style_weight > 0:
            style_loss = 0.
            for k, w in self.layer_weights.items():
                style_loss = style_loss + self._crit(
                    gram_matrix(x_features[k]),
                    gram_matrix(gt_features[k])) * w
            style_loss = style_loss * self.style_weight
        return percep_loss, style_loss
