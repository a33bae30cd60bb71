"""Losses of every training stage.

Counterpart of ``c2matching_tpu/models/losses.py``. Tensors are NHWC, as
in the JAX package.

- The pixel losses with the weighted, masked reduction (``l1_loss``,
  ``mse_loss``, ``charbonnier_loss`` and their classes) and
  ``MaskedTVLoss``, the L1 of neighbouring pixels' differences under an
  optional mask.
- ``gan_loss`` (and its class ``GANLoss``) for the vanilla, lsgan, wgan
  and hinge types (``loss_weight`` scales the generator side only).
- The WGAN-GP ``gradient_penalty_loss`` through
  ``torch.autograd.grad(..., create_graph=True)``, and its class
  ``GradientPenaltyLoss``, which draws the interpolation coefficients from
  a ``torch.Generator`` where the JAX package takes a key.
- ``gram_matrix`` and the VGG losses: ``PerceptualLoss`` (criteria l1, l2
  and fro; ground-truth features detached; at world size > 1 the fro norm
  is the global batch's, through a differentiable all-reduce of the
  squares) and ``PerceptualLossMultiInputs`` over (B, N, H, W, C) stacks;
  SRNTT's Gram ``TextureLoss``; ``MapLoss`` between swapped features and
  the ground truth's VGG features. Each VGG is frozen; the JAX package
  draws it from its seeded init, and ``generator`` draws it here (or a
  torchvision state dict loads, ``utils/weights.py``).
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


class MaskedTVLoss(L1Loss):
    """Total variation: the L1 of vertical and of horizontal neighbours'
    differences, each a masked mean under ``mask`` (B, H, W, 1) when
    given."""

    def __init__(self, loss_weight=1.0):
        super().__init__(loss_weight=loss_weight)

    def __call__(self, pred, mask=None):
        y_diff = super().__call__(pred[:, :-1], pred[:, 1:],
                                  weight=None if mask is None
                                  else mask[:, :-1])
        x_diff = super().__call__(pred[:, :, :-1], pred[:, :, 1:],
                                  weight=None if mask is None
                                  else mask[:, :, :-1])
        return x_diff + y_diff


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


class GANLoss:
    """``gan_loss`` with its type, labels and weight fixed."""

    def __init__(self, gan_type, real_label_val=1.0, fake_label_val=0.0,
                 loss_weight=1.0):
        self.gan_type = gan_type
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val
        self.loss_weight = loss_weight

    def __call__(self, pred, target_is_real, is_disc=False):
        return gan_loss(pred, target_is_real, self.gan_type,
                        self.real_label_val, self.fake_label_val,
                        self.loss_weight, is_disc)


class GradientPenaltyLoss:
    """``gradient_penalty_loss`` with its weight fixed; the coefficients
    are ``alpha`` when given, else drawn uniform in [0, 1) per sample by
    ``generator`` on the CPU (so that the card and the CPU draw the same)
    and moved to the data's device."""

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, disc_fn, real_data, fake_data, generator=None,
                 alpha=None):
        if alpha is None:
            alpha = torch.rand((real_data.shape[0], 1, 1, 1),
                               generator=generator).to(real_data)
        return gradient_penalty_loss(disc_fn, real_data, fake_data, alpha,
                                     self.loss_weight)


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
    here. ``use_input_norm``: the VGG ImageNet-normalizes its inputs.

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
        if criterion not in ('l1', 'l2', 'fro'):
            raise NotImplementedError(
                f'{criterion} criterion has not been supported.')
        self.layer_weights = dict(layer_weights)
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.norm_img = norm_img
        self.criterion = criterion
        self.vgg = VGGFeatureExtractor(list(self.layer_weights), vgg_type,
                                       use_input_norm=use_input_norm,
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


class PerceptualLossMultiInputs(PerceptualLoss):
    """``PerceptualLoss`` over (B, N, H, W, C) stacks of images: the terms
    of the N pairs (x[:, i], gt[:, i]) summed."""

    def forward(self, x, gt):
        if x.shape != gt.shape:
            raise ValueError('The sizes of input and GT should be the same.')
        total_percep, total_style = 0., 0.
        for i in range(x.shape[1]):
            percep, style = super().forward(x[:, i], gt[:, i])
            total_percep = None if percep is None else total_percep + percep
            total_style = None if style is None else total_style + style
        return total_percep, total_style


# the Gram normalisers of TextureLoss by layer
_TEXTURE_DIV = {'relu3_1': 256, 'relu2_1': 512, 'relu1_1': 1024}


class TextureLoss(nn.Module):
    """SRNTT's texture loss: per VGG layer the Frobenius distance of the
    unnormalised Grams of x's features and of ``maps``' (the swapped
    features), / 4 / (W^2 div)^2 with W the input's width and div 1024,
    512 and 256 at relu1/2/3; the mean over the three layers times
    ``loss_weight``. ``use_weights``: both features are first scaled by
    sigmoid(-20 w + 0.65) of the layer's ``weights`` (B, H-2, W-2, 1),
    edge-padded by one pixel."""

    def __init__(self, use_weights=False, loss_weight=1.0, vgg_type='vgg19',
                 layer_weights=None, use_input_norm=True, generator=None,
                 dtype=None):
        super().__init__()
        self.use_weights = use_weights
        self.loss_weight = loss_weight
        layer_weights = layer_weights or {
            'relu1_1': 1.0, 'relu2_1': 1.0, 'relu3_1': 1.0}
        self.vgg = VGGFeatureExtractor(list(layer_weights), vgg_type,
                                       use_input_norm=use_input_norm,
                                       generator=generator, dtype=dtype)
        self.vgg.requires_grad_(False)

    def forward(self, x, maps, weights=None):
        input_size = x.shape[2]
        x_features = self.vgg(x)
        losses = 0.
        for k, xf in x_features.items():
            mf = maps[k]
            if self.use_weights and weights is not None:
                w = F.pad(weights[k].permute(0, 3, 1, 2), (1, 1, 1, 1),
                          mode='replicate').permute(0, 2, 3, 1)
                coeff = torch.sigmoid(w * -20. + .65)
                mf = mf * coeff
                xf = xf * coeff
            diff = (gram_matrix(xf, normalize=False)
                    - gram_matrix(mf, normalize=False))
            losses = losses + torch.sqrt((diff ** 2).sum()) / 4. / (
                (input_size * input_size * _TEXTURE_DIV[k]) ** 2)
        return losses / 3. * self.loss_weight


class MapLoss(nn.Module):
    """The l1 / l2 / fro distance between swapped features (relu3/2/1_1)
    and the ground truth's VGG features (detached), summed over the layers,
    times ``map_weight``."""

    def __init__(self, vgg_type='vgg19', map_weight=1.0, criterion='l1',
                 generator=None, dtype=None):
        super().__init__()
        if criterion not in ('l1', 'l2', 'fro'):
            raise NotImplementedError(criterion)
        self.map_weight = map_weight
        self.criterion = criterion
        self.vgg = VGGFeatureExtractor(['relu3_1', 'relu2_1', 'relu1_1'],
                                       vgg_type, generator=generator,
                                       dtype=dtype)
        self.vgg.requires_grad_(False)

    def forward(self, swapped_features, gt):
        with torch.no_grad():
            gt_features = self.vgg(gt.detach())
        map_loss = 0.
        for k, gf in gt_features.items():
            diff = swapped_features[k] - gf
            if self.criterion == 'l1':
                map_loss = map_loss + diff.abs().mean()
            elif self.criterion == 'l2':
                map_loss = map_loss + (diff ** 2).mean()
            else:
                map_loss = map_loss + torch.sqrt((diff ** 2).sum())
        return map_loss * self.map_weight
