"""Reference-based restoration model, eval half.

Counterpart of the inference and validation path of
``c2matching_tpu/models/ref_restoration_model.py``: the three nets come
from the options' ``network_g`` / ``network_map`` / ``network_extractor``
blocks with a random init seeded from ``manual_seed``, then the
``path.pretrain_model_*`` weights; ``feed_data`` pads a batch to the
16-LR-pixel bucket, ``test`` runs ContrasExtractorSep ->
CorrespondenceGenerationArch -> RestorationNet, ``cropped_output`` crops
the result back and warns on exploding offsets, and ``validation`` scores
PSNR, PSNR_Y and SSIM_Y over a loader. Training is not ported yet.
"""
import logging

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import metrics, tensor2img
from .archs.vgg_arch import NAMES
from .base_model import load_state_dict_file
from .networks import define_network
from .sr_model import SRModel

logger = logging.getLogger('base')


def _pad_to(x, mult):
    """Zero-pad NHWC bottom/right up to a multiple of ``mult``."""
    h, w = x.shape[1:3]
    return F.pad(x, (0, 0, 0, (-w) % mult, 0, (-h) % mult))


def torchvision_vgg_keys(state, vgg_type, names):
    """The ``vgg.vgg_net.{name}.*`` entries of a torchvision VGG state dict
    (``features.{i}.*``, i the layer's index in NAMES[vgg_type]) for the
    conv layers in ``names``."""
    out = {}
    for idx, name in enumerate(NAMES[vgg_type]):
        if name in names and name.startswith('conv'):
            for leaf in ('weight', 'bias'):
                key = f'features.{idx}.{leaf}'
                if key in state:
                    out[f'vgg.vgg_net.{name}.{leaf}'] = state[key]
    return out


class RefRestorationModel(SRModel):
    """Eval model built from an options dict shaped like the YAML test
    configs (``network_g``, ``network_map``, ``network_extractor``, and
    optionally ``path``, ``manual_seed``, ``crop_border``).

    Args:
        opt: the options dict.
        device: where the nets run: the CUDA card unless the caller asks
            for another device ('cpu' for the tests). Raises when it names
            a CUDA device on a host without one.
        generator: torch.Generator for the random init; by default one
            seeded with ``opt['manual_seed']`` (0 when unset).
    """

    EVAL_BUCKET = 16  # LR-space bucket multiple (64 px in HR space)

    _VAL_METRIC_LABELS = {'psnr': 'PSNR', 'psnr_y': 'PSNR_Y',
                          'ssim_y': 'SSIM_Y'}
    _VAL_LOG_PER_IMAGE = True

    def __init__(self, opt, device='cuda', generator=None):
        super().__init__(opt, device)
        if generator is None:
            generator = torch.Generator().manual_seed(
                opt.get('manual_seed') or 0)
        self.net_g = define_network(opt['network_g'], generator)
        self.net_map = define_network(opt['network_map'], generator)
        self.net_extractor = define_network(opt['network_extractor'],
                                            generator)
        self._load_pretrained(opt.get('path') or {})
        for net in (self.net_g, self.net_map, self.net_extractor):
            net.to(self.device).eval().requires_grad_(False)
        self.batch = None
        self.output = None
        self._eval_crop = None
        self._valid_lr = None
        self._offset_warn_stats = {}

    def _load_pretrained(self, path_opt):
        """``pretrain_model_g`` into net_g, ``pretrain_model_feature_
        extractor`` into net_extractor, and ``pretrain_model_vgg`` (a
        torchvision VGG state dict) into net_map's VGG."""
        strict = path_opt.get('strict_load', True) is not False
        for key, net in (('pretrain_model_g', self.net_g),
                         ('pretrain_model_feature_extractor',
                          self.net_extractor)):
            if path_opt.get(key):
                self.load_network(net, path_opt[key], strict)
        if path_opt.get('pretrain_model_vgg'):
            path = path_opt['pretrain_model_vgg']
            logger.info(f'Loading torchvision VGG into net_map from {path}.')
            vgg = self.net_map.vgg
            state = torchvision_vgg_keys(
                load_state_dict_file(path),
                self.opt['network_map'].get('vgg_type') or 'vgg19',
                vgg.names)
            missing = [k for k, _ in self.net_map.named_parameters()
                       if k not in state]
            if missing and strict:
                raise KeyError(f'{path}: no weights for {missing}')
            # the ImageNet mean/std buffers are not in a torchvision file
            self.load_state(self.net_map, state, strict=False)

    def feed_data(self, batch):
        """Move a batch to the device, bucket-padded.

        ``batch`` holds NHWC float arrays or tensors: 'img_in_lq' (B, h, w, 3),
        'img_in_up' and 'img_ref' (B, 4h, 4w, 3). When (h, w) is off the
        bucket, all three are zero-padded bottom/right and the valid sizes
        are kept, so the nets mask the pad bands and ``cropped_output``
        crops back to (4h, 4w). Other keys, such as the loader's 'img_in',
        'padding', 'original_size' and 'lq_path', are not read here.
        """
        arrays = {k: torch.as_tensor(batch[k], dtype=torch.float32)
                  for k in ('img_in_lq', 'img_ref', 'img_in_up')}
        self._eval_crop = None
        self._valid_lr = None
        bucket = self.EVAL_BUCKET
        h, w = arrays['img_in_lq'].shape[1:3]
        if h % bucket or w % bucket:
            arrays['img_in_lq'] = _pad_to(arrays['img_in_lq'], bucket)
            arrays['img_ref'] = _pad_to(arrays['img_ref'], 4 * bucket)
            arrays['img_in_up'] = _pad_to(arrays['img_in_up'], 4 * bucket)
            self._eval_crop = (4 * h, 4 * w)
            self._valid_lr = (h, w)
        self.batch = {k: v.to(self.device) for k, v in arrays.items()}

    @torch.inference_mode()
    def test(self):
        """Match, then restore; ``self.output`` is the padded (B, 4H, 4W, 3)
        result."""
        vs_lr = self._valid_lr
        vs_hr = None if vs_lr is None else (4 * vs_lr[0], 4 * vs_lr[1])
        feats = self.net_extractor(self.batch['img_in_up'],
                                   self.batch['img_ref'], vs_hr)
        pre_offset, ref_feat = self.net_map(feats, self.batch['img_ref'],
                                            vs_hr)
        self.output = self.net_g(self.batch['img_in_lq'], pre_offset,
                                 ref_feat, vs_lr)
        self._offset_warn_stats = self.net_g.dyn_agg_restore.offset_stats()

    def cropped_output(self):
        """The last output cropped to the request's own size. Warns when a
        DynAgg's mean |learned offset| exceeds 100, as the reference does;
        reading those values waits for the device, after the output."""
        for v in self._offset_warn_stats.values():
            v = float(v)
            if v > 100:
                logger.warning(f'Offset mean is {v}, larger than 100.')
        if self._eval_crop is None:
            return self.output
        return self.output[:, :self._eval_crop[0], :self._eval_crop[1]]

    def _compute_val_metrics(self, sr_img, gt_img):
        crop = self.opt['crop_border']
        sr_y = metrics.bgr2ycbcr(sr_img / 255., only_y=True) * 255
        gt_y = metrics.bgr2ycbcr(gt_img / 255., only_y=True) * 255
        return {
            'psnr': metrics.psnr(sr_img, gt_img, crop_border=crop),
            'psnr_y': metrics.psnr(sr_y, gt_y, crop_border=crop),
            'ssim_y': metrics.ssim(sr_y, gt_y, crop_border=crop),
        }

    def _validation_images(self, val_data):
        """(sr_img, gt_img) of one batch-1 loader item: the bucket crop,
        then, when the dataset padded input and ref to a common size, both
        cropped to the input's original size."""
        self.feed_data(val_data)
        self.test()
        sr_img = tensor2img(self.cropped_output())
        gt_img = tensor2img(np.asarray(val_data['img_in']))
        padding = val_data.get('padding')
        if padding is not None and bool(np.asarray(padding).reshape(-1)[0]):
            orig = val_data['original_size']
            if isinstance(orig, list):
                orig = orig[0]
            sr_img = sr_img[:int(orig[0]), :int(orig[1])]
            gt_img = gt_img[:int(orig[0]), :int(orig[1])]
        return sr_img, gt_img
