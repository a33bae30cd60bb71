"""Reference-based restoration model, eval half.

Counterpart of the inference path of
``c2matching_tpu/models/ref_restoration_model.py``: ``feed_data`` pads a
batch to the 16-LR-pixel bucket, ``test`` runs ContrasExtractorSep ->
CorrespondenceGenerationArch -> RestorationNet, and ``cropped_output``
crops the result back and warns on exploding offsets. Training is not
ported yet.
"""
import logging

import torch
import torch.nn.functional as F

from .archs import ARCHS

logger = logging.getLogger('base')

# network-block keys that only tune XLA compilation in the JAX package
_XLA_ONLY_KEYS = ('trunk_unroll',)


def define_network(opt_net, generator=None):
    """Instantiate the net a YAML-style block names: {'type': ..., kwargs}.
    None-valued keys are dropped, as the JAX package's factory does."""
    opt_net = dict(opt_net)
    cls = ARCHS[opt_net.pop('type')]
    kwargs = {k: v for k, v in opt_net.items()
              if v is not None and k not in _XLA_ONLY_KEYS}
    return cls(**kwargs, generator=generator)


def _pad_to(x, mult):
    """Zero-pad NHWC bottom/right up to a multiple of ``mult``."""
    h, w = x.shape[1:3]
    return F.pad(x, (0, 0, 0, (-w) % mult, 0, (-h) % mult))


class RefRestorationModel:
    """Eval model built from an options dict shaped like the YAML test
    configs (``network_g``, ``network_map``, ``network_extractor``).

    Args:
        opt: the options dict.
        device: where the nets run.
        generator: torch.Generator for the random init (pretrained weights
            are loaded afterwards with ``load_state_dict``).
    """

    EVAL_BUCKET = 16  # LR-space bucket multiple (64 px in HR space)

    def __init__(self, opt, device='cpu', generator=None):
        self.opt = opt
        self.device = torch.device(device)
        self.net_g = define_network(opt['network_g'], generator)
        self.net_map = define_network(opt['network_map'], generator)
        self.net_extractor = define_network(opt['network_extractor'],
                                            generator)
        for net in (self.net_g, self.net_map, self.net_extractor):
            net.to(self.device).eval().requires_grad_(False)
        self.batch = None
        self.output = None
        self._eval_crop = None
        self._valid_lr = None
        self._offset_warn_stats = {}

    def feed_data(self, batch):
        """Move a batch to the device, bucket-padded.

        ``batch`` holds NHWC float arrays or tensors: 'img_in_lq' (B, h, w, 3),
        'img_in_up' and 'img_ref' (B, 4h, 4w, 3). When (h, w) is off the
        bucket, all three are zero-padded bottom/right and the valid sizes
        are kept, so the nets mask the pad bands and ``cropped_output``
        crops back to (4h, 4w).
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
