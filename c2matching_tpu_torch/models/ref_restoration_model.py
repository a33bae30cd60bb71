"""Reference-based restoration model (stage 3): evaluation and training.

Counterpart of ``c2matching_tpu/models/ref_restoration_model.py``. The
three nets come from the options' ``network_g`` / ``network_map`` /
``network_extractor`` blocks with a random init seeded from
``manual_seed``, then the ``path.pretrain_model_*`` weights.

Evaluation (``is_train`` false): ``feed_data`` moves a batch to the
device at its own shape, ``test`` runs ContrasExtractorSep ->
CorrespondenceGenerationArch -> RestorationNet on it, ``cropped_output``
returns the result and warns on exploding offsets, and ``validation``
scores PSNR, PSNR_Y and SSIM_Y over a loader. Every op takes any shape,
so a request is never padded (the JAX package pads to a 16-LR-pixel
bucket to bound XLA's compiles).

Training (``is_train`` true; ``init_training_settings``): net_g trains,
the extractor and net_map stay frozen and match under ``no_grad``.
``optimize_parameters(step)`` runs, as the JAX package's steps do:

- up to ``net_g_pretrain_steps``, the G-pretrain step: the pixel loss
  only;
- after it, the GAN iteration: the match, ONE G forward, the D update on
  the detached output (WGAN real/fake and the gradient penalty, whose D
  pass leaves BN's running statistics alone), then the G update (pixel,
  perceptual and GAN-G losses) whose GAN term reads the updated D in train
  mode, with D's parameters frozen so that no gradient reaches them. The
  ``net_d_steps`` / ``net_d_init_steps`` gating is a Python ``do_g``; a
  D-only iteration runs the G forward without a graph and advances G's
  schedule count. Without ``network_d`` (the MSE config) the iteration is
  the G update on its losses.

The optimizers are ``torch.optim.Adam``: G's parameters in four LR groups
by name ('offset' x 'small' / 'medium', the JAX package's
``_offset_lr_tree``), unscheduled unless ``train.schedule_net_g``; D in
one group, scheduled, its count starting at ``net_g_pretrain_steps``. The
gradient-penalty coefficients come from a CPU ``torch.Generator`` seeded
with ``manual_seed`` (so the card and the CPU draw the same), or from
``gp_alpha`` when a caller sets it (used once).

``train.remat_policy`` sets what the GAN iteration's G forward keeps for
its backward, as ``jax.checkpoint`` over the same forward does in the JAX
package (``torch.utils.checkpoint`` with a selective-checkpoint policy;
the D update, whose gradient penalty differentiates twice, stays outside
it; the G-pretrain step keeps its whole graph, as in the JAX package):

- 'none' (the default): the whole graph;
- 'dcn_rows': only the outputs of ``torch.ops.c2matching.deform_im2col``
  (B3's columns, the JAX package's ``checkpoint_name(rows, 'dcn_rows')``);
  the backward recomputes the rest of the forward and takes the columns
  from the saved ones, so B3's forward does not launch again;
- 'dots': the outputs of the convolutions and matrix products
  (``aten.convolution``, ``mm``, ``bmm``, ``addmm``: the counterpart of
  ``dots_with_no_batch_dims_saveable``); the rest, B3 included, is
  recomputed.

The outputs do not depend on the policy. The JAX package defaults to
'dcn_rows' because a 16 GB TPU ran out of memory at batch 9 with the
whole graph; an 80 GB H100 holds it (a GAN iteration at batch 9, gt 160
peaks below 10 GiB), so the port keeps 'none' when the key is unset and
PERF.md lists each policy's peak and step time.

At world size > 1 (``parallel/``) each rank feeds its slice of the global
batch: the nets start from rank 0's weights, every backward is followed
by ``sync_gradients`` (G's and D's gradients averaged over the ranks),
D's BatchNorm takes the global batch's statistics, the gradient-penalty
coefficients are drawn for the global batch and each rank takes its
slice, and ``log_dict`` holds the global batch's values.

The top-level ``val_spatial_shard`` option is read in evaluation only, as
in the JAX package (in training it changes nothing). At world size > 1
each image is then split into horizontal bands, one a rank
(``parallel.band_for``: rank r owns LR rows ``[floor(r h / world),
floor((r + 1) h / world))`` of the LR height h, and 4 times those in HR):
``feed_data`` keeps the rank's band of each input, ``test`` runs the nets
on it, with a halo exchange at every 3x3 conv, the reference's features
gathered whole, and B1 and B3 on the band's rows, then all-gathers the
output along H, so that every rank holds the whole image, and the offset
telemetry is the whole image's mean. Where h does not split into bands of
at least 2 rows every rank computes the whole image (logged). The
validation loop then walks every image on every rank (the collectives
need all of them on one image), and rank 0 alone saves and logs each.

Spans (``utils/trace.py``): ``feed_data`` starts an item (a request or a
step) and each entry point records its phases: ``c2m.feed_data``;
``c2m.test`` with ``c2m.extractor``, ``c2m.matcher``, ``c2m.generator``
(and in it each ``c2m.dynagg.<layer>``); ``c2m.cropped_output``;
``c2m.step`` with ``c2m.match``, ``c2m.g_forward``, ``c2m.d_update``
(``c2m.d_adam`` in it), ``c2m.g_losses``, ``c2m.g_backward`` and
``c2m.g_adam``. Where the host blocks on the device a ``c2m.wait.*``
span opens: ``upload`` (inputs on the host), ``offset_stats`` (the
offset telemetry's read) and ``gp_alpha`` (the penalty's coefficients).
"""
import contextlib
import functools
import logging

import numpy as np
import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import parallel
from ..utils import metrics, tensor2img, trace
from .archs.vgg_arch import NAMES
from .base_model import ScheduleCounts, load_state_dict_file, make_adam
from .losses import PIXEL_LOSSES, PerceptualLoss, gan_loss, \
    gradient_penalty_loss
from .networks import define_network
from .sr_model import SRModel

logger = logging.getLogger('base')
_NO_SPAN = contextlib.nullcontext()


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


# the four LR groups of G, in the order of base_lrs()
G_GROUPS = ('g', 'offset', 'relu3_offset', 'relu2_offset')


def lr_group(name):
    """The LR group of a net_g parameter by its name, as the JAX package
    labels its flax path: 'offset' with 'small' (relu3) or 'medium' (relu2),
    other 'offset' names, and the rest."""
    if 'offset' in name:
        if 'small' in name:
            return 'relu3_offset'
        if 'medium' in name:
            return 'relu2_offset'
        return 'offset'
    return 'g'


def remat_saved_ops(policy):
    """The operators whose outputs the G forward keeps under the
    ``train.remat_policy`` ``policy`` (the rest is recomputed); None for
    'none', which keeps the whole graph."""
    aten = torch.ops.aten
    saved = {'none': None,
             'dcn_rows': [torch.ops.c2matching.deform_im2col.default],
             'dots': [aten.convolution.default, aten.mm.default,
                      aten.bmm.default, aten.addmm.default]}
    if policy not in saved:
        raise ValueError(f'train.remat_policy {policy!r}: expected one of '
                         f'{list(saved)}')
    return saved[policy]


def group_lrs(train_opt):
    """{group: base LR} of G's groups (``_offset_lr_tree``'s defaults)."""
    lr_g = train_opt['lr_g']
    lr_offset = train_opt.get('lr_offset', lr_g) or lr_g
    return {'g': lr_g, 'offset': lr_offset,
            'relu3_offset': train_opt.get('lr_relu3_offset',
                                          lr_offset) or lr_offset,
            'relu2_offset': train_opt.get('lr_relu2_offset',
                                          lr_offset) or lr_offset}


class RefRestorationModel(SRModel):
    """Stage-3 model built from an options dict shaped like the YAML
    configs (``network_g``, ``network_map``, ``network_extractor``, and
    optionally ``path``, ``manual_seed``, ``crop_border``; for training
    ``is_train``, ``train`` and optionally ``network_d``).

    Args:
        opt: the options dict.
        device: where the nets run: the CUDA card unless the caller asks
            for another device ('cpu' for the tests). Raises when it names
            a CUDA device on a host without one.
        generator: torch.Generator for the random init; by default one
            seeded with ``opt['manual_seed']`` (0 when unset).
    """

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
        # batch-1 evaluation in image bands across the ranks (read in
        # evaluation only, as the JAX package does)
        self.spatial = bool(not self.is_train and self.world > 1
                            and opt.get('val_spatial_shard'))
        self._load_pretrained(opt.get('path') or {})
        for net in (self.net_map, self.net_extractor):
            net.to(self.device).eval().requires_grad_(False)
        self.net_g.to(self.device)
        self.batch = None
        self.output = None
        self._band = None
        self._offset_warn_stats = {}
        if self.is_train:
            self.init_training_settings()
        else:
            self.net_g.eval().requires_grad_(False)
        parallel.broadcast_parameters(
            self.net_g, self.net_map, self.net_extractor,
            getattr(self, 'net_d', None), getattr(self, 'cri_perceptual',
                                                  None))

    def _load_pretrained(self, path_opt):
        """``pretrain_model_g`` into net_g, ``pretrain_model_feature_
        extractor`` into net_extractor, and ``pretrain_model_vgg`` (a
        torchvision VGG state dict) into net_map's VGG."""
        strict = path_opt.get('strict_load', True) is not False
        for key, net, kind in (('pretrain_model_g', self.net_g, 'g'),
                               ('pretrain_model_feature_extractor',
                                self.net_extractor, 'extractor')):
            if path_opt.get(key):
                self.load_network(net, path_opt[key], strict, kind)
        if path_opt.get('pretrain_model_vgg'):
            path = path_opt['pretrain_model_vgg']
            logger.info(f'Loading torchvision VGG into net_map from {path}.')
            vgg = self.net_map.vgg
            vgg_type = self.opt['network_map'].get('vgg_type') or 'vgg19'
            state = torchvision_vgg_keys(
                load_state_dict_file(path, vgg_type), vgg_type, vgg.names)
            missing = [k for k, _ in self.net_map.named_parameters()
                       if k not in state]
            if missing and strict:
                raise KeyError(f'{path}: no weights for {missing}')
            # the ImageNet mean/std buffers are not in a torchvision file
            self.load_state(self.net_map, state, strict=False)

    def feed_data(self, batch):
        """Move a batch to the device at its own shape.

        ``batch`` holds NHWC float arrays or tensors: 'img_in_lq' (B, h, w, 3),
        'img_in_up' and 'img_ref' (B, 4h, 4w, 3), and in training the ground
        truth 'img_in' (B, 4h, 4w, 3). Other keys, such as the loader's
        'padding', 'original_size' and 'lq_path', are not read here. With
        ``val_spatial_shard`` at world size > 1 each input keeps the rank's
        band of its rows.
        """
        trace.new_item()
        with trace.span('c2m.feed_data'):
            self._feed(batch)

    def _feed(self, batch):
        keys = ('img_in_lq', 'img_ref', 'img_in_up')
        if self.is_train:
            keys += ('img_in',)
        arrays = {k: torch.as_tensor(batch[k], dtype=torch.float32)
                  for k in keys}
        self._band = self._band_of(arrays) if self.spatial else None
        if self._band is not None:
            hr = self._band.scaled(4)
            arrays = {'img_in_lq': self._band.take(arrays['img_in_lq']),
                      'img_ref': hr.take(arrays['img_ref']),
                      'img_in_up': hr.take(arrays['img_in_up'])}
        # a copy from the host waits for the device's queue
        upload = any(v.device.type != self.device.type
                     for v in arrays.values())
        with trace.span('c2m.wait.upload') if upload else _NO_SPAN:
            self.batch = {k: v.to(self.device) for k, v in arrays.items()}

    def _band_of(self, arrays):
        """This rank's LR band of the inputs, or None where every
        rank computes the whole image: LR rows that do not split into
        bands of 2 or more (``parallel.band_for``, which logs it), or a
        reference whose HR height is not the input's."""
        h = arrays['img_in_lq'].shape[1]
        heights = {arrays[k].shape[1] for k in ('img_ref', 'img_in_up')}
        if heights != {4 * h}:
            logger.warning(f'val_spatial_shard: HR heights {sorted(heights)} '
                           f'are not 4 x the LR {h}; every rank computes '
                           'the whole image')
            return None
        return parallel.band_for(h, self.rank, self.world)

    @torch.inference_mode()
    def test(self):
        """Match, then restore; ``self.output`` is the (B, 4h, 4w, 3)
        result. With a band, each rank computes its band and the output is
        all-gathered: every rank holds the whole image."""
        with trace.span('c2m.test'):
            band = self._band
            hr = None if band is None else band.scaled(4)
            with trace.span('c2m.extractor'):
                feats = self.net_extractor(self.batch['img_in_up'],
                                           self.batch['img_ref'], hr)
            with trace.span('c2m.matcher'):
                pre_offset, ref_feat = self.net_map(
                    feats, self.batch['img_ref'], band)
            with trace.span('c2m.generator'):
                self.output = self.net_g(self.batch['img_in_lq'], pre_offset,
                                         ref_feat, band)
            if band is not None:
                self.output = parallel.gather_rows(self.output, hr)
            self._offset_warn_stats = \
                self.net_g.dyn_agg_restore.offset_stats(
                    reduce=band is not None)

    def cropped_output(self):
        """The last output, at the request's own size. Warns when a
        DynAgg's mean |learned offset| exceeds 100, as the reference does;
        reading those values waits for the device, after the output."""
        with trace.span('c2m.cropped_output'):
            with trace.span('c2m.wait.offset_stats'):
                stats = [float(v) for v in self._offset_warn_stats.values()]
            for v in stats:
                if v > 100:
                    logger.warning(f'Offset mean is {v}, larger than 100.')
            return self.output

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
        """(sr_img, gt_img) of one batch-1 loader item; when the dataset
        padded input and ref to a common size, both cropped to the input's
        original size."""
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

    # ------------------------------------------------------------ training
    def init_training_settings(self):
        """Discriminator, losses, optimizers and schedule counts from the
        options' ``train`` block (and ``network_d``)."""
        train_opt = self.opt['train']
        path_opt = self.opt.get('path') or {}
        self.remat_policy = train_opt.get('remat_policy') or 'none'
        remat_saved_ops(self.remat_policy)      # refuses an unknown name
        self.net_g.train()

        self.net_d = None
        if self.opt.get('network_d'):
            self.net_d = define_network(self.opt['network_d'],
                                        torch.Generator().manual_seed(7))
            if path_opt.get('pretrain_model_d'):
                self.load_network(self.net_d, path_opt['pretrain_model_d'],
                                  path_opt.get('strict_load', True)
                                  is not False, kind='d')
            self.net_d.to(self.device).train()
            self.print_network(self.net_d)
        else:
            logger.info('No discriminator.')

        self.cri_pix = None
        if (train_opt.get('pixel_weight') or 0) > 0:
            self.cri_pix = PIXEL_LOSSES[train_opt['pixel_criterion']](
                loss_weight=train_opt['pixel_weight'], reduction='mean')
        else:
            logger.info('Remove pixel loss.')
        self.cri_perceptual = None
        if train_opt.get('perceptual_opt'):
            self.cri_perceptual = PerceptualLoss(
                **dict(train_opt['perceptual_opt']),
                generator=torch.Generator().manual_seed(11)).to(self.device)
        else:
            logger.info('Remove perceptual loss.')
        self.gan_type = train_opt.get('gan_type')
        self.gan_weight = train_opt.get('gan_weight') or 0
        self.grad_penalty_weight = train_opt.get('grad_penalty_weight') or 0
        if not self.gan_type:
            logger.info('Remove GAN loss.')

        self.net_g_pretrain_steps = train_opt['net_g_pretrain_steps']
        self.net_d_steps = train_opt.get('net_d_steps') or 1
        self.net_d_init_steps = train_opt.get('net_d_init_steps') or 0

        # G: four LR groups, unscheduled unless schedule_net_g (the
        # reference schedules only D in stage 3); D: one, scheduled, its
        # count starting after the G-pretrain phase
        lrs = group_lrs(train_opt)
        named = [(lr_group(n), p) for n, p in self.net_g.named_parameters()]
        self.optimizer_g = make_adam(
            [(k, [p for label, p in named if label == k], lrs[k])
             for k in G_GROUPS],
            betas=train_opt.get('beta_g') or (0.9, 0.999),
            weight_decay=train_opt.get('weight_decay_g') or 0)
        self.schedules = ScheduleCounts(self.schedule_fn)
        self.schedules.add('g', self.optimizer_g,
                           bool(train_opt.get('schedule_net_g')))
        if self.net_d is not None:
            self.optimizer_d = make_adam(
                [('d', self.net_d.parameters(), train_opt['lr_d'])],
                betas=train_opt.get('beta_d') or (0.9, 0.999),
                weight_decay=train_opt.get('weight_decay_d') or 0)
            self.schedules.add('d', self.optimizer_d, True,
                               count=self.net_g_pretrain_steps)
        self.gp_generator = torch.Generator().manual_seed(
            self.opt.get('manual_seed') or 0)
        self.gp_alpha = None
        self.log_dict = {}

    def base_lrs(self):
        t = self.opt['train']
        lrs = [t['lr_g'], t.get('lr_offset', t['lr_g']),
               t.get('lr_relu3_offset', t['lr_g']),
               t.get('lr_relu2_offset', t['lr_g'])]
        if self.net_d is not None:
            lrs.append(t['lr_d'])
        return lrs

    def current_learning_rates(self, step):
        """The LR report of the log line: G's four base LRs (scheduled only
        under ``schedule_net_g``) and D's scheduled LR, at ``step``."""
        out = []
        for i, lr in enumerate(self.base_lrs()):
            scheduled = i >= len(G_GROUPS) or self.schedules.scheduled['g']
            out.append(float(self.schedule_fn(step, lr))
                       if scheduled and self.schedule_fn is not None
                       else float(lr))
        return out

    def optimize_parameters(self, step):
        with trace.span('c2m.step'):
            if step <= self.net_g_pretrain_steps:
                self._pretrain_iteration()
                return
            since = step - self.net_g_pretrain_steps
            do_g = (since % self.net_d_steps == 0
                    and since > self.net_d_init_steps)
            self._gan_iteration(do_g)

    def _match(self):
        with trace.span('c2m.match'), torch.no_grad():
            feats = self.net_extractor(self.batch['img_in_up'],
                                       self.batch['img_ref'])
            return self.net_map(feats, self.batch['img_ref'])

    def _offset_stats(self):
        return self.net_g.dyn_agg_restore.offset_stats()

    def _pretrain_iteration(self):
        pre_offset, ref_feat = self._match()
        with trace.span('c2m.g_forward'):
            self.optimizer_g.zero_grad(set_to_none=True)
            output = self.net_g(self.batch['img_in_lq'], pre_offset,
                                ref_feat)
        with trace.span('c2m.g_losses'):
            l_pix = self.cri_pix(output, self.batch['img_in'])
        with trace.span('c2m.g_backward'):
            l_pix.backward()
            self.sync_gradients(self.net_g.parameters())
        with trace.span('c2m.g_adam'):
            self.schedules.step('g')
        self.output = output.detach()
        self.log_dict = self.global_logs({'l_pix': l_pix.detach(),
                                          **self._offset_stats()})

    def _gan_iteration(self, do_g):
        pre_offset, ref_feat = self._match()
        gt = self.batch['img_in']
        args = (self.batch['img_in_lq'], pre_offset, ref_feat)
        saved = remat_saved_ops(self.remat_policy)
        with trace.span('c2m.g_forward'), torch.set_grad_enabled(do_g):
            if do_g and saved is not None:
                output = checkpoint(
                    self.net_g, *args, use_reentrant=False,
                    context_fn=functools.partial(
                        create_selective_checkpoint_contexts, saved))
            else:
                output = self.net_g(*args)
        self.output = output.detach()
        logs = self._offset_stats()
        if self.net_d is not None:
            with trace.span('c2m.d_update'):
                logs.update(self._d_update(gt, self.output))
        if do_g:
            with trace.span('c2m.g_losses'):
                self.optimizer_g.zero_grad(set_to_none=True)
                total, g_logs = self._out_losses(output, gt)
            with trace.span('c2m.g_backward'):
                total.backward()
                self.sync_gradients(self.net_g.parameters())
            with trace.span('c2m.g_adam'):
                self.schedules.step('g')
            logs.update(g_logs)
        else:
            # a D-only iteration still steps G's schedule
            self.schedules.shift('g')
        self.log_dict = self.global_logs(logs)

    def _next_gp_alpha(self, b):
        """(B, 1, 1, 1) interpolation coefficients: ``gp_alpha`` when set
        (then cleared), else a draw of the CPU generator, for the global
        batch of world x ``b``, of which this rank takes its slice."""
        alpha, self.gp_alpha = self.gp_alpha, None
        if alpha is None:
            alpha = torch.rand((b * self.world, 1, 1, 1),
                               generator=self.gp_generator)
        else:
            alpha = torch.tensor(np.asarray(alpha), dtype=torch.float32)
        if self.world > 1:
            alpha = alpha[self.rank * b:(self.rank + 1) * b]
        # a copy from pageable host memory: the host waits for the device
        with trace.span('c2m.wait.gp_alpha'):
            return alpha.to(self.device)

    def _d_update(self, gt, fake):
        """One D update: WGAN real/fake and the gradient penalty."""
        self.optimizer_d.zero_grad(set_to_none=True)
        real_pred = self.net_d(gt)
        l_d_real = gan_loss(real_pred, True, self.gan_type, is_disc=True)
        fake_pred = self.net_d(fake)
        l_d_fake = gan_loss(fake_pred, False, self.gan_type, is_disc=True)
        total = l_d_real + l_d_fake
        logs = {'l_d_real': l_d_real.detach(), 'l_d_fake': l_d_fake.detach(),
                'out_d_real': real_pred.detach().mean(),
                'out_d_fake': fake_pred.detach().mean()}
        if self.grad_penalty_weight > 0:
            alpha = self._next_gp_alpha(gt.shape[0])
            l_gp = gradient_penalty_loss(
                lambda x: self.net_d(x, update_stats=False), gt, fake, alpha,
                loss_weight=self.grad_penalty_weight)
            total = total + l_gp
            logs['l_grad_penalty'] = l_gp.detach()
        total.backward()
        self.sync_gradients(self.net_d.parameters())
        with trace.span('c2m.d_adam'):
            self.schedules.step('d')
        return logs

    def _out_losses(self, output, gt):
        """G's losses on its output: pixel, perceptual (and style) and, with
        a D, the GAN-G term through D in train mode, whose parameters get
        no gradient."""
        logs = {}
        total = 0.
        if self.cri_pix is not None:
            l_g_pix = self.cri_pix(output, gt)
            total = total + l_g_pix
            logs['l_g_pix'] = l_g_pix.detach()
        if self.cri_perceptual is not None:
            l_g_percep, l_g_style = self.cri_perceptual(output, gt)
            if l_g_percep is not None:
                total = total + l_g_percep
                logs['l_g_percep'] = l_g_percep.detach()
            if l_g_style is not None:
                total = total + l_g_style
                logs['l_g_style'] = l_g_style.detach()
        if self.net_d is not None:
            self.net_d.requires_grad_(False)
            try:
                fake_pred = self.net_d(output)
            finally:
                self.net_d.requires_grad_(True)
            l_g_gan = gan_loss(fake_pred, True, self.gan_type,
                               loss_weight=self.gan_weight, is_disc=False)
            total = total + l_g_gan
            logs['l_g_gan'] = l_g_gan.detach()
        return total, logs

    def save(self, epoch, current_iter):
        self.save_network(self.net_g, 'net_g', current_iter)
        if self.net_d is not None:
            self.save_network(self.net_d, 'net_d', current_iter)
        self.save_training_state(epoch, current_iter, {
            **self.schedules.state_dict(),
            'gp_generator': self.gp_generator.get_state()})

    def resume_training(self, state_path):
        """Restore the optimizers, the schedule counts and the GP generator
        from a .state file (the nets come from ``path.pretrain_model_*``,
        which ``check_resume`` points at the matching .pth files). Returns
        (epoch, iter)."""
        epoch, it, state = self.load_training_state(state_path)
        self.schedules.load_state_dict(state)
        self.gp_generator.set_state(state['gp_generator'])
        return epoch, it
