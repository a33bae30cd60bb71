"""Single-image SR model, and the validation loop of the SR models.

Counterpart of ``c2matching_tpu/models/sr_model.py``, the model
``model_type: SRModel``: ``net_g`` from ``network_g`` with a random init
seeded from ``manual_seed`` (then ``path.pretrain_model_g``), trained by
Adam (``lr_g``, ``beta_g``, ``weight_decay_g``, under the schedule) on a
pixel loss (``pixel_criterion``, ``pixel_weight``) and an optional
perceptual one (``perceptual_opt``). ``feed_data`` takes 'img_in_lq' and,
where present, the ground truth 'img_in'; ``test`` runs net_g in eval
mode; ``test_x8`` averages its outputs over the 8 dihedral transforms of
the input (rot90 k = 0..3, each with and without a horizontal flip), each
output mapped back first. ``val: use_x8: true`` makes validation run
``test_x8``; validation scores PSNR. Subclasses (RefRestorationModel)
build their own nets and keep the loop alone.

The loop: ``nondist_validation`` and, at world size > 1,
``dist_validation`` run ``_validation_loop``, which takes every image (or
rank r's, every world-th from r) through the subclass's
``_validation_images``, optionally saves the result (in
``nondist_validation`` under a process group, where every rank takes
every image, rank 0 alone saves and logs each), averages the metrics
of ``_compute_val_metrics`` (named by ``_VAL_METRIC_LABELS``; the sums and
the count all-reduced over the ranks) and logs them in the JAX package's
format, to tensorboard too when a writer is given; ``_save_val_image``
writes the PNG where the reference does.
"""
import logging
import os.path as osp

import numpy as np
import torch

from ..parallel import allreduce_sum_across_processes
from ..utils import ProgressBar, imwrite, metrics, tensor2img
from .base_model import BaseModel, ScheduleCounts, make_adam
from .losses import PIXEL_LOSSES, PerceptualLoss
from .networks import define_network

logger = logging.getLogger('base')


class SRModel(BaseModel):
    """Single-image SR, net_g(img_in_lq) against img_in (see the module
    docstring), and the validation loop of its subclasses.

    Args:
        opt: the options dict (``network_g``, optionally ``path``,
            ``manual_seed``, ``crop_border``, ``val``; for training
            ``is_train`` and ``train``).
        device: where net_g runs: the CUDA card unless the caller asks for
            another device.
        generator: torch.Generator for the random init; by default one
            seeded with ``opt['manual_seed']`` (0 when unset).
    """

    _VAL_METRIC_LABELS = {'psnr': 'PSNR'}
    _VAL_LOG_PER_IMAGE = False

    def __init__(self, opt, device='cuda', generator=None):
        super().__init__(opt, device)
        if type(self) is not SRModel:
            return      # a subclass builds its own nets
        if generator is None:
            generator = torch.Generator().manual_seed(
                opt.get('manual_seed') or 0)
        self.net_g = define_network(opt['network_g'], generator)
        path_opt = opt.get('path') or {}
        if path_opt.get('pretrain_model_g'):
            self.load_network(self.net_g, path_opt['pretrain_model_g'],
                              path_opt.get('strict_load', True) is not False)
        self.net_g.to(self.device)
        self.print_network(self.net_g)
        self.batch = None
        self.output = None
        if self.is_train:
            self.init_training_settings()
        else:
            self.net_g.eval().requires_grad_(False)

    def init_training_settings(self):
        """The pixel and perceptual losses and G's Adam, scheduled, from
        the options' ``train`` block."""
        train_opt = self.opt['train']
        self.net_g.train()
        self.cri_pix = None
        if (train_opt.get('pixel_weight') or 0) > 0:
            self.cri_pix = PIXEL_LOSSES[train_opt['pixel_criterion']](
                loss_weight=train_opt['pixel_weight'], reduction='mean')
        self.cri_perceptual = None
        if train_opt.get('perceptual_opt'):
            self.cri_perceptual = PerceptualLoss(
                **dict(train_opt['perceptual_opt']),
                generator=torch.Generator().manual_seed(11)).to(self.device)
        self.optimizer_g = make_adam(
            [('g', self.net_g.parameters(), train_opt['lr_g'])],
            betas=train_opt.get('beta_g') or (0.9, 0.999),
            weight_decay=train_opt.get('weight_decay_g') or 0)
        self.schedules = ScheduleCounts(self.schedule_fn)
        self.schedules.add('g', self.optimizer_g, True)
        self.log_dict = {}

    def current_learning_rates(self, step):
        lr = self.opt['train']['lr_g']
        if self.schedule_fn is None:
            return [float(lr)]
        return [float(self.schedule_fn(step, lr))]

    def feed_data(self, batch):
        """Move 'img_in_lq' (B, h, w, 3) and, where present, 'img_in'
        (B, H, W, 3) to the device as float32 NHWC."""
        self.batch = {k: torch.as_tensor(batch[k], dtype=torch.float32)
                      .to(self.device)
                      for k in ('img_in_lq', 'img_in') if k in batch}

    def optimize_parameters(self, step):
        """One Adam step on the pixel (and perceptual, style) losses of
        net_g's output; logs ``l_pix``, ``l_percep``, ``l_style``."""
        self.optimizer_g.zero_grad(set_to_none=True)
        output = self.net_g(self.batch['img_in_lq'])
        gt = self.batch['img_in']
        logs = {}
        total = 0.
        if self.cri_pix is not None:
            l_pix = self.cri_pix(output, gt)
            total = total + l_pix
            logs['l_pix'] = l_pix.detach()
        if self.cri_perceptual is not None:
            l_percep, l_style = self.cri_perceptual(output, gt)
            if l_percep is not None:
                total = total + l_percep
                logs['l_percep'] = l_percep.detach()
            if l_style is not None:
                total = total + l_style
                logs['l_style'] = l_style.detach()
        total.backward()
        self.sync_gradients(self.net_g.parameters())
        self.schedules.step('g')
        self.output = output.detach()
        self.log_dict = self.global_logs(logs)

    def _eval_forward(self, fn):
        """``fn()`` with net_g in eval mode and no graph; the mode is
        restored after."""
        was = self.net_g.training
        self.net_g.eval()
        try:
            with torch.no_grad():
                return fn()
        finally:
            self.net_g.train(was)

    def test(self):
        self.output = self._eval_forward(
            lambda: self.net_g(self.batch['img_in_lq']))

    def test_x8(self):
        """The x8 self-ensemble: the mean of net_g's outputs over rot90
        k = 0..3 of the input, each with and without a horizontal flip,
        each output flipped back and rotated by -k first."""
        def ensemble():
            lq = self.batch['img_in_lq']
            outs = []
            for rot in range(4):
                xr = torch.rot90(lq, rot, dims=(1, 2))
                for flip in (False, True):
                    y = self.net_g(xr.flip(2) if flip else xr)
                    if flip:
                        y = y.flip(2)
                    outs.append(torch.rot90(y, -rot, dims=(1, 2)))
            return sum(outs) / len(outs)

        self.output = self._eval_forward(ensemble)

    def _validation_images(self, val_data):
        """(sr_img, gt_img) of one batch-1 loader item, through ``test_x8``
        under ``val: use_x8``, else ``test``; the output is cropped to the
        original size where the dataset padded."""
        self.feed_data(val_data)
        if (self.opt.get('val') or {}).get('use_x8'):
            self.test_x8()
        else:
            self.test()
        sr_img = tensor2img(self.output)
        gt_img = tensor2img(np.asarray(val_data['img_in']))
        padding = val_data.get('padding')
        if padding is not None and bool(np.asarray(padding).reshape(-1)[0]):
            orig = val_data['original_size']
            if isinstance(orig, list):
                orig = orig[0]
            sr_img = sr_img[:int(orig[0]), :int(orig[1])]
        return sr_img, gt_img

    def _compute_val_metrics(self, sr_img, gt_img):
        return {'psnr': metrics.psnr(sr_img, gt_img,
                                     crop_border=self.opt['crop_border'])}

    def save(self, epoch, current_iter):
        self.save_network(self.net_g, 'net_g', current_iter)
        self.save_training_state(epoch, current_iter,
                                 self.schedules.state_dict())

    def resume_training(self, state_path):
        """Restore G's optimizer and schedule count from a .state file.
        Returns (epoch, iter)."""
        epoch, it, state = self.load_training_state(state_path)
        self.schedules.load_state_dict(state)
        return epoch, it

    def nondist_validation(self, dataloader, current_iter, tb_logger,
                           save_img=False):
        """{metric: average} of the model on ``dataloader``; under a
        process group every rank takes every image (the banded evaluation)
        and rank 0 alone saves and logs each."""
        return self._validation_loop(dataloader, current_iter, tb_logger,
                                     save_img)

    def dist_validation(self, dataloader, current_iter, tb_logger,
                        save_img=False):
        """The same averages, each rank scoring every world-th image."""
        return self._validation_loop(dataloader, current_iter, tb_logger,
                                     save_img, rank=self.rank,
                                     world=self.world)

    def _validation_loop(self, dataloader, current_iter, tb_logger,
                         save_img, rank=0, world=1):
        pbar = ProgressBar(len(dataloader))
        dataset_name = dataloader.dataset.opt['name']
        names = list(self._VAL_METRIC_LABELS)
        sums = {k: 0. for k in names}
        count = 0
        # the process that saves and logs each of its images: every rank
        # of a strided loop, rank 0 where every rank takes every image
        writes = world > 1 or self.rank == 0
        for idx, val_data in enumerate(dataloader):
            if idx % world != rank:
                continue
            img_name = osp.splitext(
                osp.basename(val_data['lq_path'][0]))[0]
            sr_img, gt_img = self._validation_images(val_data)
            if save_img and writes:
                self._save_val_image(sr_img, img_name, dataset_name,
                                     current_iter)
            vals = self._compute_val_metrics(sr_img, gt_img)
            for k in names:
                sums[k] += vals[k]
            count += 1
            if not self.is_train and self._VAL_LOG_PER_IMAGE and writes:
                logger.info(f'# img {img_name} ' + ' '.join(
                    f'# {self._VAL_METRIC_LABELS[k]}: {vals[k]:.4e}'
                    for k in names) + '.')
            pbar.update(f'Test {img_name}')
        if world > 1:
            vec = allreduce_sum_across_processes(
                [sums[k] for k in names] + [count])
            sums = dict(zip(names, (float(v) for v in vec[:-1])))
            count = float(vec[-1])
        avgs = {k: sums[k] / max(count, 1) for k in names}
        logger.info(f'# Validation {dataset_name} ' + ' '.join(
            f'# {self._VAL_METRIC_LABELS[k]}: {avgs[k]:.4e}'
            for k in names) + '.')
        if tb_logger:
            for k in names:
                tb_logger.add_scalar(k, avgs[k], current_iter)
        return avgs

    def _save_val_image(self, sr_img, img_name, dataset_name, current_iter):
        if self.opt['is_train']:
            save_img_path = osp.join(self.opt['path']['visualization'],
                                     img_name,
                                     f'{img_name}_{current_iter}.png')
        else:
            save_img_path = osp.join(self.opt['path']['visualization'],
                                     dataset_name,
                                     f"{img_name}_{self.opt['name']}.png")
            if self.opt.get('suffix'):
                save_img_path = save_img_path.replace(
                    '.png', f"_{self.opt['suffix']}.png")
        imwrite(sr_img, save_img_path)
