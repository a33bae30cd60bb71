"""The validation loop of the SR models.

Counterpart of the evaluation half of ``c2matching_tpu/models/
sr_model.py``: ``nondist_validation`` and, at world size > 1,
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

from ..parallel import allreduce_sum_across_processes
from ..utils import ProgressBar, imwrite
from .base_model import BaseModel

logger = logging.getLogger('base')


class SRModel(BaseModel):
    """Validation over (output, ground truth) image pairs."""

    _VAL_LOG_PER_IMAGE = False

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
