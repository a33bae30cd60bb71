"""The validation loop of the SR models.

Counterpart of the evaluation half of ``c2matching_tpu/models/
sr_model.py``: ``validation`` (one process; the process-sharded
``dist_validation`` waits for multi-GPU) runs ``_validation_loop``, which
takes every image through the subclass's ``_validation_images``,
optionally saves the result, averages the metrics of
``_compute_val_metrics`` (named by ``_VAL_METRIC_LABELS``) and logs them
in the JAX package's format; ``_save_val_image`` writes the PNG where the
reference does.
"""
import logging
import os.path as osp

from ..utils import ProgressBar, imwrite
from .base_model import BaseModel

logger = logging.getLogger('base')


class SRModel(BaseModel):
    """Validation over (output, ground truth) image pairs."""

    _VAL_LOG_PER_IMAGE = False

    def validation(self, dataloader, current_iter, tb_logger,
                   save_img=False):
        """{metric: average} of the model on ``dataloader``."""
        return self._validation_loop(dataloader, current_iter, tb_logger,
                                     save_img)

    def _validation_loop(self, dataloader, current_iter, tb_logger,
                         save_img):
        pbar = ProgressBar(len(dataloader))
        dataset_name = dataloader.dataset.opt['name']
        names = list(self._VAL_METRIC_LABELS)
        sums = {k: 0. for k in names}
        count = 0
        for val_data in dataloader:
            img_name = osp.splitext(
                osp.basename(val_data['lq_path'][0]))[0]
            sr_img, gt_img = self._validation_images(val_data)
            if save_img:
                self._save_val_image(sr_img, img_name, dataset_name,
                                     current_iter)
            vals = self._compute_val_metrics(sr_img, gt_img)
            for k in names:
                sums[k] += vals[k]
            count += 1
            if not self.is_train and self._VAL_LOG_PER_IMAGE:
                logger.info(f'# img {img_name} ' + ' '.join(
                    f'# {self._VAL_METRIC_LABELS[k]}: {vals[k]:.4e}'
                    for k in names) + '.')
            pbar.update(f'Test {img_name}')
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
