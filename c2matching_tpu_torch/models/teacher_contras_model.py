"""Stage-1 model: the teacher contrastive correspondence network.

Counterpart of ``c2matching_tpu/models/teacher_contras_model.py``.
``net_g`` is a ``ContrasExtractorSep`` drawn from a generator seeded with
``manual_seed`` (then ``path.pretrain_model_g``, a ``.pth``, under
``strict_load``). One step is ``feed_data`` -> ``optimize_parameters``:
the extractor on (img_in, img_ref), ``triplet_loss_batch`` on its dense
features against the homography grid, backward and Adam (one group at
``lr_g``, its LR following the schedule's count). ``validation`` gives the
mean loss, positive and negative distance over a loader.

``ContrasModel`` holds what stages 1 and 2 share: the loss options,
the optimizer and schedule count of the trained net, the step, the
validation loop, ``save`` and ``resume_training``.

At world size > 1 (``parallel/``) each rank takes its slice of the global
batch; the loss divides by the count of samples over the 128 gate in the
global batch and hands each rank its share, world x its samples' sum over
that count, so that the ranks' mean is the global loss and the averaged
gradients (``sync_gradients``) are the global batch's; ``log_dict``
holds the global values. Validation runs on every process, as the JAX
package's ``dist_validation`` does.
"""
import copy
import logging
import os.path as osp

import torch

from .. import parallel
from ..utils import ProgressBar
from .base_model import BaseModel, ScheduleCounts, make_adam
from .contras_losses import triplet_loss_batch
from .networks import define_network

logger = logging.getLogger('base')


class ContrasModel(BaseModel):
    """A contrastive model: subclasses build the nets named in
    ``net_names`` and ``self.trained`` (the net the optimizer updates, the
    attribute ``net_label``, saved under that label) in ``_build_nets``
    and give the step's losses in ``_losses``."""

    net_label = 'net_g'
    net_names = ('net_g',)
    batch_keys = ('img_in', 'img_ref', 'transformed_coordinate')
    val_labels = {'loss': 'loss_val', 'pos_dist': 'positive_distance',
                  'neg_dist': 'negative_distance'}

    def __init__(self, opt, device='cuda'):
        super().__init__(opt, device)
        self._build_nets(
            torch.Generator().manual_seed(opt.get('manual_seed') or 0))
        parallel.broadcast_parameters(*(getattr(self, n)
                                        for n in self.net_names))
        self.batch = None
        self._last_eval = None
        if self.is_train:
            self.init_training_settings()
        else:
            self.trained.requires_grad_(False)

    def _load_path(self, net, key):
        path_opt = self.opt.get('path') or {}
        if path_opt.get(key):
            self.load_network(net, path_opt[key],
                              path_opt.get('strict_load', True) is not False,
                              kind='extractor')

    def init_training_settings(self):
        train_opt = self.opt['train']
        self.margin = train_opt['margin']
        self.safe_radius = train_opt['safe_radius']
        self.scaling_steps = train_opt['scaling_steps']
        self.optimizer_g = make_adam(
            [('g', self.trained.parameters(), train_opt['lr_g'])])
        self.schedules = ScheduleCounts(self.schedule_fn)
        self.schedules.add('g', self.optimizer_g, True)
        self.log_dict = {}

    def current_learning_rates(self, step):
        lr = self.opt['train']['lr_g']
        if self.schedule_fn is None:
            return [float(lr)]
        return [float(self.schedule_fn(step, lr))]

    def _loss_opts(self):
        return {'margin': self.margin, 'safe_radius': self.safe_radius,
                'scaling_steps': self.scaling_steps, 'world': self.world}

    def feed_data(self, batch):
        """Move the batch's NHWC float arrays (``batch_keys``) to the
        device."""
        self.batch = {k: torch.as_tensor(batch[k], dtype=torch.float32)
                      .to(self.device) for k in self.batch_keys}

    def optimize_parameters(self, step):
        self.optimizer_g.zero_grad(set_to_none=True)
        logs = self._losses()
        logs['loss'].backward()
        self.sync_gradients(self.trained.parameters())
        self.schedules.step('g')
        self.log_dict = self.global_logs(
            {k: v.detach() for k, v in logs.items()})

    def float64_grads(self, batch):
        """(logs, {name: gradient}) of the step's losses on ``batch`` from
        the weights as they stand, in float64: copies of the nets (their
        convs computing in double) on the batch in double. The weights are
        not updated. The yardstick of a float32 step's gradients. At world
        size > 1: the global batch's logs and gradients."""
        m = copy.copy(self)
        for name in self.net_names:
            net = copy.deepcopy(getattr(self, name)).double()
            for conv in net.modules():
                if hasattr(conv, 'compute_dtype'):
                    conv.compute_dtype = torch.float64
            setattr(m, name, net)
        m.trained = getattr(m, self.net_label)
        m.feed_data(batch)
        m.batch = {k: v.double() for k, v in m.batch.items()}
        logs = m._losses()
        logs['loss'].backward()
        m.sync_gradients(m.trained.parameters())
        logs = m.global_logs({k: v.detach() for k, v in logs.items()})
        return ({k: float(v) for k, v in logs.items()},
                {k: p.grad for k, p in m.trained.named_parameters()})

    @torch.no_grad()
    def test(self):
        """The losses of the fed batch, this process's alone."""
        self._last_eval = self._losses(world=1)

    def dist_validation(self, dataloader, current_iter, tb_logger,
                        save_img=False):
        """Every process validates the whole set, as the JAX package's
        contrastive models do."""
        return self.nondist_validation(dataloader, current_iter, tb_logger,
                                       save_img)

    def nondist_validation(self, dataloader, current_iter, tb_logger,
                           save_img=False):
        """{name: mean} of the losses of ``val_labels`` over
        ``dataloader``."""
        pbar = ProgressBar(len(dataloader))
        totals = {k: 0. for k in self.val_labels}
        count = 0
        dataset_name = dataloader.dataset.opt['name']
        for val_data in dataloader:
            img_name = osp.splitext(osp.basename(val_data['name'][0]))[0]
            self.feed_data(val_data)
            self.test()
            for k in totals:
                totals[k] += float(self._last_eval[k])
            count += 1
            pbar.update(f'Test {img_name}')
        for k in totals:
            totals[k] /= max(count, 1)
        logger.info(f'# Validation {dataset_name} ' + ' '.join(
            f'# {label}: {totals[k]:.4e}'
            for k, label in self.val_labels.items()) + '.')
        if tb_logger:
            for k, label in self.val_labels.items():
                tb_logger.add_scalar(label, totals[k], current_iter)
        return totals

    def save(self, epoch, current_iter):
        self.save_network(self.trained, self.net_label, current_iter)
        self.save_training_state(epoch, current_iter,
                                 self.schedules.state_dict())

    def resume_training(self, state_path):
        """Restore the optimizer and its schedule count from a .state file
        (the net comes from the matching .pth, which ``check_resume``
        names). Returns (epoch, iter)."""
        epoch, it, state = self.load_training_state(state_path)
        self.schedules.load_state_dict(state)
        return epoch, it


class TeacherContrasModel(ContrasModel):
    """Stage 1: ``network_g`` trained on the triplet loss."""

    def _build_nets(self, generator):
        self.net_g = define_network(self.opt['network_g'], generator)
        self._load_path(self.net_g, 'pretrain_model_g')
        self.net_g.to(self.device)
        self.print_network(self.net_g)
        self.trained = self.net_g

    def _losses(self, **opts):
        out = self.net_g(self.batch['img_in'], self.batch['img_ref'])
        loss, pos, neg, n_ok = triplet_loss_batch(
            out['dense_features1'], out['dense_features2'],
            self.batch['transformed_coordinate'],
            **{**self._loss_opts(), **opts})
        return {'loss': loss, 'pos_dist': pos, 'neg_dist': neg,
                'n_valid': n_ok}
