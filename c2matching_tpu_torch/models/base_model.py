"""Base model: device, weight loading, optimizers and checkpoints.

Counterpart of ``c2matching_tpu/models/base_model.py``:

- ``load_network`` reads the reference's ``.pth`` state dicts (a
  'state_dict' wrapper and 'module.' prefixes are stripped) and the JAX
  package's flax ``.ckpt`` files (``utils/flax_msgpack.py``, converted by
  ``utils/weights.py`` for the net's ``kind``) under ``path.strict_load``.
  A ``.ckpt`` that does not exist, with a ``.pth`` of the same stem beside
  it, is that ``.pth``: the file the port's earlier stage wrote where the
  shipped options name the JAX package's. Orbax directories are not read.
- ``make_adam`` is ``torch.optim.Adam`` over named parameter groups, each
  with its base LR: the JAX package's torch-faithful Adam (L2 decay added
  to the gradient, eps outside the square root).
- ``ScheduleCounts`` keeps the schedule counts of ``shift_schedule_count``:
  a scheduled optimizer's LR is ``schedule_fn(count, base_lr)`` per group,
  its count advances on each update and can be shifted without one, and
  Adam's own step count advances only on updates.
- Checkpoints: ``net_<label>_<iter>.pth`` and ``net_<label>_latest.pth``
  (``-1``: the latest only), and ``<iter>.state`` with the epoch, the
  iteration, the optimizers' state dicts and the schedule counts (none for
  ``-1``), written by rank 0 alone. ``path.checkpoint_backend: orbax``
  logs a warning and writes ``.pth``.
- Multi-process (``parallel/``): ``rank`` and ``world`` from the process
  group; ``sync_gradients`` averages the gradients over the ranks after a
  backward, ``global_logs`` the logged values; ``validation`` is
  ``dist_validation`` at world size > 1.
"""
import logging
import os
import os.path as osp

import torch

from .. import parallel
from .lr_scheduler import build_schedule

logger = logging.getLogger('base')

# the flax -> state-dict bridge of each kind of net a .ckpt holds
CKPT_KINDS = ('g', 'd', 'extractor', 'teacher', 'student', 'vgg19', 'vgg16')


def _flax_state_dict(path, kind):
    from ..utils import flax_msgpack, weights
    tree = flax_msgpack.load(path)
    if kind == 'g':
        return weights.restoration_net_state_dict(tree)
    if kind == 'd':
        return weights.discriminator_state_dict(tree)
    if kind in ('extractor', 'teacher', 'student'):
        return weights.contras_extractor_state_dict(tree)
    if kind in ('vgg19', 'vgg16'):
        return weights.torchvision_vgg_state_dict(tree, kind)
    raise ValueError(f'{path}: a flax .ckpt needs the kind of its net, one '
                     f'of {CKPT_KINDS}, not {kind!r}')


def _resolve_checkpoint(path):
    """``path``, or the ``.pth`` of the same stem beside a ``.ckpt`` that
    does not exist (logged at WARNING)."""
    path = str(path)
    if path.endswith('.ckpt') and not osp.exists(path):
        pth = path[:-len('.ckpt')] + '.pth'
        if not osp.exists(pth):
            raise ValueError(f'{path}: no such flax checkpoint, and no .pth '
                             f'of the same stem beside it ({pth})')
        logger.warning(f'{path} does not exist; loading {pth}, the .pth '
                       'the port wrote in its place')
        return pth
    return path


def load_state_dict_file(path, kind=None):
    """The state dict, on the CPU, of a reference ``.pth`` file or of the
    JAX package's flax ``.ckpt`` of a ``kind`` net (``CKPT_KINDS``)."""
    path = _resolve_checkpoint(path)
    if path.endswith('.ckpt'):
        return _flax_state_dict(path, kind)
    if not path.endswith('.pth'):
        raise ValueError(
            f'{path}: the port loads .pth state dicts and flax .ckpt files; '
            'orbax checkpoints of the JAX package are not read')
    state = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(state, dict) and 'state_dict' in state:
        state = state['state_dict']
    return {k[7:] if k.startswith('module.') else k: v
            for k, v in state.items()}


def make_adam(groups, betas=(0.9, 0.999), weight_decay=0.0, eps=1e-8):
    """``torch.optim.Adam`` over ``groups``, a list of (name, params,
    base_lr): update = -lr * m_hat / (sqrt(v_hat) + eps), with L2 weight
    decay added to the gradient before the moments. Each param group keeps
    its ``name`` and ``base_lr``."""
    return torch.optim.Adam(
        [{'params': list(params), 'lr': lr, 'base_lr': lr, 'name': name}
         for name, params, lr in groups],
        betas=tuple(betas), eps=eps, weight_decay=weight_decay)


class ScheduleCounts:
    """The schedule count of each named optimizer and whether its LR
    follows ``schedule_fn``. ``step(name)`` sets the groups' LRs from the
    count, runs the optimizer's update and advances the count; ``shift``
    advances it without an update (the JAX package's
    ``shift_schedule_count``)."""

    def __init__(self, schedule_fn):
        self.schedule_fn = schedule_fn
        self.optimizers = {}
        self.counts = {}
        self.scheduled = {}

    def add(self, name, optimizer, scheduled, count=0):
        self.optimizers[name] = optimizer
        self.scheduled[name] = scheduled
        self.counts[name] = count

    def lrs(self, name):
        """The LR of each group at the optimizer's current count."""
        groups = self.optimizers[name].param_groups
        if not (self.scheduled[name] and self.schedule_fn is not None):
            return [g['base_lr'] for g in groups]
        return [self.schedule_fn(self.counts[name], g['base_lr'])
                for g in groups]

    def step(self, name):
        optimizer = self.optimizers[name]
        for group, lr in zip(optimizer.param_groups, self.lrs(name)):
            group['lr'] = lr
        optimizer.step()
        self.counts[name] += 1

    def shift(self, name, by=1):
        self.counts[name] += by

    def state_dict(self):
        return {'optimizers': {k: v.state_dict()
                               for k, v in self.optimizers.items()},
                'counts': dict(self.counts)}

    def load_state_dict(self, state):
        for name, optimizer in self.optimizers.items():
            optimizer.load_state_dict(state['optimizers'][name])
        self.counts.update(state['counts'])


class BaseModel:
    """Shared infrastructure of the port's models.

    ``device``: where the nets run. Raises when it names a CUDA device on
    a host without one: no silent fall-back to the CPU.
    """

    def __init__(self, opt, device='cuda'):
        self.opt = opt
        self.is_train = bool(opt.get('is_train'))
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(
                f'device {self.device} asked for, but no CUDA card is '
                "available; pass device='cpu' to run on the CPU")
        self.rank = parallel.get_rank()
        self.world = parallel.get_world_size()
        # batch-1 evaluation split into image bands (RefRestorationModel)
        self.spatial = False
        self.log_dict = {}
        self.schedule_fn = None
        if self.is_train and opt.get('train'):
            self.schedule_fn = build_schedule(opt['train'])
        if (opt.get('path') or {}).get('checkpoint_backend') == 'orbax':
            logger.warning('path.checkpoint_backend orbax: the port writes '
                           '.pth checkpoints instead')

    def load_network(self, net, path, strict=True, kind=None):
        """Load a ``.pth`` state dict, or a flax ``.ckpt`` of a ``kind`` net,
        into ``net``. With ``strict`` every key must match; otherwise the
        missing and unexpected keys are logged."""
        logger.info(f'Loading {net.__class__.__name__} model from {path}.')
        self.load_state(net, load_state_dict_file(path, kind), strict)

    # ------------------------------------------------------ multi-process
    @staticmethod
    def sync_gradients(params):
        """Average the gradients of ``params`` over the ranks (a no-op
        without a process group)."""
        parallel.average_gradients(params)

    def global_logs(self, logs):
        """The logged values' means over the ranks: each rank logs its
        share of the global batch, whose mean is the global value."""
        return parallel.mean_across_ranks(logs)

    def validation(self, dataloader, current_iter, tb_logger,
                   save_img=False):
        """``dist_validation`` at world size > 1, else
        ``nondist_validation``; with ``spatial`` (``val_spatial_shard`` in
        evaluation) every rank takes every image, split into bands."""
        if self.world > 1 and not self.spatial:
            return self.dist_validation(dataloader, current_iter, tb_logger,
                                        save_img)
        return self.nondist_validation(dataloader, current_iter, tb_logger,
                                       save_img)

    @staticmethod
    def load_state(net, state, strict=True):
        result = net.load_state_dict(state, strict=strict)
        for key in result.missing_keys:
            logger.warning(f'missing key in checkpoint: {key}')
        for key in result.unexpected_keys:
            logger.warning(f'unexpected key in checkpoint: {key}')

    @staticmethod
    def print_network(net):
        n = sum(p.numel() for p in net.parameters())
        logger.info(f'Network: {net.__class__.__name__}, with parameters: '
                    f'{n:,d}')

    # ---------------------------------------------------------- checkpoints
    def save_network(self, net, net_label, current_iter):
        """net_<label>_<iter>.pth and net_<label>_latest.pth (-1: the latest
        only), the state dict in the reference's key names; rank 0
        only."""
        if self.rank != 0:
            return
        model_dir = self.opt['path']['models']
        os.makedirs(model_dir, exist_ok=True)
        state = {k: v.detach().cpu() for k, v in net.state_dict().items()}
        names = [f'{net_label}_latest.pth']
        if current_iter != -1:
            names.insert(0, f'{net_label}_{current_iter}.pth')
        for name in names:
            torch.save(state, osp.join(model_dir, name))

    def save_training_state(self, epoch, current_iter, state):
        """<iter>.state: {'epoch', 'iter', **state}; none for the latest
        save (-1), as the reference; rank 0 only."""
        if self.rank != 0 or current_iter == -1:
            return
        state_dir = self.opt['path']['training_state']
        os.makedirs(state_dir, exist_ok=True)
        torch.save({'epoch': epoch, 'iter': current_iter, **state},
                   osp.join(state_dir, f'{current_iter}.state'))

    @staticmethod
    def load_training_state(path):
        """(epoch, iter, the whole state dict) of a .state file."""
        state = torch.load(path, map_location='cpu', weights_only=True)
        return int(state['epoch']), int(state['iter']), state
