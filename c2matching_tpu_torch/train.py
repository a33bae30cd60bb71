"""Training entry point of the port, the counterpart of ``mmsr/train.py``:

    python -m c2matching_tpu_torch.train -opt options/train/<config>.yml \
        [--device cpu] [--launcher {none,pytorch,slurm}]

    python -m torch.distributed.run --nproc_per_node <cards> \
        -m c2matching_tpu_torch.train -opt <config>.yml --launcher pytorch

Parses the options file (``is_train``), seeds ``random``, ``np.random``
and torch's default generator from ``train.manual_seed``, builds the
train loader (with the ratio-enlarged sampler when
``dataset_enlarge_ratio`` > 1) and the val loader, creates the model and
runs ``niter`` iterations: ``feed_data`` + ``optimize_parameters``, the
log line every ``logger.print_freq``, validation every ``val.val_freq``,
checkpoints every ``logger.save_checkpoint_freq`` and the latest at the
end. ``path.resume_state`` (a ``<iter>.state`` file) resumes: the nets
from that iteration's ``.pth`` files, the optimizers and schedule counts
from the state. SIGTERM or SIGINT saves a resumable checkpoint and
returns. Outputs go under ``experiments/<name>/`` (or
``$C2MATCHING_ROOT``); ``use_tb_logger: true`` (outside debug names) adds
scalar event files under ``tb_logger/<name>/`` there. The model runs on
the CUDA card unless ``--device`` names another device; with no card it
raises rather than fall back to the CPU.

``logger.trace_dir`` traces iterations [``trace_start_iter``,
``trace_start_iter`` + ``trace_n_iters``) (defaults 10 and 5; the start
is at least 1) with ``torch.profiler``: CPU activity, and CUDA activity
on the card; one ``ProfilerStep`` an iteration. The window closes after
its last iteration, or at the loop's end or before a preemption save if
those come first, and each rank writes one trace file
(``rank<r>.<ns>.pt.trace.json``, tensorboard's layout) under
``trace_dir``.

``--launcher pytorch`` (torchrun's environment) or ``slurm`` runs one
process a card (``parallel/``; ``dist_params.backend`` ``ici`` is NCCL on
the card and gloo with ``--device cpu``): each process loads
``batch_size // world`` items a step through its share of the sampler
(built whenever the run is distributed), the models average their
gradients over the processes, rank 0 alone makes the experiment
directories and writes the log file, the checkpoints and the event files,
and the other ranks log errors only.
"""
import argparse
import logging
import math
import os
import os.path as osp
import random
import signal
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from .data import create_dataloader, create_dataset, create_train_sampler
from .models import create_model
from .parallel import LAUNCHERS, init_distributed
from .utils import (MessageLogger, check_resume, dict2str, dict_to_nonedict,
                    get_root_logger, init_tb_logger, make_exp_dirs)
from .utils.options import parse


def _loaders(opt, seed, logger):
    """(train loader, val loader or None, total epochs)."""
    train_loader = val_loader = None
    total_epochs = 0
    for phase, dataset_opt in opt['datasets'].items():
        if phase == 'train':
            train_set = create_dataset(dataset_opt)
            train_size = int(
                math.ceil(len(train_set) / dataset_opt['batch_size']))
            total_iters = int(opt['train']['niter'])
            total_epochs = int(math.ceil(total_iters / train_size))
            sampler = None
            enlarge = dataset_opt.get('dataset_enlarge_ratio', 1) or 1
            world, rank = opt['world_size'], opt['rank']
            if opt['dist'] or enlarge > 1:
                sampler = create_train_sampler(train_set, dataset_opt, world,
                                               rank)
                total_epochs = int(
                    math.ceil(total_iters / (train_size * enlarge)))
            train_loader = create_dataloader(train_set, dataset_opt, world,
                                             rank, sampler, seed=seed)
            logger.info(f'Number of train images: {len(train_set)}, '
                        f'iters: {train_size}')
            logger.info(f'Total epochs needed: {total_epochs} for iters '
                        f'{total_iters}')
        elif phase == 'val':
            val_set = create_dataset(dataset_opt)
            val_loader = create_dataloader(val_set, dataset_opt)
            logger.info(
                f"Number of val images/folders in {dataset_opt['name']}: "
                f'{len(val_set)}')
        else:
            raise NotImplementedError(f'Phase {phase} is not recognized.')
    if train_loader is None:
        raise ValueError('the options have no datasets.train block')
    return train_loader, val_loader, total_epochs


def trace_window(logger_opt):
    """(trace_dir, first iteration, iterations) of ``logger.trace_dir``'s
    profiler window, or None without a trace_dir."""
    logger_opt = logger_opt or {}
    if not logger_opt.get('trace_dir'):
        return None
    start = logger_opt.get('trace_start_iter')
    n = logger_opt.get('trace_n_iters')
    # current_iter starts at 1: a start of 0 would never open the window
    return (logger_opt['trace_dir'], max(1, 10 if start is None
                                         else int(start)),
            5 if n is None else int(n))


class _Tracer:
    """The ``torch.profiler`` window of ``trace_window`` in the loop:
    ``begin(it)`` before iteration ``it`` opens it at its first iteration,
    ``step(it)`` after it closes a ``ProfilerStep`` (and the window after
    its last iteration, when the schedule writes the trace), ``stop()``
    closes an open window and writes what it holds."""

    def __init__(self, window, device, rank, logger):
        self.window = window
        self.device = torch.device(device)
        self.rank = rank
        self.logger = logger
        self.prof = None

    def begin(self, current_iter):
        if self.window is None:
            return
        trace_dir, start, n = self.window
        if n <= 0 or current_iter != start:
            return
        from torch.profiler import (ProfilerActivity, profile, schedule,
                                    tensorboard_trace_handler)
        activities = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        with warnings.catch_warnings():
            # the window records exactly its iterations, as the JAX
            # package's does: no warm-up iteration before it
            warnings.filterwarnings('ignore', 'Profiler won.t be using '
                                    'warmup')
            window = schedule(wait=0, warmup=0, active=n, repeat=1)
        self.prof = profile(
            activities=activities, schedule=window,
            on_trace_ready=tensorboard_trace_handler(
                trace_dir, worker_name=f'rank{self.rank}'))
        self.prof.start()

    def step(self, current_iter):
        if self.prof is None:
            return
        self.prof.step()
        _, start, n = self.window
        if current_iter >= start + n - 1:
            self.stop()

    def stop(self):
        if self.prof is not None:
            self.prof.stop()
            self.prof = None
            self.logger.info(f'profiler trace written to {self.window[0]}')


def run(opt_path, device='cuda', launcher='none'):
    """Train the model of ``opt_path`` (in the process group of
    ``launcher``, which the run leaves at its end). Returns the model."""
    opt = parse(opt_path, is_train=True)
    rank, world, device = init_distributed(opt, launcher, device)
    try:
        return _train(opt, rank, world, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(opt, rank, world, device):
    """The run's directories, logs and tensorboard writer, then the
    loop."""
    opt['dist'] = world > 1
    opt['rank'], opt['world_size'] = rank, world
    resume_state_path = opt['path'].get('resume_state')
    if resume_state_path:
        check_resume(opt, osp.splitext(osp.basename(resume_state_path))[0])
    elif rank == 0:
        make_exp_dirs(opt)
    if world > 1:
        dist.barrier()
    stamp = time.strftime('%Y%m%d_%H%M%S', time.localtime())
    log_file = osp.join(opt['path']['log'], f"train_{opt['name']}_{stamp}.log")
    logger = get_root_logger(logger_name='base', log_level=logging.INFO,
                             log_file=log_file)
    logger.info(dict2str(opt))
    tb_logger = None
    if opt.get('use_tb_logger') and 'debug' not in opt['name'] and rank == 0:
        tb_logger = init_tb_logger(
            osp.join(opt['path']['root'], 'tb_logger', opt['name']))
    opt = dict_to_nonedict(opt)
    try:
        return _loop(opt, device, resume_state_path, logger, tb_logger)
    finally:
        if tb_logger is not None:
            tb_logger.close()


def _loop(opt, device, resume_state_path, logger, tb_logger):
    """Seeds, loaders and model, then the iterations. Returns the model."""
    seed = opt['train']['manual_seed']
    if seed is None:
        seed = random.randint(1, 10000)
    logger.info(f'Random seed: {seed}')
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    train_loader, val_loader, total_epochs = _loaders(opt, seed, logger)
    total_iters = int(opt['train']['niter'])
    model = create_model(opt, device)
    if resume_state_path:
        start_epoch, current_iter = model.resume_training(resume_state_path)
        logger.info(f'Resuming training from epoch: {start_epoch}, '
                    f'iter: {current_iter}.')
    else:
        start_epoch, current_iter = 0, 0
    msg_logger = MessageLogger(opt, current_iter, tb_logger)
    logger.info(f'Start training from epoch: {start_epoch}, iter: '
                f'{current_iter}')

    # a preemption signal saves a resumable checkpoint before returning
    preempted = []

    def on_signal(signum, frame):
        preempted.append(signum)
        logger.warning(f'signal {signum} received; checkpointing before '
                       'exit')

    handlers = {s: signal.signal(s, on_signal)
                for s in (signal.SIGTERM, signal.SIGINT)}
    tracer = _Tracer(trace_window(opt['logger']), model.device,
                     opt['rank'], logger)
    try:
        epoch = start_epoch
        data_time, iter_time = time.time(), time.time()
        for epoch in range(start_epoch, total_epochs + 1):
            train_loader.set_epoch(epoch)
            for train_data in train_loader:
                data_time = time.time() - data_time
                current_iter += 1
                if current_iter > total_iters:
                    break
                if preempted:
                    # current_iter - 1 is the last completed iteration
                    logger.info('Saving models and training states '
                                '(preemption).')
                    tracer.stop()
                    model.save(epoch, current_iter - 1)
                    return model
                tracer.begin(current_iter)
                model.feed_data(train_data)
                model.optimize_parameters(current_iter)
                tracer.step(current_iter)
                iter_time = time.time() - iter_time
                if preempted:
                    logger.info('Saving models and training states '
                                '(preemption).')
                    tracer.stop()
                    model.save(epoch, current_iter)
                    return model

                if current_iter % opt['logger']['print_freq'] == 0:
                    log_vars = {'epoch': epoch, 'iter': current_iter,
                                'lrs': model.current_learning_rates(
                                    current_iter),
                                'time': iter_time, 'data_time': data_time}
                    log_vars.update(model.log_dict)
                    msg_logger(log_vars)
                if (val_loader is not None
                        and current_iter % opt['val']['val_freq'] == 0):
                    model.validation(val_loader, current_iter, tb_logger,
                                     opt['val']['save_img'])
                if current_iter % opt['logger']['save_checkpoint_freq'] == 0:
                    logger.info('Saving models and training states.')
                    model.save(epoch, current_iter)
                data_time = time.time()
                iter_time = time.time()
            if current_iter > total_iters:
                break
    finally:
        tracer.stop()
        for sig, handler in handlers.items():
            signal.signal(sig, handler)

    logger.info('End of training.')
    logger.info('Saving the latest model.')
    model.save(epoch=-1, current_iter=-1)
    return model


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-opt', type=str, required=True,
                        help='Path to option YAML file.')
    parser.add_argument('--device', default='cuda',
                        help="torch device of the model (default: the CUDA "
                             "card, under a launcher the card LOCAL_RANK; "
                             "'cpu' runs on the CPU)")
    parser.add_argument('--launcher', choices=LAUNCHERS, default='none',
                        help='job launcher of a multi-process run')
    parser.add_argument('--local_rank', type=int, default=0,
                        help='the local rank, where the launcher passes it '
                             'as an argument rather than LOCAL_RANK')
    args = parser.parse_args(argv)
    if args.launcher == 'pytorch':
        os.environ.setdefault('LOCAL_RANK', str(args.local_rank))
    run(args.opt, args.device, args.launcher)


if __name__ == '__main__':
    main()
