"""The framework's root logger, the training message logger and the
tensorboard writer.

Counterpart of ``c2matching_tpu/utils/logger.py`` (``get_root_logger``,
``MessageLogger``, ``init_tb_logger``), with its formats. On rank 0 (or
without a process group) every message at ``log_level`` goes to the
stream and, when given, to ``log_file``; the other ranks log errors only
and write no file. ``init_tb_logger`` is ``utils/tb_writer.py``'s scalar
event writer (the card's machine has no tensorboard).
"""
import datetime
import logging
import time

from ..parallel import get_rank
from .tb_writer import SummaryWriter

_initialized_loggers = set()


def get_root_logger(logger_name='base', log_level=logging.INFO,
                    log_file=None):
    """Create/fetch the framework root logger."""
    logger = logging.getLogger(logger_name)
    if logger_name in _initialized_loggers:
        return logger
    format_str = '%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s'
    stream_handler = logging.StreamHandler()
    stream_handler.setFormatter(logging.Formatter(format_str))
    logger.addHandler(stream_handler)
    logger.propagate = False
    if get_rank() != 0:
        logger.setLevel(logging.ERROR)
    else:
        logger.setLevel(log_level)
        if log_file is not None:
            file_handler = logging.FileHandler(log_file, 'w')
            file_handler.setFormatter(logging.Formatter(format_str))
            file_handler.setLevel(log_level)
            logger.addHandler(file_handler)
    _initialized_loggers.add(logger_name)
    return logger


def init_tb_logger(log_dir):
    """A scalar event writer under ``log_dir``."""
    return SummaryWriter(log_dir)


class MessageLogger:
    """Per-iteration training log line with ETA:
    ``[name..][epoch:E, iter:I, lr:(...)] [eta: .., time: .., data_time: ..]
    loss_a: v loss_b: v``. Values are read (a wait for the device) only
    when the line is written; an ``offset_absmean_*`` above 100 warns.
    With ``tb_logger`` (and ``logger.use_tb_logger`` not false) each value
    is also a tensorboard scalar at the iteration."""

    def __init__(self, opt, start_iter=1, tb_logger=None):
        self.exp_name = opt['name']
        self.interval = opt['logger']['print_freq']
        self.start_iter = start_iter
        self.max_iters = opt['train']['niter']
        self.use_tb_logger = opt['logger'].get('use_tb_logger', True) \
            is not False
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def __call__(self, log_vars):
        log_vars = dict(log_vars)
        epoch = log_vars.pop('epoch')
        current_iter = log_vars.pop('iter')
        lrs = log_vars.pop('lrs')
        message = (f'[{self.exp_name[:5]}..][epoch:{epoch:3d}, '
                   f'iter:{current_iter:8,d}, lr:(')
        message += ', '.join(f'{v:.3e}' for v in lrs) + ')] '
        if 'time' in log_vars:
            iter_time = log_vars.pop('time')
            data_time = log_vars.pop('data_time')
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / (current_iter - self.start_iter + 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(eta_sec)))
            message += (f'[eta: {eta_str}, time: {iter_time:.3f}, '
                        f'data_time: {data_time:.3f}] ')
        for k, v in log_vars.items():
            v = float(v)
            message += f'{k}: {v:.4e} '
            if self.tb_logger and self.use_tb_logger:
                self.tb_logger.add_scalar(k, v, current_iter)
            if k.startswith('offset_absmean') and v > 100:
                self.logger.warning(f'Offset mean is {v}, larger than 100.')
        self.logger.info(message)
