"""The framework's root logger.

Counterpart of ``c2matching_tpu/utils/logger.py::get_root_logger``, with
its format. Single process: every message at ``log_level`` goes to the
stream and, when given, to ``log_file``. The per-iteration training
logger waits for the train runner.
"""
import logging

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
    logger.setLevel(log_level)
    if log_file is not None:
        file_handler = logging.FileHandler(log_file, 'w')
        file_handler.setFormatter(logging.Formatter(format_str))
        file_handler.setLevel(log_level)
        logger.addHandler(file_handler)
    _initialized_loggers.add(logger_name)
    return logger
