"""Host-side utilities of the port."""
from .logger import MessageLogger, get_root_logger, init_tb_logger
from .metrics import bgr2ycbcr, psnr, ssim
from .options import NoneDict, dict2str, dict_to_nonedict, parse
from .util import (ProgressBar, check_resume, imfrombytes, impad, imwrite,
                   make_exp_dirs, mkdir_and_rename, tensor2img)

__all__ = [
    'MessageLogger', 'check_resume', 'get_root_logger', 'init_tb_logger',
    'bgr2ycbcr', 'psnr',
    'ssim', 'NoneDict', 'dict2str', 'dict_to_nonedict', 'parse',
    'ProgressBar', 'imfrombytes', 'impad', 'imwrite', 'make_exp_dirs',
    'mkdir_and_rename', 'tensor2img',
]
