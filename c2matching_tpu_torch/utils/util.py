"""Misc utilities: experiment dirs, image IO helpers, progress bar.

Counterpart of ``c2matching_tpu/utils/util.py`` (``mkdir_and_rename``,
``make_exp_dirs``, ``check_resume``, ``tensor2img``, ``imwrite``,
``imfrombytes``, ``impad``, ``mod_crop_to_multiple``, ``ProgressBar``).
Images go through the port's own PNG codec (``utils/png.py``) and JPEG
decoder (``utils/jpeg.py``) instead of cv2; they are BGR uint8 HWC, as cv2
gives them.
"""
import os
import os.path as osp
import sys
import time
from shutil import get_terminal_size

import numpy as np
import torch

from . import jpeg, png


def mkdir_and_rename(path):
    """mkdir; if it exists, archive the old one with a timestamp suffix."""
    if osp.exists(path):
        new_name = path + '_archived_' + time.strftime('%Y%m%d_%H%M%S')
        print(f'Path already exists. Rename it to {new_name}', flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def make_exp_dirs(opt):
    """Create the experiment/result directory tree from parsed options."""
    path_opt = dict(opt['path'])
    if opt['is_train']:
        mkdir_and_rename(path_opt.pop('experiments_root'))
    else:
        mkdir_and_rename(path_opt.pop('results_root'))
    for key, path in path_opt.items():
        if ('strict_load' in key or 'pretrain_model' in key
                or 'resume' in key or key == 'root' or not
                isinstance(path, str)):
            continue
        os.makedirs(path, exist_ok=True)


def check_resume(opt, resume_iter):
    """When resuming, point ``path.pretrain_model_g`` / ``_d`` /
    ``_student`` at the run's ``net_{g,d,student}_<resume_iter>.pth`` where
    that file exists (the nets stages 1-3 save)."""
    if not opt['path'].get('resume_state'):
        return
    for net in ('g', 'd', 'student'):
        key = f'pretrain_model_{net}'
        path = osp.join(opt['path']['models'], f'net_{net}_{resume_iter}.pth')
        if osp.exists(path):
            if opt['path'].get(key) is not None:
                print(f'[resume] ignoring {key}; using resume-state nets.',
                      flush=True)
            opt['path'][key] = path


def tensor2img(tensor, out_type=np.uint8, min_max=(0, 1)):
    """Convert NHWC/HWC float arrays or tensors (RGB, [0,1]) to BGR uint8
    HWC images.

    Accepts a single array or a list; 4D arrays must have batch 1 and are
    squeezed.
    """
    single = not isinstance(tensor, (list, tuple))
    tensors = [tensor] if single else list(tensor)
    out = []
    for t in tensors:
        if isinstance(t, torch.Tensor):
            t = t.detach().float().cpu().numpy()
        img = np.asarray(t, dtype=np.float32)
        if img.ndim == 4:
            if img.shape[0] != 1:
                raise ValueError('tensor2img expects batch of 1')
            img = img[0]
        img = np.clip((img - min_max[0]) / (min_max[1] - min_max[0]), 0, 1)
        img = img[..., ::-1]                    # RGB -> BGR
        if out_type == np.uint8:
            img = (img * 255.0).round()
        out.append(np.ascontiguousarray(img).astype(out_type))
    return out[0] if single else out


def imwrite(img, file_path, auto_mkdir=True):
    """Write a BGR uint8 image as PNG (the only format the port writes).
    Returns True, as cv2.imwrite does on success."""
    if osp.splitext(file_path)[1].lower() != '.png':
        raise ValueError(f'imwrite writes PNG only, got {file_path}')
    if auto_mkdir:
        os.makedirs(osp.dirname(osp.abspath(file_path)), exist_ok=True)
    with open(file_path, 'wb') as f:
        f.write(png.encode(img))
    return True


def imfrombytes(content):
    """Decode PNG or JPEG bytes, told apart by their magic bytes, to a BGR
    HWC uint8 array (cv2 IMREAD_COLOR semantics)."""
    if bytes(content[:3]) == jpeg.MAGIC:
        return jpeg.decode(content)
    return png.decode(content)


def impad(img, shape, pad_val=0):
    """Zero-pad a HWC image on the bottom/right to ``shape`` (h, w)."""
    h, w = img.shape[:2]
    target_h, target_w = shape
    if target_h < h or target_w < w:
        raise ValueError(f'impad: target {shape} smaller than {(h, w)}')
    pad_width = ((0, target_h - h), (0, target_w - w))
    if img.ndim == 3:
        pad_width = pad_width + ((0, 0),)
    return np.pad(img, pad_width, mode='constant', constant_values=pad_val)


def mod_crop_to_multiple(x, multiple):
    """An HWC image's spatial dims rounded down to a multiple of
    ``multiple``."""
    h, w = x.shape[:2]
    return x[:h - h % multiple, :w - w % multiple]


class ProgressBar:
    """Terminal progress bar with fps/ETA."""

    def __init__(self, task_num=0, bar_width=50, start=True):
        self.task_num = task_num
        max_bar_width = self._get_max_bar_width()
        self.bar_width = min(bar_width, max_bar_width)
        self.completed = 0
        if start:
            self.start()

    def _get_max_bar_width(self):
        terminal_width, _ = get_terminal_size()
        max_bar_width = min(int(terminal_width * 0.6), terminal_width - 50)
        return max(2, max_bar_width)

    def start(self):
        if self.task_num > 0:
            sys.stdout.write(f"[{' ' * self.bar_width}] 0/{self.task_num}, "
                             'elapsed: 0s, ETA:\nStart...\n')
        else:
            sys.stdout.write('completed: 0, elapsed: 0s')
        sys.stdout.flush()
        self.start_time = time.time()

    def update(self, msg='In progress...'):
        self.completed += 1
        elapsed = time.time() - self.start_time + 1e-8
        fps = self.completed / elapsed
        if self.task_num > 0:
            percentage = self.completed / float(self.task_num)
            eta = int(elapsed * (1 - percentage) / percentage + 0.5)
            mark_width = int(self.bar_width * percentage)
            bar_chars = '>' * mark_width + '-' * (self.bar_width - mark_width)
            sys.stdout.write('\033[2F')
            sys.stdout.write('\033[J')
            sys.stdout.write(
                f'[{bar_chars}] {self.completed}/{self.task_num}, '
                f'{fps:.1f} task/s, elapsed: {int(elapsed + 0.5)}s, '
                f'ETA: {eta:5}s\n{msg}\n')
        else:
            sys.stdout.write(
                f'completed: {self.completed}, elapsed: {int(elapsed + 0.5)}s,'
                f' {fps:.1f} tasks/s')
        sys.stdout.flush()
