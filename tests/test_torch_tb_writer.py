"""The port's tensorboard event writer (``c2matching_tpu_torch/utils/
tb_writer.py``), and ``use_tb_logger: true`` through the train runner.

- CRC-32C against its published check value; the files read back by
  tensorboard's own event reader give the scalars, steps and
  ``file_version`` that tensorboardX's files written with the same calls
  give.
- ``python -m c2matching_tpu_torch.train --device cpu`` on the shipped
  ``stage1_teacher_contras_network.yml`` (``use_tb_logger: true``) with
  only its data roots and iteration counts changed (2 iterations on a
  3-pair synth set, validation and a checkpoint at 2): the event file
  under ``tb_logger/<name>/`` holds every logged value at both iterations
  and the validation means at 2, equal to the log lines' values.
"""
import os
import os.path as osp
import re
import subprocess
import sys

import pytest
from tensorboard.backend.event_processing.event_accumulator import \
    EventAccumulator

from c2matching_tpu_torch.scripts import make_synth_dataset as synth
from c2matching_tpu_torch.utils import tb_writer

REPO = osp.abspath(osp.join(osp.dirname(__file__), osp.pardir))
STAGE1 = osp.join(REPO, 'options', 'train',
                  'stage1_teacher_contras_network.yml')
SCALARS = [('l_pix', 3, 0.25), ('l_pix', 7, 1e-8), ('psnr', 7, 31.5),
           ('l_g_gan', 12, -5.04e-7), ('loss', 2 ** 40, 3.0)]


def _read(log_dir):
    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return ({tag: [(s.step, s.value) for s in acc.Scalars(tag)]
             for tag in acc.Tags()['scalars']}, acc.file_version)


def test_crc32c_check_value():
    assert tb_writer.crc32c(b'123456789') == 0xE3069283
    assert tb_writer.crc32c(b'') == 0


def test_events_read_back_like_tensorboardx(tmp_path):
    from tensorboardX import SummaryWriter as TbxWriter
    ours = tb_writer.SummaryWriter(str(tmp_path / 'ours'))
    theirs = TbxWriter(log_dir=str(tmp_path / 'tbx'))
    for tag, step, value in SCALARS:
        ours.add_scalar(tag, value, step)
        theirs.add_scalar(tag, value, step)
    ours.close()
    theirs.close()
    got, version = _read(tmp_path / 'ours')
    want, want_version = _read(tmp_path / 'tbx')
    assert got == want and len(got) == 4
    assert version == want_version == 2.0     # 'brain.Event:2'
    name, = os.listdir(tmp_path / 'ours')
    assert name.startswith('events.out.tfevents.')


def _stage1_options(root, out):
    with open(STAGE1) as f:
        text = f.read()
    swaps = [
        ('./datasets/CUFED/input', f'{root}/input'),
        ('./datasets/CUFED/ref', f'{root}/ref'),
        ('    io_backend:\n      type: disk\n\n    gt_size: 160',
         f'    io_backend:\n      type: disk\n    ann_file: {root}/pairs.txt'
         '\n\n    gt_size: 160'),
        ('dataroot_in: ./datasets/CUFED5', f'dataroot_in: {root}/input'),
        ('dataroot_ref: ./datasets/CUFED5', f'dataroot_ref: {root}/ref'),
        ('./datasets/contras_val.txt', f'{root}/pairs.txt'),
        ('niter: 5000', 'niter: 2'),
        ('val_freq: !!float 5e3', 'val_freq: 2'),
        ('print_freq: 100', 'print_freq: 1'),
        ('save_checkpoint_freq: !!float 5e3', 'save_checkpoint_freq: 2')]
    for old, new in swaps:
        assert old in text, old
        text = text.replace(old, new)
    assert 'use_tb_logger: true' in text
    path = osp.join(out, 'stage1.yml')
    with open(path, 'w') as f:
        f.write(text)
    return path


@pytest.fixture(scope='module')
def stage1_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('tb_stage1')
    root = str(tmp / 'synth')
    synth.write_dataset(root, n=3, size=(160,))
    env = dict(os.environ, C2MATCHING_ROOT=str(tmp), PYTHONPATH=REPO,
               OMP_NUM_THREADS='2')
    proc = subprocess.run(
        [sys.executable, '-m', 'c2matching_tpu_torch.train', '-opt',
         _stage1_options(root, str(tmp)), '--device', 'cpu'],
        cwd=str(tmp), env=env, capture_output=True, text=True, timeout=300)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    return tmp, log


def test_use_tb_logger_writes_the_logged_values(stage1_run):
    tmp, log = stage1_run
    tb_dir = tmp / 'tb_logger' / 'stage1_teacher_contras_network'
    assert len(os.listdir(tb_dir)) == 1
    scalars, version = _read(tb_dir)
    assert version == 2.0     # 'brain.Event:2'
    for it in (1, 2):
        line, = [ln for ln in log.splitlines()
                 if re.search(rf'iter:\s+{it},', ln)]
        values = dict(re.findall(r'(\w+): (\S+) ', line + ' '))
        for key in ('loss', 'pos_dist', 'neg_dist', 'n_valid'):
            step, value = [sv for sv in scalars[key] if sv[0] == it][0]
            assert value == pytest.approx(float(values[key]), rel=1e-4)
    val_line, = [ln for ln in log.splitlines() if '# Validation' in ln]
    for label in ('loss_val', 'positive_distance', 'negative_distance'):
        (step, value), = scalars[label]
        want = float(re.search(rf'# {label}: ([-+.\deE]+\d)', val_line)
                     .group(1))
        assert step == 2 and value == pytest.approx(want, rel=1e-4)
    models = tmp / 'experiments' / 'stage1_teacher_contras_network' / 'models'
    assert sorted(os.listdir(models)) == ['net_g_2.pth', 'net_g_latest.pth']
