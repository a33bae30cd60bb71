"""The training options the port takes besides the shipped configs' keys,
on the CPU at the small widths of ``torch_train_common``:

- ``train.remat_policy``: one G-pretrain and one GAN step from the same
  state under 'dcn_rows' and 'dots' equal the 'none' step (losses and
  parameters within 1e-6 of the largest; bit for bit expected, the same
  arithmetic recomputed), and an operator count shows what each policy
  keeps: B3's forward (``c2matching::deform_im2col``) runs no more often
  under 'dcn_rows' than under 'none', and twice under 'dots'; G's
  convolutions run twice under 'dcn_rows' and once under 'dots';
- ``logger.trace_dir``: the profiler window of the train loop;
- the byte counter of the profilers (``utils/prof.py::ByteCounter``) and
  the byte fields of ``profile_serving --cost``;
- ``utils/bench_gate.py::gate`` against the JAX package's.
"""
import collections
import functools
import glob
import json
import logging
import os.path as osp
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

import torch_train_common as common
from c2matching_tpu.utils import bench_gate as jax_bench_gate
from c2matching_tpu_torch.models import RefRestorationModel
from c2matching_tpu_torch.scripts import profile_serving
from c2matching_tpu_torch.train import run, trace_window
from c2matching_tpu_torch.utils import bench_gate
from c2matching_tpu_torch.utils.prof import ByteCounter, count_gb

REMAT_REL = 1e-6
GAN_ALPHA = np.full((2, 1, 1, 1), 0.3, np.float32)


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope='module')
def synth_root(tmp_path_factory):
    return common.make_synth(tmp_path_factory.mktemp('synth_options'))


class _OpCount(TorchDispatchMode):
    """How many times each operator ran under the mode."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


IM2COL = torch.ops.c2matching.deform_im2col.default
FUSED = torch.ops.c2matching.deform_conv_fused.default
CONV = torch.ops.aten.convolution.default


def _steps(root, out, policy):
    """A fresh model (the seeded init) of ``policy``: one G-pretrain step,
    then one GAN step under an operator count. Returns (the logs of each
    step, the nets' parameters after it, the GAN step's counts)."""
    # the perceptual loss lies outside the checkpointed G forward
    opt = common.small_opt(root, out, remat_policy=policy)
    model = RefRestorationModel(opt, 'cpu')
    assert model.remat_policy == policy
    batch = common.batch(opt)
    logs, params = [], []
    for step in (1, opt['train']['net_g_pretrain_steps'] + 1):
        model.feed_data(batch)
        model.gp_alpha = GAN_ALPHA
        counts = _OpCount()
        with counts:
            model.optimize_parameters(step)
        logs.append({k: float(v) for k, v in model.log_dict.items()})
        params.append([p.detach().clone() for net in (model.net_g,
                                                      model.net_d)
                       for p in net.parameters()])
    with torch.no_grad():
        pre_offset, ref_feat = model._match()
        g_counts = _OpCount()
        with g_counts:
            model.net_g(model.batch['img_in_lq'], pre_offset, ref_feat)
    return logs, params, counts.n, g_counts.n


@pytest.fixture(scope='module')
def remat_runs(synth_root, tmp_path_factory):
    out = str(tmp_path_factory.mktemp('remat'))
    return {policy: _steps(synth_root, out, policy)
            for policy in ('none', 'dcn_rows', 'dots')}


@pytest.mark.parametrize('policy', ['dcn_rows', 'dots'])
def test_remat_steps_equal_none(remat_runs, policy):
    logs, params, _, _ = remat_runs[policy]
    want_logs, want_params, _, _ = remat_runs['none']
    for got, want in zip(logs, want_logs):
        assert set(got) == set(want)
        for key, value in want.items():
            assert abs(got[key] - value) <= REMAT_REL * max(
                abs(v) for v in want.values()), key
    for got, want in zip(params, want_params):
        top = max(float(w.abs().max()) for w in want)
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= REMAT_REL * top


def test_remat_operator_counts(remat_runs):
    """Per GAN step: 'none' runs B3 once an image and DynAgg (2 x 3) and
    each conv once; 'dcn_rows' keeps B3's columns and recomputes the rest
    of G's forward (its convs twice); 'dots' keeps the convs and matrix
    products and recomputes B3. G's forward without a graph takes the
    fused forward once a DynAgg for the batch, and no B3."""
    none, dcn_rows, dots = (remat_runs[p][2] for p in ('none', 'dcn_rows',
                                                      'dots'))
    g_forward = remat_runs['none'][3]
    assert none[IM2COL] == 2 * 3 and none[FUSED] == 0
    assert g_forward[FUSED] == 3 and g_forward[IM2COL] == 0
    assert dcn_rows[IM2COL] <= none[IM2COL]
    assert dots[IM2COL] == 2 * none[IM2COL]
    # the recompute stops after the last operator whose output the
    # backward needs: G's last conv, whose output is not kept, may not
    # run again
    assert g_forward[CONV] - 1 <= dcn_rows[CONV] - none[CONV] \
        <= g_forward[CONV]
    assert dots[CONV] == none[CONV]


def test_remat_policy_refuses_an_unknown_name(synth_root, tmp_path):
    opt = common.small_opt(synth_root, str(tmp_path), remat_policy='all')
    with pytest.raises(ValueError, match='remat_policy'):
        RefRestorationModel(opt, 'cpu')


# ----------------------------------------------------------------- trace
def test_trace_window_defaults_and_clamp():
    assert trace_window({}) is None
    assert trace_window({'trace_dir': None}) is None
    assert trace_window({'trace_dir': 't'}) == ('t', 10, 5)
    assert trace_window({'trace_dir': 't', 'trace_start_iter': 0,
                         'trace_n_iters': 2}) == ('t', 1, 2)
    assert trace_window({'trace_dir': 't', 'trace_start_iter': 3,
                         'trace_n_iters': 0}) == ('t', 3, 0)


def _trace_options(root, out, start, n_iters=3):
    """debug_stage3_synth.yml at the small width on the 64-px synth set:
    ``n_iters`` iterations (pretrain, then GAN), the profiler window at
    ``start`` for one iteration."""
    with open(common.DEBUG_CFG) as f:
        text = f.read()
    for old, new in (
            ('./datasets/synth', root), ('gt_size: 160', 'gt_size: 64'),
            ('  ngf: 64\n  n_blocks: 16\n', '  ngf: 16\n  n_blocks: 2\n'),
            ('  ndf: 32\n', '  ndf: 4\n'), ('niter: 12', f'niter: {n_iters}'),
            ('net_g_pretrain_steps: 4', 'net_g_pretrain_steps: 1'),
            ('logger:\n', f'logger:\n  trace_dir: {out}/trace\n'
                          f'  trace_start_iter: {start}\n'
                          '  trace_n_iters: 1\n')):
        assert old in text, old
        text = text.replace(old, new)
    path = osp.join(out, 'trace.yml')
    with open(path, 'w') as f:
        f.write(text)
    return path


@pytest.mark.parametrize('start,traced', [(2, 2), (0, 1)])
def test_trace_dir_writes_one_window(synth_root, tmp_path, monkeypatch,
                                     start, traced):
    """Three iterations with a one-iteration window at ``start``: one
    trace file, JSON, holding exactly one ProfilerStep, written right
    after iteration ``traced`` (a start of 0 clamps to 1)."""
    out = str(tmp_path)
    monkeypatch.setenv('C2MATCHING_ROOT', out)
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    base = logging.getLogger('base')
    base.addHandler(handler)
    try:
        run(_trace_options(synth_root, out, start), device='cpu')
    finally:
        base.removeHandler(handler)
    files = glob.glob(osp.join(out, 'trace', '*.pt.trace.json'))
    assert len(files) == 1 and osp.basename(files[0]).startswith('rank0.')
    with open(files[0]) as f:
        trace = json.load(f)
    steps = {e['name'] for e in trace['traceEvents']
             if e.get('name', '').startswith('ProfilerStep#')}
    assert len(steps) == 1, steps
    assert any(e.get('name') == 'c2matching::deform_im2col'
               for e in trace['traceEvents'])
    # the window closes after its iteration, before that iteration's log
    # line
    events = re.findall(r'iter:\s+(\d+),|(profiler trace written)',
                        '\n'.join(messages))
    order = [int(i) if i else 'trace' for i, _ in events]
    assert order == [1, 2, 3][:traced - 1] + ['trace'] + \
        [1, 2, 3][traced - 1:]


# ------------------------------------------------------------ bytes, gate
def test_byte_counter_counts_a_conv_exactly():
    x = torch.rand(2, 8, 16, 16)
    w, b = torch.rand(4, 8, 3, 3), torch.rand(4)
    with ByteCounter() as counter:
        y = F.conv2d(x, w, b, padding=1)
    assert y.shape == (2, 4, 16, 16)
    assert counter.total == 4 * (2 * 8 * 16 * 16 + 4 * 8 * 9 + 4
                                 + 2 * 4 * 16 * 16)
    # a view moves nothing; an expanded operand counts its extent; a
    # tensor passed twice counts once
    v = torch.rand(1, 5).expand(3, 5)
    with ByteCounter() as counter:
        x.permute(0, 2, 3, 1)
        z = v * v
    assert counter.total == 4 * (5 + 15)
    assert z.shape == (3, 5)
    assert count_gb(torch.mul, v, v) == 4 * 20 / 1e9


def test_profile_serving_cost_prints_the_byte_fields(monkeypatch, capsys):
    blocks = {k: dict(v) for k, v in profile_serving.SERVING_BLOCKS.items()}
    blocks['network_g'].update(ngf=16, n_blocks=2)
    monkeypatch.setattr(profile_serving, 'profile', functools.partial(
        profile_serving.profile, blocks, hr=(64, 48)))
    profile_serving.main(['--batch', '1', '--iters', '1', '--cost',
                          '--device', 'cpu'])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for stage in ('extractor', 'matcher', 'generator'):
        gb, rate = out[f'{stage}_hbm_gb'], out[f'{stage}_hbm_gb_per_s']
        assert gb > 0 and rate > 0
        net_s = out[f'{stage}_ms_net'] / 1e3
        assert rate == pytest.approx(gb / net_s, rel=0.01, abs=2e-3)


@pytest.mark.parametrize('higher', [True, False])
def test_gate_equals_jax(higher, capsys):
    for pinned in (1.0, 341.0, 10.69):
        for tol in (0.0, 0.05, 0.1, 0.5):
            for ratio in (0.4, 0.9, 0.95, 0.999, 1.0, 1.001, 1.05, 1.1, 2.0):
                value = ratio * pinned
                got = bench_gate.gate(value, pinned, higher, tol)
                want = jax_bench_gate.gate(value, pinned, higher, tol)
                assert got == want, (value, pinned, higher, tol)
                err = capsys.readouterr().err
                assert ('WARNING: benchmark regression' in err) == \
                    ('regression' in want)
    with pytest.raises(ValueError, match='positive'):
        bench_gate.gate(1.0, 0.0)
    assert bench_gate.PINNED_GAN_STEP_MS > 0
