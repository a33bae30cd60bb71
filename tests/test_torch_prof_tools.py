"""The port's profilers on the CPU: the timing protocol
(``c2matching_tpu_torch/utils/prof.py``) and the JSON lines of
``scripts/profile_serving.py``, ``scripts/bench_train.py`` and
``scripts/profile_train.py``, whose key sets are the JAX scripts', and of
``scripts/profile_memory.py`` (the port's own; on the CPU its peaks are
null). The
byte fields (``*_hbm_gb``, ``*_hbm_gb_per_s``) carry the same names as
the JAX scripts' but count another thing: the unfused traffic each
operator names (``utils/prof.py::ByteCounter``), not XLA's estimate.

Each script runs through its ``main`` with ``--device cpu`` at a tiny
size (batch 1-2, gt 64, HR 64x48); the small width (ngf 16, 2 blocks, D
ndf 4) reaches it by wrapping the function that builds its options or
nets, so no CLI flag is added. The numbers are CPU times: the tests
check keys, one JSON line and finite values only.
"""
import functools
import json
import math
import time

import pytest
import torch

from c2matching_tpu_torch.scripts import (bench_train, profile_memory,
                                          profile_serving, profile_train)
from c2matching_tpu_torch.utils import prof

# the JAX scripts' keys (scripts/profile_serving.py, bench_train.py and
# profile_train.py, main())
SERVING_STAGES = ('extractor', 'matcher', 'generator')
SERVING_KEYS = ({'batch', 'fetch_overhead_ms', 'total_net_ms',
                 'net_img_per_s'}
                | {f'{s}_{k}' for s in SERVING_STAGES
                   for k in ('ms', 'ms_net')})
SERVING_COST_KEYS = {f'{s}_{k}' for s in SERVING_STAGES
                     for k in ('gflops', 'tflops_per_s', 'hbm_gb',
                               'hbm_gb_per_s')}
BENCH_KEYS = {'metric', 'value', 'unit', 'samples_per_sec'}
TRAIN_PHASES = ('match', 'g_forward', 'loss_head', 'g_step', 'd_step')
TRAIN_KEYS = ({'batch', 'gt_size', 'fetch_overhead_ms', 'phase_sum_net_ms',
               'phase_sum_samples_per_s', 'fused_step_ms'}
              | {f'{p}_{k}' for p in TRAIN_PHASES
                 for k in ('ms', 'ms_net', 'gflops', 'tflops_per_s',
                           'hbm_gb', 'hbm_gb_per_s')})


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _small(opt):
    """The network blocks at the tests' small width."""
    if (opt.get('network_g') or {}).get('type') == 'RestorationNet':
        opt['network_g'].update(ngf=16, n_blocks=2)
    if opt.get('network_d'):
        opt['network_d']['ndf'] = 4
    return opt


def _one_json_line(capsys):
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith('{')]
    assert len(lines) == 1, lines
    out = json.loads(lines[0])
    for key, value in out.items():
        if not isinstance(value, str):
            assert math.isfinite(value), (key, value)
    return out


def test_timed_takes_the_warm_call_then_iters_in_order():
    calls = []

    def fn(i):
        calls.append(i)
        time.sleep(0.01)

    mean = prof.timed(fn, [(0,), (1,), (2,), ('warm',)], 3)
    assert calls == ['warm', 0, 1, 2]
    assert 0.01 <= mean < 0.5


def test_timed_and_calibrate_fetch_on_cpu_tensors():
    xs = [(torch.full((64, 64), float(i)),) for i in range(4)]
    assert 0 < prof.timed(torch.linalg.matrix_norm, xs, 3) < 1.0
    overhead = prof.calibrate_fetch(5, 'cpu')
    assert 0 < overhead < 0.01


def test_profile_serving_keys(monkeypatch, capsys):
    blocks = _small({k: dict(v) for k, v in
                     profile_serving.SERVING_BLOCKS.items()})
    monkeypatch.setattr(profile_serving, 'profile', functools.partial(
        profile_serving.profile, blocks, hr=(64, 48)))
    profile_serving.main(['--batch', '2', '--iters', '1', '--device', 'cpu'])
    assert set(_one_json_line(capsys)) == SERVING_KEYS
    profile_serving.main(['--batch', '1', '--iters', '1', '--cost',
                          '--device', 'cpu'])
    out = _one_json_line(capsys)
    assert set(out) == SERVING_KEYS | SERVING_COST_KEYS
    assert out['batch'] == 1 and out['matcher_gflops'] > 0


def test_flop_count_of_the_operators():
    """B1 counts 2 B Nq Nr D; B3's im2col counts 0."""
    from c2matching_tpu_torch.ops import deform_im2col, match_argmax
    q, r = torch.rand(2, 30, 16), torch.rand(2, 40, 16)
    assert profile_serving.count_gflops(match_argmax, q, r) == \
        pytest.approx(2 * 2 * 30 * 40 * 16 / 1e9)
    assert profile_serving.count_gflops(
        deform_im2col, torch.rand(6, 5, 16), torch.rand(6, 5, 8, 9, 2),
        torch.rand(6, 5, 8, 9)) == 0


def test_flop_count_of_the_fused_operator():
    """The fused deformable conv counts its contraction, 2 B Ho Wo K C Co,
    as the columns path counts its torch.matmul."""
    from c2matching_tpu_torch.ops import deform_conv_fused
    x, offset = torch.rand(2, 6, 5, 16), torch.rand(2, 4, 5, 2, 9, 2)
    mask, w_kc = torch.rand(2, 4, 5, 2, 9), torch.rand(9 * 16, 24)
    want = 2 * 2 * 4 * 5 * 9 * 16 * 24 / 1e9
    assert profile_serving.count_gflops(
        deform_conv_fused, x, offset, mask, w_kc, torch.rand(24), (3, 3),
        (1, 1), (0, 1)) == pytest.approx(want)
    assert profile_serving.count_gflops(
        torch.ops.c2matching.deform_conv_fused, x, offset, mask, w_kc, None,
        [3, 3], [1, 1], [0, 1], [1, 1]) == pytest.approx(want)


@pytest.mark.parametrize('argv', [['--stage', '1'], ['--stage', '2'],
                                  ['--stage', '3'],
                                  ['--stage', '3', '--pretrain', '--f32',
                                   '--per-iter-fetch', '--decompose']],
                         ids=['stage1', 'stage2', 'stage3_gan',
                              'stage3_pretrain'])
def test_bench_train_keys(argv, monkeypatch, capsys):
    build = bench_train.build_opt
    monkeypatch.setattr(bench_train, 'build_opt',
                        lambda *a: _small(build(*a)))
    bench_train.main(argv + ['--batch', '2', '--gt-size', '64', '--iters',
                             '2', '--device', 'cpu'])
    out = _one_json_line(capsys)
    assert set(out) == BENCH_KEYS
    assert out['unit'] == 'ms' and out['value'] > 0
    assert f"stage-{argv[1]} batch 2 / 64px" in out['metric']


class _StubModel:
    """Stands in for the stage-3 model: ``bench_train`` times its calls,
    and the test only reads what the script prints."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.log_dict = {}

    def feed_data(self, batch):
        self.batch = batch

    def optimize_parameters(self, step):
        self.log_dict = {'l_g_pix': torch.tensor(float(step))}


@pytest.mark.parametrize('device', ['cpu', 'cuda'])
def test_bench_train_gates_only_on_a_card(device, monkeypatch, capsys):
    """``--decompose`` at the pinned configuration (stage-3 GAN, bf16
    gathers, batch 9 at gt 160) holds the step against the pin only on a
    CUDA device, naming the card beside the pin's; on the CPU it prints
    no gate line. The model is a stub (a CUDA device in name only), so
    the run stays small."""
    monkeypatch.setattr(bench_train, 'create_model',
                        lambda opt, dev: _StubModel(device))
    monkeypatch.setattr(bench_train, '_sync', lambda dev: None)
    monkeypatch.setattr(torch.cuda, 'get_device_name',
                        lambda dev=None: 'a card')
    bench_train.main(['--stage', '3', '--decompose', '--iters', '2',
                      '--device', device])
    out, err = capsys.readouterr()
    assert json.loads(out)['metric'].startswith('ms/GAN-iter, stage-3 '
                                                'batch 9 / 160px')
    gates = [line for line in err.splitlines()
             if line.startswith('decompose gate: ')]
    assert any(line.startswith('decompose: ') for line in err.splitlines())
    if device == 'cpu':
        assert gates == [] and 'WARNING' not in err
    else:
        fields = json.loads(gates[0][len('decompose gate: '):])
        assert len(gates) == 1 and fields['card'] == 'a card'
        assert fields['pinned_card'] == bench_train.PINNED_CARD
        assert fields['pinned_ms'] == bench_train.PINNED_GAN_STEP_MS


def test_profile_train_keys(monkeypatch, capsys):
    build = profile_train.build_opt
    monkeypatch.setattr(profile_train, 'build_opt',
                        lambda: _small(build()))
    profile_train.main(['--batch', '2', '--gt-size', '64', '--iters', '1',
                        '--total', '--device', 'cpu'])
    out = _one_json_line(capsys)
    assert set(out) == TRAIN_KEYS
    assert out['g_step_gflops'] > out['g_forward_gflops'] > 0
    # the byte counter runs through the gradient penalty's autograd.grad
    assert out['d_step_hbm_gb'] > 0
    assert out['g_step_hbm_gb'] > out['g_forward_hbm_gb'] > 0


def test_profile_memory_lines(monkeypatch, capsys):
    """One JSON line a size; on the CPU no allocator counters, so null
    peaks and no module records; cuDNN's flags restored."""
    blocks = _small({k: dict(v) for k, v in
                     profile_memory.F32_BLOCKS.items()})
    monkeypatch.setattr(profile_memory, 'profile', functools.partial(
        profile_memory.profile, blocks=blocks))
    monkeypatch.setenv('CUDNN_CONV_WSCAP_DBG', '512')
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    profile_memory.main(['--hr', '64x48', '32x32', '--cudnn', 'benchmark',
                         '--device', 'cpu'])
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == flags
    lines = [json.loads(line)
             for line in capsys.readouterr().out.splitlines()]
    assert [r['hr'] for r in lines] == ['64x48', '32x32']
    for r in lines:
        assert r['cudnn'] == 'benchmark' and r['peak_gib'] is None
        assert r['modules'] == []
        assert r['env'] == {'CUDNN_CONV_WSCAP_DBG': '512',
                            'TORCH_CUDNN_V8_API_DISABLED': None}


def test_module_peaks_without_counters():
    """CPU parameters: no hooks, no records, no total."""
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.ReLU())
    peaks = prof.ModulePeaks(net)
    net(torch.rand(2, 3))
    assert peaks.total() is None and peaks.top() == []
    assert not net[0]._forward_hooks
    peaks.close()


def test_cuda_default_refuses_without_a_card():
    """The default device is the card: without one the tools raise."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(RuntimeError, match='no CUDA card'):
        profile_serving.profile(batch=1, iters=1)
