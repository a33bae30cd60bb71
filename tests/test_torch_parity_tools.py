"""The port's quality tools against the JAX package's: the MATLAB bicubic
``imresize_np`` (``c2matching_tpu_torch/data/util.py``), back-projection
and the reverse filter (``scripts/back_projection.py``), and the CUFED5
parity harness (``scripts/parity_cufed5.py``).

Tolerances: ``imresize_np`` is the same float64 numpy arithmetic on both
sides, so bit for bit; back-projection chains 3 such resizes per
iteration and is held within 1e-12 on float64 inputs (measured here: 0);
the harness's metrics equal the port's own runner (``test.py``) on the
same set and weights within rel 1e-12 (one mean over the same per-image
float64 numbers, summed in another order).
"""
import json
import os.path as osp
import sys

import numpy as np
import pytest
import torch

from c2matching_tpu.data.util import imresize_np as jax_imresize_np
from c2matching_tpu_torch.data.util import imresize_np
from c2matching_tpu_torch.scripts import back_projection, parity_cufed5

REPO = osp.abspath(osp.join(osp.dirname(__file__), osp.pardir))
sys.path.insert(0, osp.join(REPO, 'scripts'))

import back_projection as jax_bp  # noqa: E402

# the JAX harness's result keys: scripts/parity_cufed5.py, main()
RESULT_KEYS = {'n_images', 'psnr', 'psnr_y', 'ssim_y'}
BASELINE_KEYS = {'baseline_psnr', 'baseline_ssim', 'delta_psnr',
                 'delta_ssim', 'verdict'}


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _image(kind, shape, seed):
    rng = np.random.RandomState(seed)
    if kind == 'float64':
        return rng.rand(*shape)
    return rng.randint(0, 256, shape).astype(np.float64)  # uint8 range


@pytest.mark.parametrize('antialiasing', [True, False])
@pytest.mark.parametrize('scale', [0.25, 4])
@pytest.mark.parametrize('kind', ['float64', 'uint8'])
def test_imresize_np_bit_for_bit(kind, scale, antialiasing):
    for shape in ((37, 29, 3), (20, 16)):
        img = _image(kind, shape, seed=len(shape))
        want = jax_imresize_np(img, scale, antialiasing)
        got = imresize_np(img, scale, antialiasing)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('fn', ['backprojection', 'reverse_filter'])
def test_back_projection_equals_jax(fn):
    rng = np.random.RandomState(3)
    sr = rng.rand(48, 40, 3)
    lr = rng.rand(12, 10, 3)
    want = getattr(jax_bp, fn)(sr, lr, 3, 4)
    got = getattr(back_projection, fn)(sr, lr, 3, 4)
    assert got.shape == want.shape == sr.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_back_projection_cli(tmp_path):
    """``bp`` and ``reverse`` over PNG folders: the port's codec in and
    out, the same pixels as the functions on the decoded images."""
    from c2matching_tpu_torch.utils import imfrombytes, imwrite
    rng = np.random.RandomState(4)
    for sub, hw in (('sr', (32, 24)), ('lr', (8, 6)), ('gt', (32, 24))):
        imwrite(rng.randint(0, 256, hw + (3,)).astype(np.uint8),
                str(tmp_path / sub / 'a.png'))

    def read(path):
        with open(path, 'rb') as f:
            return imfrombytes(f.read()).astype(np.float32) / 255.

    sr = read(tmp_path / 'sr' / 'a.png')
    for mode, other, want in (
            ('bp', 'lr', back_projection.backprojection(
                sr, read(tmp_path / 'lr' / 'a.png'), 2, 4)),
            ('reverse', 'gt', back_projection.reverse_filter(
                sr, imresize_np(read(tmp_path / 'gt' / 'a.png'), 0.25), 2,
                4))):
        out = tmp_path / f'out_{mode}'
        back_projection.main([mode, '--sr', str(tmp_path / 'sr'),
                              f'--{other}', str(tmp_path / other), '--out',
                              str(out), '--iters', '2'])
        with open(out / 'a.png', 'rb') as f:
            got = imfrombytes(f.read())
        np.testing.assert_array_equal(
            got, np.clip(want * 255.0, 0, 255).round().astype(np.uint8))


@pytest.fixture(scope='module')
def synthetic_run(tmp_path_factory):
    """``parity_cufed5 --synthetic --device cpu`` (two 72-px inputs with
    96-px references, full width, random init) with the MSE baseline."""
    out = tmp_path_factory.mktemp('parity')
    args = parity_cufed5.parse_args(['--synthetic', '--device', 'cpu',
                                     '--out', str(out)])
    args.model = 'mse'
    result = parity_cufed5.run(args)
    return out, args, result


def test_parity_json_has_the_jax_keys(synthetic_run):
    out, _, result = synthetic_run
    with open(out / 'parity.json') as f:
        written = json.load(f)
    assert written == result
    assert set(written) == RESULT_KEYS | BASELINE_KEYS
    assert written['n_images'] == 2
    assert written['verdict'] in ('PARITY', 'DELTA EXCEEDS 0.05 dB')
    assert written['delta_psnr'] == pytest.approx(written['psnr'] - 28.24,
                                                  rel=0, abs=1e-12)


def test_synthetic_cli_without_baseline(tmp_path):
    """As the JAX harness: --synthetic compares against no baseline."""
    parity_cufed5.main(['--synthetic', '--synthetic-n', '1', '--device',
                        'cpu', '--out', str(tmp_path)])
    with open(tmp_path / 'parity.json') as f:
        assert set(json.load(f)) == RESULT_KEYS


def test_parity_metrics_equal_the_test_runner(synthetic_run, tmp_path,
                                              monkeypatch):
    """The harness's means equal ``c2matching_tpu_torch.test.run`` on an
    options file over the same set (same seeded init, same protocol)."""
    from c2matching_tpu_torch.test import run
    _, args, result = synthetic_run
    text = open(osp.join(REPO, 'options', 'test',
                         'test_synth_smoke.yml')).read()
    text = (text.replace('./datasets/synth/input', args.data)
            .replace('./datasets/synth/ref', args.data_ref)
            .replace('./datasets/synth/pairs.txt', args.pairs)
            .replace('save_img: true', 'save_img: false'))
    path = tmp_path / 'parity_runner.yml'
    path.write_text(text)
    monkeypatch.setenv('C2MATCHING_ROOT', str(tmp_path))
    avgs = run(str(path), device='cpu')['synth']
    for key in ('psnr', 'psnr_y', 'ssim_y'):
        assert result[key] == pytest.approx(float(avgs[key]), rel=1e-12)


def test_flax_checkpoint_raises_naming_pth(tmp_path):
    args = parity_cufed5.parse_args(['--synthetic', '--device', 'cpu',
                                     '--synthetic-n', '1', '--out',
                                     str(tmp_path)])
    args.weights_g = str(tmp_path / 'net_g.ckpt')
    with pytest.raises(ValueError, match=r'\.pth'):
        parity_cufed5.run(args)
