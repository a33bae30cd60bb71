"""The port's windowed deformable conv (c2matching_tpu_torch.ops.dcn_window
and its kernel module) against the JAX package's.

Inputs are made with numpy from a seed and fed to both sides; weights come
from the same arrays. On the CPU ``window_contract`` takes its plain
version; the CUDA kernel is held against that plain version on the card
by chip_smoke.py (phases b2 and path).
"""
from importlib import import_module

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from c2matching_tpu.ops.pallas.dcn_window_kernel import window_contract_pallas
from c2matching_tpu_torch.models import RefRestorationModel
from c2matching_tpu_torch.ops import (modulated_deform_conv,
                                      modulated_deform_conv_windowed,
                                      modulated_deform_conv_windowed_chunked,
                                      window_applicable, window_contract,
                                      window_contract_plain)

jax_win = import_module('c2matching_tpu.ops.dcn_window')
jax_dcn = import_module('c2matching_tpu.ops.deform_conv')
win_mod = import_module('c2matching_tpu_torch.ops.dcn_window')

# the JAX package's own bound for the windowed op against the exact op
# (tests/test_dcn_window.py): tents and corner weights round apart
OP_TOL = 1e-4
# f32 sums of the same exact products in another order (outputs of O(1))
CONTRACT_TOL = 1e-5
# prep: the same f32 additions on both sides
PREP_TOL = 1e-6


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _c2_case(seed, b=1, h=16, w=12, c=8, g=4, blk=4, res=0.4, flow=20):
    """Offsets with the DynAgg structure: per-tap integer flow constant
    over blk-aligned blocks, plus a small learned residual (the cases of
    tests/test_dcn_window.py, made here)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    coarse = rng.randint(-flow, flow, size=(b, h // blk, w // blk, 1, 9, 2))
    pre = np.repeat(np.repeat(coarse, blk, axis=1), blk, axis=2)
    resid = (rng.rand(b, h, w, g, 9, 2) * 2 - 1) * res
    offset = (pre + resid).astype(np.float32)
    mask = rng.rand(b, h, w, g, 9).astype(np.float32)
    weight = rng.randn(9, c, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    return x, offset, mask, weight, bias


def _case(name):
    """(x, offset, mask, weight, bias, blk, win, windowed branch)."""
    if name == 'structured':
        return (*_c2_case(0), 4, 8, True)
    if name == 'block2':
        return (*_c2_case(1, h=12, w=10, c=8, g=2, blk=2, res=0.3), 2, 6,
                True)
    if name == 'fallback':   # residuals far beyond the window
        x, off, mask, wgt, bias = _c2_case(2)
        off = off + (np.random.RandomState(2).randn(*off.shape) * 5
                     ).astype(np.float32)
        return x, off, mask, wgt, bias, 4, 8, False
    if name == 'border':     # flows pushing many taps off the 16x12 image
        return (*_c2_case(3, flow=30), 4, 8, True)
    if name == 'batched':
        a = _c2_case(4, b=1)
        b = _c2_case(5, b=1)
        return (*(np.concatenate([u, v]) for u, v in zip(a[:3], b[:3])),
                a[3], a[4], 4, 8, True)
    if name == 'huge':       # every origin clamps; no tap is valid
        x, off, mask, wgt, bias = _c2_case(6)
        sign = np.where(np.random.RandomState(6).rand(*off.shape) > 0.5, 1,
                        -1)
        return x, (sign * 3e4).astype(np.float32), mask, wgt, bias, 4, 8, True
    raise KeyError(name)


# ----------------------------------------------------------------- prep
@pytest.mark.parametrize('name', ['structured', 'block2', 'fallback',
                                  'border', 'huge'])
def test_window_prep_matches_jax(name):
    x, off, mask, _, _, blk, win, branch = _case(name)
    want = jax_win._window_prep(jnp.asarray(x[0]), jnp.asarray(off[0]),
                                jnp.asarray(mask[0]), blk, win)
    got = win_mod._window_prep(_t(x[0]), _t(off[0]), _t(mask[0]), blk, win)
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, j in zip(got[1:4], want[1:4]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=PREP_TOL)
    assert bool(got[4]) == bool(want[4]) == branch


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_window_gather_matches_jax_exactly(dtype):
    x, off, mask, _, _, blk, win, _ = _case('border')
    origins = np.array(jax_win._window_prep(
        jnp.asarray(x[0]), jnp.asarray(off[0]), jnp.asarray(mask[0]), blk,
        win)[0])
    xj = jnp.asarray(x[0]).astype(dtype)
    want = np.asarray(jax_win._window_gather(xj, jnp.asarray(origins), win)
                      .astype(jnp.float32))
    got = win_mod._window_gather(_t(x[0]).to(getattr(torch, dtype)),
                                 _t(origins), win)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


# ------------------------------------------------------------- contraction
def _contract_case(seed, blk, win, nby, nbx, c=8, g=4, co=6):
    """Random windows and fields, coordinates reaching past the window on
    both sides, some zero modulation."""
    rng = np.random.RandomState(seed)
    nb, p = nby * nbx, nby * nbx * blk * blk
    rows = rng.randn(nb, 9, win, win * c).astype(np.float32)
    ry = rng.uniform(-2.5, win + 1.5, (g, 9, p)).astype(np.float32)
    rx = rng.uniform(-2.5, win + 1.5, (g, 9, p)).astype(np.float32)
    mm = (rng.rand(g, 9, p) * (rng.rand(g, 9, p) > 0.2)).astype(np.float32)
    weight = (rng.randn(9, c, co) / np.sqrt(9 * c)).astype(np.float32)
    return rows, ry, rx, mm, weight


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('blk, win, nby, nbx', [(4, 8, 2, 3), (2, 6, 4, 2),
                                                (2, 6, 3, 5)],
                         ids=['blk4', 'blk2', 'ragged_nb15'])
def test_window_contract_plain_matches_jax(dtype, blk, win, nby, nbx):
    """Against the JAX package's dense einsums and its Pallas kernel (in
    interpret mode, as tests/test_dcn_window.py runs it); NB = 15 is not a
    multiple of the Pallas tile of 8 blocks."""
    rows, ry, rx, mm, weight = _contract_case(blk + nby, blk, win, nby, nbx)
    rows_j = jnp.asarray(rows).astype(dtype)
    fj = [jnp.asarray(a) for a in (ry, rx, mm)]
    ty, txm = jax_win._tents(*fj, blk, win, nby, nbx)
    want_xla = np.asarray(jax_win._window_contract_xla(
        rows_j, ty, txm, jnp.asarray(weight), blk, win, nby, nbx))
    want_pallas = np.asarray(window_contract_pallas(
        rows_j, *fj, jnp.asarray(weight), blk, win, nby, nbx))
    rows_t = _t(rows).to(getattr(torch, dtype))
    got = window_contract_plain(rows_t, _t(ry), _t(rx), _t(mm), _t(weight),
                                blk, win, nby, nbx)
    assert got.shape == (nby * blk, nbx * blk, 6)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=0,
                               atol=CONTRACT_TOL)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=0,
                               atol=CONTRACT_TOL)
    # the wrapper takes the plain version on a CPU tensor
    np.testing.assert_array_equal(
        window_contract(rows_t, _t(ry), _t(rx), _t(mm), _t(weight), blk, win,
                        nby, nbx).numpy(), got.numpy())


def test_window_contract_cpu_takes_the_plain_version():
    """No launch is counted for a CPU tensor, and a device that is neither
    CPU nor CUDA is refused rather than computed some other way."""
    rows, ry, rx, mm, weight = _contract_case(0, 2, 6, 2, 2)
    n = window_contract.launches
    window_contract(*map(_t, (rows, ry, rx, mm, weight)), 2, 6, 2, 2)
    assert window_contract.launches == n
    with pytest.raises(ValueError):
        window_contract(*(torch.empty(a.shape, device='meta')
                          for a in (rows, ry, rx, mm, weight)), 2, 6, 2, 2)


# -------------------------------------------------------------- the op
def _branches(x, off, mask, blk, win, side):
    prep = jax_win._window_prep if side == 'jax' else win_mod._window_prep
    conv = jnp.asarray if side == 'jax' else _t
    return [bool(prep(conv(x[i]), conv(off[i]), conv(mask[i]), blk, win)[4])
            for i in range(x.shape[0])]


@pytest.mark.parametrize('name', ['structured', 'block2', 'fallback',
                                  'border', 'batched'])
def test_windowed_matches_jax(name):
    """The same branch per image as JAX, the output within the JAX tests'
    bound of JAX's windowed op and of the port's exact op."""
    x, off, mask, wgt, bias, blk, win, branch = _case(name)
    want = np.asarray(jax_win.modulated_deform_conv_windowed(
        *map(jnp.asarray, (x, off, mask, wgt, bias)), blk=blk, win=win,
        use_pallas=False))
    got = modulated_deform_conv_windowed(
        *map(_t, (x, off, mask, wgt, bias)), blk=blk, win=win)
    assert (_branches(x, off, mask, blk, win, 'port')
            == _branches(x, off, mask, blk, win, 'jax')
            == [branch] * x.shape[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=OP_TOL, atol=OP_TOL)
    exact = modulated_deform_conv(*map(_t, (x, off, mask, wgt, bias)))
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=OP_TOL,
                               atol=OP_TOL)
    if not branch:
        assert torch.equal(got, exact)


def test_windowed_bf16_close():
    """bf16 x: within 3% of scale of the f32 op (JAX's bound), and within
    the op bound of JAX's bf16 windowed op, which converts the same bf16
    windows to f32 and keeps the weight f32 too."""
    x, off, mask, wgt, bias = _c2_case(5)
    want_f32 = np.asarray(jax_win.modulated_deform_conv_windowed(
        *map(jnp.asarray, (x, off, mask, wgt, bias)), blk=4, win=8,
        use_pallas=False))
    want_bf16 = np.asarray(jax_win.modulated_deform_conv_windowed(
        jnp.asarray(x).astype(jnp.bfloat16),
        *map(jnp.asarray, (off, mask, wgt, bias)), blk=4, win=8,
        use_pallas=False))
    got = modulated_deform_conv_windowed(
        _t(x).to(torch.bfloat16), *map(_t, (off, mask, wgt, bias)), blk=4,
        win=8).numpy()
    scale = np.abs(want_f32).max()
    assert np.abs(got - want_f32).max() < 0.03 * scale
    np.testing.assert_allclose(got, want_bf16, rtol=OP_TOL, atol=OP_TOL)


@pytest.mark.parametrize('row_chunks, use_pallas', [(4, False), (2, True)])
def test_windowed_chunked_matches_jax(row_chunks, use_pallas):
    x, off, mask, wgt, bias = _c2_case(3, h=32, w=12, c=8, g=4, blk=4)
    want = np.asarray(jax_win.modulated_deform_conv_windowed_chunked(
        *map(jnp.asarray, (x, off, mask, wgt, bias)), blk=4, win=8,
        use_pallas=use_pallas, row_chunks=row_chunks))
    got = modulated_deform_conv_windowed_chunked(
        *map(_t, (x, off, mask, wgt, bias)), blk=4, win=8,
        row_chunks=row_chunks)
    np.testing.assert_allclose(got.numpy(), want, rtol=OP_TOL, atol=OP_TOL)
    exact = modulated_deform_conv(*map(_t, (x, off, mask, wgt, bias)))
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=OP_TOL,
                               atol=OP_TOL)


def test_windowed_chunked_refuses_partial_blocks():
    x, off, mask, wgt, _ = _c2_case(3, h=32, w=12, c=8, g=4, blk=4)
    with pytest.raises(ValueError):
        modulated_deform_conv_windowed_chunked(
            *map(_t, (x, off, mask, wgt)), blk=4, win=8, row_chunks=16)


@pytest.mark.parametrize('args, kwargs', [
    (((1, 16, 12, 8), (1, 16, 12, 4, 9, 2), 4, 8), {}),
    (((1, 15, 12, 8), (1, 15, 12, 4, 9, 2), 4, 8), {}),
    (((1, 16, 12, 8), (1, 8, 6, 4, 9, 2), 4, 8), {'stride': (2, 2)}),
    (((1, 4, 4, 8), (1, 4, 4, 4, 9, 2), 2, 9), {}),
    (((1, 16, 12, 8), (1, 16, 12, 4, 9, 2), 4, 8), {'dilation': (2, 2)}),
], ids=['applies', 'rows_off_block', 'strided', 'image_below_window',
        'dilated'])
def test_window_applicable_matches_jax(args, kwargs):
    want = jax_win.window_applicable(*args, **kwargs)
    assert window_applicable(*args, **kwargs) == want
    assert want == (args[0][1] == 16 and not kwargs)


def test_windowed_takes_the_exact_op_where_not_applicable():
    x, off, mask, wgt, bias = _c2_case(7, h=16, w=12)
    x, off, mask = x[:, :15], off[:, :15], mask[:, :15]
    got = modulated_deform_conv_windowed(*map(_t, (x, off, mask, wgt, bias)),
                                         blk=4, win=8)
    exact = modulated_deform_conv(*map(_t, (x, off, mask, wgt, bias)))
    assert torch.equal(got, exact)


# ------------------------------------------------------------ the model
def test_model_defaults_to_the_card():
    """With no device the model runs on the CUDA card, and on a host
    without one the constructor says so instead of carrying on."""
    blocks = {'network_g': {'type': 'RestorationNet', 'ngf': 8,
                            'n_blocks': 1, 'groups': 8},
              'network_map': {'type': 'CorrespondenceGenerationArch'},
              'network_extractor': {'type': 'ContrasExtractorSep'}}
    if torch.cuda.is_available():
        assert RefRestorationModel(blocks).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA card'):
            RefRestorationModel(blocks)
