"""The port's ``batched_patch_match`` hands kernel B1 only the ref
patches that can win, against the JAX package's, which scores every patch
and gives those past the valid region a -1e30 bias.

With a ``valid_shape`` that excludes ref columns or rows, the port matches
against the kept block of the descriptor grid and maps each index back to
the full grid (``full_ref_index``); with none kept it takes the bias, as
the JAX package does. Both run here on the CPU (the port's plain version,
JAX's XLA matmul) on the same seeded numpy features, in f32 and with bf16
operands: the indices must be equal and the values within 1e-5 (the same
f32 formulas; bf16 products are exact in f32, so only the order of the f32
sums differs). Exact ties between a kept patch and a later kept patch past
the excluded columns keep the lowest full index, and a banded run at world
size 2 (``val_spatial_shard``, two gloo processes) gives the whole
image's rows.
"""
from importlib import import_module

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_dist_child as child

jax_pm = import_module('c2matching_tpu.ops.patch_match')
patch_match = import_module('c2matching_tpu_torch.ops.patch_match')
kernel = import_module('c2matching_tpu_torch.ops.patch_match_kernel')

TOL = 1e-5        # |port - JAX| of the values: f32 sums in other orders
DTYPES = (None, 'bfloat16')
# valid feature sizes of 12 x 12 features (10 x 10 descriptors): ref
# columns excluded, rows, both, none (the whole grid, and past it), one
# descriptor kept, none kept
VALID = {'columns': (12, 9), 'rows': (9, 12), 'both': (9, 10),
         'nothing': (12, 12), 'past': (20, 20), 'one': (3, 3),
         'none_kept': (2, 5), 'no_valid_shape': None}


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    """The suite runs several workers on one host."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _feats(seed, shape=(2, 12, 12, 8)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _jax(fi, fr, dtype, valid):
    idx, val = jax_pm.batched_patch_match(jnp.asarray(fi), jnp.asarray(fr),
                                          compute_dtype=dtype,
                                          valid_shape=valid)
    return np.asarray(idx), np.asarray(val)


def _port(fi, fr, dtype, valid):
    idx, val = patch_match.batched_patch_match(
        torch.from_numpy(fi), torch.from_numpy(fr), compute_dtype=dtype,
        valid_shape=valid)
    return idx.numpy(), val.numpy()


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', VALID)
def test_compacted_match_equals_jax(case, dtype):
    valid = VALID[case]
    fi, fr = _feats(11)
    want_i, want_v = _jax(fi, fr, dtype, valid)
    got_i, got_v = _port(fi, fr, dtype, valid)
    np.testing.assert_array_equal(got_i, want_i)
    # none kept: every value is -1e30 plus a score, over the query's norm,
    # and rounds at 1e30's scale
    np.testing.assert_allclose(got_v, want_v, atol=TOL,
                               rtol=1e-6 if case == 'none_kept' else 0)
    if valid is not None and case != 'none_kept':
        vh, vw = valid[0] - 2, valid[1] - 2
        assert np.all(got_i // 10 < vh) and np.all(got_i % 10 < vw)


@pytest.mark.parametrize('case', VALID)
def test_b1_gets_the_kept_rows_alone(case, monkeypatch):
    """What B1 receives: the kept block and no bias where some patch is
    kept and some excluded, every row and no bias where none is excluded,
    every row and the -1e30 bias where none is kept."""
    seen = []
    real = patch_match.match_argmax

    def record(q, r, ref_bias=None):
        seen.append((r.shape[1], ref_bias))
        return real(q, r, ref_bias)

    monkeypatch.setattr(patch_match, 'match_argmax', record)
    fi, fr = _feats(12)
    _port(fi, fr, None, VALID[case])
    (rows, bias), = seen
    valid = VALID[case]
    if case == 'none_kept':
        assert rows == 100 and bool((bias == -1e30).all())
        return
    kept = (100 if valid is None else
            min(10, valid[0] - 2) * min(10, valid[1] - 2))
    assert rows == kept and bias is None


def test_full_ref_index_is_increasing():
    """The map from the kept block's flat index to the grid's: row-major,
    strictly increasing, so a first maximum stays first."""
    idx = torch.arange(6 * 4)
    full = patch_match.full_ref_index(idx, 7, 4)
    assert torch.equal(full, (idx // 4) * 7 + idx % 4)
    assert bool((full[1:] > full[:-1]).all())
    r = torch.arange(2 * 5 * 7 * 3, dtype=torch.float32).reshape(2, 35, 3)
    kept = patch_match.kept_ref_rows(r, 5, 7, 3, 4)
    assert kept.is_contiguous() and kept.shape == (2, 12, 3)
    assert torch.equal(kept, r[:, patch_match.full_ref_index(
        torch.arange(12), 7, 4)])


def _tie_feats(h=10, w=10, c=8):
    """One-hot pixels whose channel is the column mod c, the same in every
    row: every ref patch of a column is the same patch, its scores exact
    sums of one value."""
    x = np.zeros((1, h, w, c), np.float32)
    for col in range(w):
        x[0, :, col, col % c] = 1.0
    return x, x.copy()


@pytest.mark.parametrize('dtype', DTYPES)
def test_exact_ties_across_excluded_columns_keep_the_lowest_index(dtype):
    """Patch (0, x) ties with (1, x), (2, x) ... beyond the excluded
    columns of each row: the lowest full index, x, wins, as in JAX; queries
    whose own column is excluded tie between kept columns, and JAX's pick
    (the lowest) is the port's."""
    fi, fr = _tie_feats()
    valid = (8, 7)            # 8 x 8 descriptors, 6 x 5 kept
    want_i, want_v = _jax(fi, fr, dtype, valid)
    got_i, got_v = _port(fi, fr, dtype, valid)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=TOL)
    cols = np.broadcast_to(np.arange(8), (8, 8))
    assert np.array_equal(got_i[0][:, :5], cols[:, :5])
    assert np.all(got_i[0][:, 6:] == 0)   # (6,7,0), (7,0,1): column 0


def test_plain_kernel_version_on_kept_rows_is_first_maximum():
    """``match_argmax`` on the kept rows against the whole grid with the
    bias: the mapped indices and the values agree, ties included."""
    fi, fr = _tie_feats()
    q = torch.from_numpy(fi).reshape(1, 100, 8).repeat(1, 1, 9)
    r = torch.from_numpy(fr).reshape(1, 100, 8).repeat(1, 1, 9)
    col = torch.arange(100) % 10
    row = torch.arange(100) // 10
    bias = torch.where((row < 6) & (col < 5), 0.0, -1e30)
    want_i, want_v = kernel.match_argmax(q, r, bias)
    kept = patch_match.kept_ref_rows(r, 10, 10, 6, 5)
    got_i, got_v = kernel.match_argmax(q, kept)
    assert torch.equal(patch_match.full_ref_index(got_i, 10, 5), want_i)
    assert torch.equal(got_v, want_v)


def test_banded_compacted_match_equals_jax(tmp_path):
    """Two ranks, each its band of the query rows against the whole
    reference with excluded rows and columns, f32 and bf16: the bands'
    rows together are JAX's whole match."""
    fi, fr = _feats(13)
    valid = (9, 10)
    jobs = []
    for dtype in DTYPES:
        path = tmp_path / f'in_{dtype}.pt'
        torch.save({'feat_in': torch.from_numpy(fi),
                    'feat_ref': torch.from_numpy(fr),
                    'valid_shape': valid, 'compute_dtype': dtype}, path)
        jobs.append((['match_band', str(path), str(tmp_path / f'{dtype}')],
                     2))
    results = child.spawn(jobs, timeout=100)
    for out in results:
        for rc, text in out:
            assert rc == 0, text[-4000:]
    for dtype in DTYPES:
        want_i, want_v = _jax(fi, fr, dtype, valid)
        ranks = [torch.load(tmp_path / f'{dtype}.rank{r}', weights_only=False)
                 for r in range(2)]
        assert [r['band'] for r in ranks] == [(0, 6), (6, 6)]
        got_i = torch.cat([r['idx'] for r in ranks], dim=1).numpy()
        got_v = torch.cat([r['val'] for r in ranks], dim=1).numpy()
        assert ranks[1]['idx'].shape[1] == 4   # query rows 6-9 of 10
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_v, want_v, rtol=0, atol=TOL)
